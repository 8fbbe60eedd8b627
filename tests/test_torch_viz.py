"""``utils/viz.py`` and ``DGMTrainer.save_preview`` against the JAX
package's ``utils/viz.py`` and ``DGMTrainer.save_preview``, on the CPU.

* ``sample_panel``: within 1e-5 of JAX's on the same arrays (the warp and
  the flow colours are each package's own);
* ``image_grid``: equal, element for element, over grid shapes with a
  ragged last row;
* ``save_png``: the file, written with the standard library, decodes with
  PIL to the pixels of JAX's ``save_png`` (PIL) of the same image; its
  chunks parse (signature, IHDR size, IDAT inflating to H * (1 + 3W)
  bytes, CRCs);
* ``save_preview``: with the sampler's output fixed, its photometric error
  is the JAX formula's on the same images (1e-6 relative) and its PNG is
  the panel grid of those images.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from dmhomo_tpu.geometry import warp_by_flow as jax_warp_by_flow
from dmhomo_tpu.utils.viz import image_grid as jax_image_grid
from dmhomo_tpu.utils.viz import sample_panel as jax_sample_panel
from dmhomo_tpu.utils.viz import save_png as jax_save_png

from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from dmhomo_torch.utils.viz import image_grid, png_bytes, sample_panel, save_png
from test_torch_dgm_previews import parse_png
from torch_dp_ranks import dgm_config

S = 16


def _inputs(n=3, seed=0):
    cond, _ = next(synthetic_condition_batches(8, S, n, 2, seed=seed))
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, S, S, 6)).astype(np.float32)
    flow = cond[..., 10:12] + rng.normal(0, 2, (n, S, S, 2)).astype(np.float32)
    mask = (rng.uniform(size=(n, S, S, 1)) < 0.8).astype(np.float32)
    return imgs, mask, flow


@pytest.mark.parametrize("n", [1, 3])
def test_sample_panel_matches_jax(n):
    imgs, mask, flow = _inputs(n)
    got = sample_panel(imgs, mask, flow)
    want = np.asarray(jax_sample_panel(imgs, mask, flow))
    assert got.shape == want.shape == (n, 2 * S, 4 * S, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # tensors in, the same panel
    t = sample_panel(*(torch.from_numpy(a) for a in (imgs, mask, flow)))
    np.testing.assert_array_equal(t, got)


@pytest.mark.parametrize("n,nrow,pad", [(1, None, 2), (5, None, 2), (7, 3, 1), (16, None, 0)])
def test_image_grid_equals_jax(n, nrow, pad):
    imgs = np.random.default_rng(n).uniform(size=(n, 5, 4, 3)).astype(np.float32)
    got = image_grid(imgs, nrow=nrow, pad=pad)
    want = jax_image_grid(imgs, nrow=nrow, pad=pad)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(1, 1), (7, 5), (34, 66)])
def test_save_png_decodes_to_jax_pixels(tmp_path, hw):
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (*hw, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "a" / "ours.png"), str(tmp_path / "theirs.png")
    save_png(ours, img)
    jax_save_png(theirs, img)
    got, want = np.asarray(Image.open(ours)), np.asarray(Image.open(theirs))
    assert got.dtype == np.uint8 and Image.open(ours).mode == "RGB"
    np.testing.assert_array_equal(got, want)
    p = parse_png(open(ours, "rb").read())
    assert (p["w"], p["h"], p["depth"], p["colour"]) == (hw[1], hw[0], 8, 2) and p["end"]
    assert len(p["idat"]) == hw[0] * (1 + 3 * hw[1])


def test_png_bytes_takes_rgb_only():
    with pytest.raises(ValueError, match="RGB"):
        png_bytes(np.zeros((4, 4)))


def test_save_preview_error_and_panel(tmp_path, monkeypatch):
    imgs, mask, flow = _inputs(4, seed=2)
    cond, classes = next(synthetic_condition_batches(8, S, 4, 2, seed=5))
    cond = cond.copy()
    cond[..., 6:7], cond[..., 10:12] = mask, flow
    tr = DGMTrainer(dgm_config(4, 2, 5e-4, 10), device="cpu")
    tr.init_state()
    monkeypatch.setattr(tr, "sample", lambda *a, **kw: torch.from_numpy(imgs))
    path, err = tr.save_preview(cond, classes, str(tmp_path / "previews" / "sample-5.png"))
    import jax.numpy as jnp

    warped = np.asarray(jax_warp_by_flow(jnp.asarray(imgs[..., 3:]), jnp.asarray(flow),
                                         mode="border"))
    want = float((mask * np.abs(warped - imgs[..., :3])).sum() / (mask.sum() * 3 + 1e-8))
    assert err == pytest.approx(want, rel=1e-6)
    grid = image_grid(sample_panel(imgs, mask, flow))
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  (np.clip(grid, 0, 1) * 255).astype(np.uint8))


def test_save_preview_samples_the_ema(tmp_path):
    """The real sampler: the EMA's weights, a finite error, a PNG."""
    cond, classes = next(synthetic_condition_batches(8, S, 2, 2, seed=5))
    tr = DGMTrainer(dgm_config(4, 2, 5e-4, 10), device="cpu")
    tr.init_state()
    path, err = tr.save_preview(cond, classes, str(tmp_path / "p.png"))
    assert np.isfinite(err) and err >= 0
    p = parse_png(open(path, "rb").read())
    assert (p["w"], p["h"]) == (2 * (4 * S + 2) - 2, 2 * S)
