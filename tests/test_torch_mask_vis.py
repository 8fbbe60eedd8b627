"""The port's mask / alignment dumps (``evaluation/mask_vis.py``) and
``hem_eval --mask-vis`` against the JAX package's, on the CPU.

* the jet lookup against matplotlib's ``cm.jet`` (within 1e-7, over its
  256 entries and at values that land on every entry and both ends);
* ``mask_vis`` and ``mask_vis_categories``: the files each package writes
  (names, and the per-category cap carried across calls) are the same,
  and the panels handed to the image writers agree within 1e-5 (the warps
  are each package's own: ``geometry/`` against JAX's ``warp_by_flow``);
* ``hem_eval --mask-vis`` (the tiny estimator config of
  ``test_torch_hem_train_cli.py``) on a tiny CAHomo layout of PNG pairs (written by
  ``data/hem_data.py::write_synthetic_cahomo``, read without OpenCV): the
  JAX file names, JPEGs that PIL opens, GIFs of two frames, loop 0, 50 cs;
  the report equals a run without the flag.
"""

import json
import os

import numpy as np
import pytest
import torch
from matplotlib import cm
from PIL import Image

import dmhomo_tpu.utils.viz as jviz
from dmhomo_tpu.evaluation import mask_vis as jmv

from dmhomo_torch.evaluation import mask_vis as tmv

ATOL = 1e-5


def test_jet_lut_against_matplotlib():
    np.testing.assert_allclose(tmv.JET_LUT, cm.jet(np.arange(256))[:, :3], rtol=0, atol=1e-7)
    v = np.concatenate([np.linspace(0, 1, 2049), [0.0, 1.0, 0.5, 1 / 256, 255 / 256]])
    v = v.astype(np.float32).reshape(-1, 2)
    np.testing.assert_allclose(tmv.jet(v), cm.jet(v)[..., :3], rtol=0, atol=1e-7)


def _capture(monkeypatch, module):
    """Replace a module's image writers by recorders: path -> arrays."""
    seen = {}
    monkeypatch.setattr(module, "save_png", lambda p, a: seen.__setitem__(p, [np.asarray(a)]))
    monkeypatch.setattr(module, "save_flip_gif",
                        lambda p, fs, *a: seen.__setitem__(p, [np.asarray(f) for f in fs]))
    return seen


def _compare(jax_seen, port_seen, jax_root, port_root):
    rel = lambda d, root: {os.path.relpath(p, root): v for p, v in d.items()}
    j, p = rel(jax_seen, jax_root), rel(port_seen, port_root)
    assert sorted(j) == sorted(p) and j
    for name in j:
        assert len(j[name]) == len(p[name])
        for a, b in zip(j[name], p[name]):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=name)


def _batch(rng, videos, h=24, w=40):
    B = len(videos)
    rgb = rng.uniform(0, 1, (B, h, w, 6)).astype(np.float32)
    batch = {"imgs_rgb_full": rgb, "video_names": list(videos),
             "imgs_gray_full": rng.normal(0, 1, (B, h, w, 2)).astype(np.float32)}
    outputs = {"flow_b": rng.normal(0, 3, (B, h, w, 2)).astype(np.float32),
               "flow_f": rng.normal(0, 3, (B, h, w, 2)).astype(np.float32),
               "mask_f": rng.uniform(0, 1, (B, h, w, 1)).astype(np.float32),
               "mask_b": rng.uniform(0, 1, (B, h, w, 1)).astype(np.float32),
               "mask_fusion": rng.uniform(0, 1, (B, h, w, 1)).astype(np.float32)}
    return batch, outputs


def test_mask_vis_categories_against_jax(monkeypatch, tmp_path, rng):
    jseen, pseen = _capture(monkeypatch, jviz), _capture(monkeypatch, tmv)
    jcounts, pcounts = {}, {}
    videos = ["0000011", "0000038", "nope", "0000011", "0000085", "0000011"]
    for call in range(2):  # the cap of 3 a category carried across the calls
        batch, outputs = _batch(rng, videos)
        jpaths = jmv.mask_vis_categories(batch, outputs, str(tmp_path / "j"), counts=jcounts,
                                         per_category_cap=3)
        ppaths = tmv.mask_vis_categories(batch, outputs, str(tmp_path / "p"), counts=pcounts,
                                         per_category_cap=3, device="cpu")
        assert [os.path.relpath(p, tmp_path / "p") for p in ppaths] == [
            os.path.relpath(p, tmp_path / "j") for p in jpaths]
    assert pcounts == jcounts == {"RE": 6, "LT": 2, "LL": 2}
    _compare(jseen, pseen, str(tmp_path / "j"), str(tmp_path / "p"))
    assert any(p.endswith("RE/0000011_0_img1.jpg") for p in pseen)


def test_mask_vis_against_jax(monkeypatch, tmp_path, rng):
    jseen, pseen = _capture(monkeypatch, jviz), _capture(monkeypatch, tmv)
    batch, outputs = _batch(rng, ["a", "b", "c"])
    jpaths = jmv.mask_vis(batch, outputs, str(tmp_path / "j"), max_items=2)
    ppaths = tmv.mask_vis(batch, outputs, str(tmp_path / "p"), max_items=2, device="cpu")
    assert [os.path.basename(p) for p in ppaths] == [os.path.basename(p) for p in jpaths]
    _compare(jseen, pseen, str(tmp_path / "j"), str(tmp_path / "p"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread is faster than many, and the suite
    runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    from dmhomo_torch.config import EstimatorConfig, Params
    from dmhomo_torch.data.hem_data import write_synthetic_cahomo
    from dmhomo_torch.models.estimator import build_estimator

    from test_torch_hem_train_cli import TINY_PARAMS

    root = tmp_path_factory.mktemp("eval")
    ori = (72, 144)
    lines = write_synthetic_cahomo(str(root / "cahomo"), 7, ori, seed=1)
    (root / "model").mkdir()
    with open(root / "model" / "params.json", "w") as f:
        json.dump({**TINY_PARAMS, "ori_size": list(ori)}, f)
    cfg = EstimatorConfig.from_params(Params(str(root / "model" / "params.json")))
    model = build_estimator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    torch.save({"state_dict": model.state_dict()}, root / "HEM.pth")
    return root, lines


def test_hem_eval_mask_vis(eval_setup, tmp_path):
    from dmhomo_torch.cli.hem_eval import main

    root, lines = eval_setup
    args = ["--test-data", str(root / "cahomo"), "--model-dir", str(root / "model"),
            "--torch-ckpt", str(root / "HEM.pth"), "--batch-size", "3", "--device", "cpu"]
    plain = main(args)
    vis = tmp_path / "vis"
    report = main(args + ["--mask-vis", str(vis)])
    assert json.dumps(report) == json.dumps(plain)
    # the names JAX writes: <category>/<video>_<index in the batch>{_img1.jpg, ...}
    want = set()
    for i, line in enumerate(lines):
        vid = line.split("/")[0]
        cat = next(c for c, ids in tmv.TEST_CATEGORIES.items() if vid in ids)
        stem = f"{cat}/{vid}_{i % 3}"
        want |= {f"{stem}{s}" for s in ("_img1.jpg", "_img2.jpg", "_mask_1.jpg", "_mask_2.jpg",
                                        ".gif")}
    got = {os.path.relpath(os.path.join(d, f), vis) for d, _, fs in os.walk(vis) for f in fs}
    assert got == want
    for name in got:
        im = Image.open(vis / name)
        if name.endswith(".jpg"):
            raw = open(vis / name, "rb").read()
            assert im.format == "JPEG" and raw[:2] == b"\xff\xd8" and raw[-2:] == b"\xff\xd9"
            assert im.size == (144, 72)
        else:
            assert im.format == "GIF" and im.n_frames == 2 and im.info["loop"] == 0
            assert im.info["duration"] == 500 and im.size == (4 * 144, 72)


def test_dataset_items_match_jax(eval_setup):
    """The port's dataset on PNG pairs (no OpenCV) against the JAX dataset
    (OpenCV): every item, the gray patch within 1e-5 (each package's resize)."""
    from dmhomo_tpu.data.hem_data import CAHomoTestDataset as JaxDataset

    from dmhomo_torch.data.hem_data import CAHomoTestDataset

    root, _ = eval_setup
    port, jax_ds = (ds(str(root / "cahomo"), crop_size=(32, 64))
                    for ds in (CAHomoTestDataset, JaxDataset))
    for i in (0, 4):
        a, b = port[i], jax_ds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "video_names":
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
