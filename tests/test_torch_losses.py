"""The port's HEM losses against the JAX package's (fp32, 1e-6 relative:
the same elementwise math, summed in another order)."""

import numpy as np
import pytest
import torch

from dmhomo_tpu.losses import hem_losses as jl

from dmhomo_torch.losses import hem_losses as tl

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


@pytest.mark.parametrize("with_mask", [False, True])
def test_nll_laplace_skips_non_finite_entries(with_mask):
    rng = np.random.default_rng(0)
    gt = rng.normal(0, 2, (2, 6, 7, 2)).astype(np.float32)
    est = rng.normal(0, 2, (2, 6, 7, 2)).astype(np.float32)
    log_var = rng.normal(0, 1, (2, 6, 7, 1)).astype(np.float32)
    gt[0, 0, 0, 0] = np.inf
    est[1, 2, 3, 1] = np.nan
    log_var[0, 4, 4, 0] = -np.inf
    mask = rng.uniform(size=(2, 6, 7, 2)) < 0.7 if with_mask else None
    got = tl.nll_laplace(_t(gt), _t(est), _t(log_var), None if mask is None else _t(mask))
    want = jl.nll_laplace(_j(gt), _j(est), _j(log_var), None if mask is None else _j(mask))
    assert np.isfinite(float(got))
    assert float(got) == pytest.approx(float(want), rel=RTOL)


def test_nll_laplace_count_is_at_least_one():
    nan = torch.full((1, 2, 2, 2), float("nan"))
    assert float(tl.nll_laplace(nan, nan, torch.zeros(1, 2, 2, 1))) == 0.0


@pytest.mark.parametrize("weight", [(1.0, 1.0), (0.2, 0.9)])
def test_mask_bce_loss(weight):
    mask = np.random.default_rng(1).uniform(0, 1, (2, 8, 5, 1)).astype(np.float32)
    mask[0, 0, 0, 0] = 0.0
    mask[1, 1, 1, 0] = 1.0
    got = tl.mask_bce_loss(_t(mask), weight)
    want = jl.mask_bce_loss(_j(mask), weight)
    assert float(got) == pytest.approx(float(want), rel=RTOL)


def _outputs(rng, B=2, H=8, W=12):
    def n(*shape, s=1.0):
        return rng.normal(0, s, (B, H, W) + shape).astype(np.float32)

    def u(*shape):
        return rng.uniform(0.01, 0.99, (B, H, W) + shape).astype(np.float32)

    return {
        "flow_f": n(2, s=3), "flow_b": n(2, s=3), "mask_f": u(1), "mask_b": u(1),
        "mask_fusion": u(1),
        "fil_features": {k: n(1) for k in ("img1_patch_fea", "img2_patch_fea",
                                            "img1_patch_fea_warp", "img2_patch_fea_warp")},
    }, {"flow_gt_patch": n(4, s=3)}


@pytest.mark.parametrize("weights", [
    dict(nll=1.0),                                               # stage 1
    dict(sup=1.0, nll=1.0),                                      # stage 2
    dict(sup=1.0, nll=1.0, normalize_mask=True),
    dict(sup=0.5, unsup=0.3, mask_reg=0.2, nll=0.7),
])
def test_compute_losses(weights):
    import jax

    outputs, batch = _outputs(np.random.default_rng(2))
    got = tl.compute_losses(jax.tree.map(_t, batch), jax.tree.map(_t, outputs),
                            tl.LossWeights(**weights))
    want = jl.compute_losses(jax.tree.map(_j, batch), jax.tree.map(_j, outputs),
                             jl.LossWeights(**weights))
    assert set(got) == set(want) == {"unsup", "mask_reg", "nll", "supervise", "total"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL, abs=1e-7), k
    assert float(got["total"]) > 0
