"""The port's homography geometry against the JAX package's: the tensor
functions (fp32; 3e-5 absolute on pixel coordinates up to ~150, two fp32
ulps there; 1e-5 relative on the 3x3 matrices), the numpy float64 host functions (the
same float64 expression: 1e-6 px after the fp32 cast) and the half-pixel
bilinear resize (1e-5 on values of order 1)."""

import numpy as np
import pytest
import torch

from dmhomo_tpu.geometry import homography as jh
from dmhomo_tpu.geometry import host as jhost
from dmhomo_tpu.geometry import warp as jw

from dmhomo_torch.geometry import homography as th
from dmhomo_torch.geometry import host as thost
from dmhomo_torch.geometry import warp as tw

H_, W_ = 72, 144


def _homographies(rng, n=3, off=8.0):
    corners = np.array([[0, 0], [W_ - 1, 0], [0, H_ - 1], [W_ - 1, H_ - 1]], np.float32)
    src = np.broadcast_to(corners, (n, 4, 2)).copy()
    offset = rng.uniform(-off, off, (n, 4, 2)).astype(np.float32)
    return src, offset


def test_dlt_solve_4pt_matches_jax():
    import jax.numpy as jnp

    src, off = _homographies(np.random.default_rng(0))
    got = th.dlt_solve_4pt(torch.from_numpy(src), torch.from_numpy(off)).numpy()
    want = np.asarray(jh.dlt_solve_4pt(jnp.asarray(src), jnp.asarray(off)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the corners land on corners + offset
    mapped = th.apply_homography(torch.from_numpy(got), torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(mapped, src + off, atol=1e-3)


@pytest.mark.parametrize("guard, eps", [("add", 1e-6), ("add", 1e-8), ("cond", 1e-6)])
def test_mapping_flow_and_points_match_jax(guard, eps):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    src, off = _homographies(rng)
    H = np.array(jh.dlt_solve_4pt(jnp.asarray(src), jnp.asarray(off)))
    Ht = torch.from_numpy(H)
    for name in ("homography_to_mapping", "homography_to_flow"):
        got = getattr(th, name)(Ht, H_, W_, guard=guard, eps=eps).numpy()
        want = np.asarray(getattr(jh, name)(jnp.asarray(H), H_, W_, guard=guard, eps=eps))
        assert got.shape == (3, H_, W_, 2)
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0, err_msg=name)
    pts = rng.uniform(0, 100, (3, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(
        th.apply_homography(Ht, torch.from_numpy(pts), guard=guard, eps=eps).numpy(),
        np.asarray(jh.apply_homography(jnp.asarray(H), jnp.asarray(pts), guard=guard, eps=eps)),
        atol=3e-5, rtol=0)


def test_unknown_guard_raises():
    with pytest.raises(ValueError, match="unknown guard"):
        th.apply_homography(torch.eye(3), torch.zeros(1, 2), guard="nope")


def test_rescale_homography_matches_jax():
    import jax.numpy as jnp

    src, off = _homographies(np.random.default_rng(2))
    H = np.array(jh.dlt_solve_4pt(jnp.asarray(src), jnp.asarray(off)))
    got = th.rescale_homography(torch.from_numpy(H), (256, 256), (H_, W_)).numpy()
    want = np.asarray(jh.rescale_homography(jnp.asarray(H), (256, 256), (H_, W_)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        thost.rescale_homography_np(H[0], (256, 256), (H_, W_)),
        jhost.rescale_homography_np(H[0], (256, 256), (H_, W_)), rtol=1e-12, atol=0)


def test_host_functions_match_jax():
    src, off = _homographies(np.random.default_rng(3), n=1)
    H = th.dlt_solve_4pt(torch.from_numpy(src), torch.from_numpy(off))[0].double().numpy()
    for eps in (1e-6, 1e-8):
        np.testing.assert_allclose(thost.homography_to_mapping_np(H, H_, W_, eps),
                                   jhost.homography_to_mapping_np(H, H_, W_, eps),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(thost.homography_to_flow_np(H, H_, W_, eps),
                                   jhost.homography_to_flow_np(H, H_, W_, eps),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("in_hw, out_hw", [((9, 18), (72, 144)), ((80, 80), (72, 144)),
                                           ((64, 64), (32, 48))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    import jax.numpy as jnp

    x = np.random.default_rng(4).normal(0, 1, (2, *in_hw, 3)).astype(np.float32)
    got = tw.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jw.resize_bilinear(jnp.asarray(x), out_hw))
    assert got.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
