"""The port's geometry remainder against the JAX package's, fp32 on the
CPU: ``homogeneous_grid``, ``homography_from_points_ax0``,
``warp_by_homography``, ``upsample_flow_to`` with and without the rate,
``flow_ops`` (conversions, masks, ``RandomHomography`` from equal draws) and
``flow_viz`` (``hsv_to_rgb``, ``flow_to_rgb``, ``flow_to_rgb_middlebury``).

Tolerance: 1e-6 of the largest reference value (fp32 rounding of the same
arithmetic in another order); index, mask and sampler outputs exactly.  Two
functions are held to it through what they compute: the Ax0 homography by
the points it maps (its entries come from an fp32 SVD, 3-7e-5 off the true
ones on either side), and the warp by its sampling coordinates, the warped
values then within what that coordinate rounding moves a bilinear sample
(twice the coordinates' largest difference times the image's largest step
between neighbours).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.geometry import flow_ops as jax_flow_ops
from dmhomo_tpu.geometry import flow_viz as jax_flow_viz
from dmhomo_tpu.geometry import grids as jax_grids
from dmhomo_tpu.geometry import homography as jax_homography
from dmhomo_tpu.geometry import warp as jax_warp

from dmhomo_torch.geometry import flow_ops, flow_viz
from dmhomo_torch.geometry.grids import homogeneous_grid
from dmhomo_torch.geometry.homography import (
    apply_homography,
    homography_from_points_ax0,
    homography_to_mapping,
)
from dmhomo_torch.geometry.warp import upsample_flow_to, warp_by_homography

REL = 1e-6


def assert_rel(got, want, rel=REL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _homographies(rng, n, h, w):
    Hs = []
    for _ in range(n):
        d = rng.normal(0, 0.02, (3, 3))
        d[2, :2] *= 1e-3
        d[2, 2] = 0
        d[:2, 2] *= min(h, w) / 4
        Hs.append(np.eye(3) + d)
    return np.stack(Hs).astype(np.float32)


def test_homogeneous_grid_matches_jax():
    np.testing.assert_array_equal(homogeneous_grid(5, 7).numpy(),
                                  np.asarray(jax_grids.homogeneous_grid(5, 7)))


def test_homography_from_points_ax0_matches_jax():
    rng = np.random.default_rng(0)
    Hs = _homographies(rng, 3, 90, 160).astype(np.float64)
    src = rng.uniform([0, 0], [160, 90], (3, 6, 2))
    xy = np.concatenate([src, np.ones_like(src[..., :1])], -1) @ Hs.transpose(0, 2, 1)
    dst = (xy[..., :2] / xy[..., 2:]).astype(np.float32)
    src = src.astype(np.float32)
    got = homography_from_points_ax0(torch.from_numpy(src), torch.from_numpy(dst))
    want = jax_homography.homography_from_points_ax0(jnp.asarray(src), jnp.asarray(dst))
    assert float(got[:, 2, 2].sub(1).abs().max()) == 0.0
    pts = torch.from_numpy(src)
    assert_rel(apply_homography(got, pts), apply_homography(torch.from_numpy(np.array(want)), pts))
    assert_rel(apply_homography(got, pts), dst)


@pytest.mark.parametrize("mode", ["collapse", "border"])
@pytest.mark.parametrize("guard", ["cond", "add"])
def test_warp_by_homography_matches_jax(mode, guard):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    H = _homographies(rng, 2, 24, 40)
    coords = homography_to_mapping(torch.from_numpy(H), 24, 40, guard=guard)
    want_coords = np.asarray(jax_homography.homography_to_mapping(jnp.asarray(H), 24, 40,
                                                                  guard=guard))
    assert_rel(coords, want_coords)
    got = warp_by_homography(torch.from_numpy(img), torch.from_numpy(H), mode=mode, guard=guard)
    want = np.asarray(jax_warp.warp_by_homography(jnp.asarray(img), jnp.asarray(H), mode=mode,
                                                  guard=guard))
    step = max(np.abs(np.diff(img, axis=a)).max() for a in (1, 2))
    moved = 2 * float(np.abs(coords.numpy() - want_coords).max()) * step
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= REL * np.abs(want).max() + moved


@pytest.mark.parametrize("scale", [False, True])
def test_upsample_flow_to_matches_jax(scale):
    flow = np.random.default_rng(2).normal(0, 3, (2, 9, 13, 2)).astype(np.float32)
    got = upsample_flow_to(torch.from_numpy(flow), (20, 31), scale=scale)
    assert_rel(got, jax_warp.upsample_flow_to(jnp.asarray(flow), (20, 31), scale=scale))


@pytest.mark.parametrize("name", ["convert_flow_to_mapping", "convert_mapping_to_flow",
                                  "normalize_mapping", "unnormalize_mapping",
                                  "correspondence_mask", "border_mask"])
def test_flow_ops_match_jax(name):
    flow = np.random.default_rng(3).normal(0, 6, (2, 11, 17, 2)).astype(np.float32)
    got = getattr(flow_ops, name)(torch.from_numpy(flow))
    want = np.asarray(getattr(jax_flow_ops, name)(jnp.asarray(flow)))
    if want.dtype == bool:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert_rel(got, want)


def test_zero_border_mask_matches_jax():
    img = np.random.default_rng(4).uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    img[0, :3] = 0.0
    img[1, 4, :5, 1:] = 0.0  # one channel left: not a border
    got = flow_ops.zero_border_mask(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_flow_ops.zero_border_mask(jnp.asarray(img))))
    assert not got[0, :3].any() and got[1].all()


@pytest.mark.parametrize("kw", [{}, {"p_flip": 0.5, "max_rotation": 30.0}])
def test_random_homography_matches_jax(kw):
    ours, theirs = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        np.testing.assert_array_equal(flow_ops.RandomHomography(**kw).sample(ours, 40, 60),
                                      jax_flow_ops.RandomHomography(**kw).sample(theirs, 40, 60))


def test_flow_to_rgb_matches_jax():
    flow = np.random.default_rng(6).normal(0, 60, (2, 20, 30, 2)).astype(np.float32)
    flow[0, 0, :3] = 0.0  # zero saturation
    flow[0, 1, 0] = [-5.0, 0.0]  # angle pi
    flow[1, 2, 2] = [400.0, -300.0]  # saturation clipped at 1
    assert_rel(flow_viz.flow_to_rgb(torch.from_numpy(flow)),
               jax_flow_viz.flow_to_rgb(jnp.asarray(flow)))
    hsv = np.random.default_rng(7).uniform(0, 1, (50, 3)).astype(np.float32)
    assert_rel(flow_viz.hsv_to_rgb(torch.from_numpy(hsv)),
               jax_flow_viz.hsv_to_rgb(jnp.asarray(hsv)))


def test_flow_to_rgb_middlebury_matches_jax():
    flow = np.random.default_rng(8).normal(0, 10, (20, 30, 2)).astype(np.float32)
    flow[3, 3] = np.nan
    flow[4, 4] = [2e7, 0.0]  # unknown flow: black
    got = flow_viz.flow_to_rgb_middlebury(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got, jax_flow_viz.flow_to_rgb_middlebury(flow))
    assert (got[3, 3] == 0).all() and (got[4, 4] == 0).all()
