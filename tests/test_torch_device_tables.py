"""The resizes and ``device_build_patches`` keep their interpolation matrices,
index vectors and gray statistics on the device (made once per size,
device and dtype), so that a training step copies nothing from the host.
Their results are bit-identical to the forms that copied them at every
call, which these tests keep as the reference."""

import numpy as np
import pytest
import torch

from dmhomo_torch.data.hem_data import MEAN_I, STD_I, device_build_patches
from dmhomo_torch.geometry.homography import homography_to_flow
from dmhomo_torch.geometry.warp import (
    _align_corners_matrix,
    _half_pixel_matrix,
    resize_bilinear,
    resize_bilinear_align_corners,
    resize_nearest,
    upsample_flow_to,
)

SIZES = [((40, 72), (320, 576)), ((320, 576), (40, 72)), ((5, 7), (11, 3)), ((9, 9), (1, 4))]


def _separable_per_call(x, mh, mw):
    Mh = torch.from_numpy(mh).to(x.device, x.dtype)
    Mw = torch.from_numpy(mw).to(x.device, x.dtype)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.einsum("oh,bhwc->bowc", Mh, x)
        return torch.einsum("pw,bowc->bopc", Mw, y)


def _nearest_per_call(x, out_hw):
    _, H, W, _ = x.shape
    oh, ow = out_hw
    iy = np.clip(np.floor(np.arange(oh) * (H / oh)).astype(np.int64), 0, H - 1)
    ix = np.clip(np.floor(np.arange(ow) * (W / ow)).astype(np.int64), 0, W - 1)
    return x.index_select(1, torch.from_numpy(iy)).index_select(2, torch.from_numpy(ix))


def _upsample_flow_per_call(flow, out_hw):
    _, h, w, _ = flow.shape
    oh, ow = out_hw
    flow = flow * torch.tensor([ow / w, oh / h], dtype=flow.dtype, device=flow.device)
    return _separable_per_call(flow, _align_corners_matrix(h, oh), _align_corners_matrix(w, ow))


def _input(hw, c, dtype, seed=0):
    x = np.random.default_rng(seed).normal(0, 3, (2, *hw, c))
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_resizes_bit_identical(in_hw, out_hw, dtype):
    x = _input(in_hw, 3, dtype)
    H, W = in_hw
    oh, ow = out_hw
    for _ in range(2):  # the first call makes the tables, the second reuses them
        assert torch.equal(resize_bilinear(x, out_hw), _separable_per_call(
            x, _half_pixel_matrix(H, oh), _half_pixel_matrix(W, ow)))
        assert torch.equal(resize_bilinear_align_corners(x, out_hw), _separable_per_call(
            x, _align_corners_matrix(H, oh), _align_corners_matrix(W, ow)))
        assert torch.equal(resize_nearest(x, out_hw), _nearest_per_call(x, out_hw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_upsample_flow_bit_identical(in_hw, out_hw, dtype):
    """The rate multiplies each channel as a scalar rounded to the flow's
    dtype: the same bits as the per-call rate tensor of that dtype."""
    flow = _input(in_hw, 2, dtype, seed=1)
    assert torch.equal(upsample_flow_to(flow, out_hw), _upsample_flow_per_call(flow, out_hw))


def test_device_build_patches_bit_identical():
    """``device_build_patches`` with its cached gray statistics against the
    per-call statistics, resize included (S=48 -> 40x72)."""
    rng = np.random.default_rng(2)
    img12 = torch.from_numpy(rng.integers(0, 256, (3, 6, 48, 48), dtype=np.uint8))
    homo = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    homo[:, :2, 2] = rng.uniform(-2, 2, (3, 2))
    homo = torch.from_numpy(homo)
    homo_inv = torch.linalg.inv(homo)
    start = torch.from_numpy(rng.integers(0, 5, (3, 2)).astype(np.int32))
    got = device_build_patches(img12, homo, homo_inv, start, (32, 64), (40, 72))

    imgs = _separable_per_call(img12.permute(0, 2, 3, 1).float(), _half_pixel_matrix(48, 40),
                               _half_pixel_matrix(48, 72))
    mean = torch.tensor(MEAN_I.ravel(), dtype=torch.float32)
    std = torch.tensor(STD_I.ravel(), dtype=torch.float32)
    gray = torch.cat([((imgs[..., :3] - mean) / std).mean(-1, keepdim=True),
                      ((imgs[..., 3:] - mean) / std).mean(-1, keepdim=True)], dim=-1)
    flows = torch.cat([homography_to_flow(homo_inv, 40, 72, eps=1e-8),
                       homography_to_flow(homo, 40, 72, eps=1e-8)], dim=-1)
    start = start.long()
    rows = (start[:, 1:2] + torch.arange(32))[:, :, None]
    cols = (start[:, 0:1] + torch.arange(64))[:, None, :]
    b = torch.arange(3)[:, None, None]
    assert torch.equal(got["imgs_gray_patch"], gray[b, rows, cols])
    assert torch.equal(got["flow_gt_patch"], flows[b, rows, cols])


def test_tables_made_in_inference_mode_serve_autograd():
    """A table first made under ``torch.inference_mode`` (the eval forward)
    is a normal tensor: a later training forward may save it for backward."""
    x = _input((13, 17), 2, torch.float32, seed=3)
    with torch.inference_mode():
        upsample_flow_to(x, (19, 23))
        resize_nearest(x, (19, 23))
    y = x.clone().requires_grad_(True)
    (upsample_flow_to(y, (19, 23)).sum() + resize_nearest(y, (19, 23)).sum()).backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
