"""Flow -> RGB renderings on the flow's device (the JAX package's
``geometry/flow_viz.py``).

* :func:`flow_to_rgb` - the DGM conditioning image: an HSV encoding with
  max_flow 256 and n 8, hue the flow's direction, saturation its magnitude,
  value clip(n - s, 0, 1); HSV -> RGB as ``matplotlib.colors.hsv_to_rgb``.
* :func:`flow_to_rgb_middlebury` - the Middlebury colour wheel of the
  reference's ``flow_to_image_luo``, for previews, in float64.

``data/conditions.py`` keeps numpy twins of the first (``hsv_to_rgb_np``,
``flow_to_rgb_np``) as the plain versions the tests hold these to.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV in [0, 1] -> (..., 3) RGB in [0, 1], the six-sector
    formula of matplotlib."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i, 6.0).long()
    table = torch.stack([torch.stack(c, dim=-1) for c in
                         ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))],
                        dim=-2)  # (..., 6, 3)
    return torch.gather(table, -2, i[..., None, None].expand(*i.shape, 1, 3))[..., 0, :]


def flow_to_rgb(flow: torch.Tensor, max_flow: float = 256.0, n: float = 8.0) -> torch.Tensor:
    """(..., h, w, 2) flow -> (..., h, w, 3) RGB in [0, 1].  ``max_flow=None``
    takes the flow's largest value (read back to the host)."""
    max_flow = max(max_flow, 1.0) if max_flow is not None else float(flow.max())
    u, v = flow[..., 0], flow[..., 1]
    mag = torch.sqrt(u * u + v * v)
    im_h = torch.remainder(torch.atan2(v, u) / (2 * math.pi) + 1.0, 1.0)
    im_s = torch.clamp(mag * n / max_flow, 0.0, 1.0)
    im_v = torch.clamp(n - im_s, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([im_h, im_s, im_v], dim=-1))


def _middlebury_color_wheel() -> np.ndarray:
    """The 55-colour Middlebury wheel, (55, 3) in 0..255."""
    segments = ((15, (0, 1), True), (6, (1, 0), False), (4, (1, 2), True), (11, (2, 1), False),
                (13, (2, 0), True), (6, (0, 2), False))
    rows = []
    for n, (full, ramp), up in segments:
        seg = np.zeros((n, 3))
        seg[:, full] = 255
        r = np.floor(255 * np.arange(n) / n)
        seg[:, ramp] = r if up else 255 - r
        rows.append(seg)
    return np.concatenate(rows)


def flow_to_rgb_middlebury(flow: torch.Tensor) -> torch.Tensor:
    """The Middlebury colour code of a flow (h, w, 2) -> (h, w, 3) in [0, 1],
    float64 on the flow's device: magnitudes over the largest one (read back
    to the host), unknown flow (|u| or |v| > 1e7, NaN) black."""
    flow = flow.to(torch.float64)
    u, v = flow[..., 0], flow[..., 1]
    bad = (u.abs() > 1e7) | (v.abs() > 1e7) | u.isnan() | v.isnan()
    u = torch.where(bad, 0.0, u)
    v = torch.where(bad, 0.0, v)
    maxrad = max(-1.0, float(torch.sqrt(u * u + v * v).max()))
    eps = np.finfo(float).eps
    u = u / (maxrad + eps)
    v = v / (maxrad + eps)
    wheel = torch.from_numpy(_middlebury_color_wheel() / 255.0).to(flow.device)
    ncols = wheel.shape[0]
    rad = torch.sqrt(u * u + v * v)
    fk = (torch.atan2(-v, -u) / math.pi + 1) / 2 * (ncols - 1) + 1
    k0 = torch.floor(fk).long()
    k1 = torch.where(k0 + 1 == ncols + 1, 1, k0 + 1)
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0 - 1] + f * wheel[k1 - 1]
    inside = (rad <= 1)[..., None]
    col = torch.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    return torch.floor(255 * col * (~bad)[..., None]) / 255.0
