"""Pixel coordinate grids: (x, y) pixel indices, x fastest along width."""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) pixel coordinates."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def homogeneous_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(h, w, 3) grid of (x, y, 1) homogeneous pixel coordinates."""
    g = pixel_grid(h, w, dtype=dtype, device=device)
    return torch.cat([g, torch.ones_like(g[..., :1])], dim=-1)
