"""HEM checkpoints in the reference Manager layout (HEM/common/manager.py):
one ``torch.save`` dict ``{"state_dict", "optimizer", "scheduler", "step",
"epoch"}`` per tag, at ``<root>/model_<tag>.pth`` (``latest``, ``best``).
``state_dict`` holds the reference's key names, so the file loads in
``python -m dmhomo_torch.cli.hem_eval --torch-ckpt``."""

from __future__ import annotations

import os

import torch


def checkpoint_path(root: str, tag: str) -> str:
    return os.path.join(root, f"model_{tag}.pth")


def save_checkpoint(root: str, tag: str, state: dict) -> str:
    """Write ``state`` atomically (a temporary file, then a rename)."""
    os.makedirs(root, exist_ok=True)
    path = checkpoint_path(root, tag)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(root: str, tag: str) -> dict:
    path = checkpoint_path(root, tag)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
