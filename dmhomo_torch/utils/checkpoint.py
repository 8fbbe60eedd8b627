"""Checkpoint files, written atomically.

HEM checkpoints take the reference Manager layout (HEM/common/manager.py):
one ``torch.save`` dict ``{"state_dict", "optimizer", "scheduler", "step",
"epoch"}`` per tag, at ``<root>/model_<tag>.pth`` (``latest``, ``best``).
``state_dict`` holds the reference's key names, so the file loads in
``python -m dmhomo_torch.cli.hem_eval --torch-ckpt``.  The DGM trainer
writes its own layout through :func:`atomic_save`."""

from __future__ import annotations

import os

import torch


def checkpoint_path(root: str, tag: str) -> str:
    return os.path.join(root, f"model_{tag}.pth")


def atomic_save(state: dict, path: str) -> str:
    """``torch.save`` to a temporary file beside ``path``, then a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(root: str, tag: str, state: dict) -> str:
    """Write ``state`` atomically at ``<root>/model_<tag>.pth``."""
    return atomic_save(state, checkpoint_path(root, tag))


def load_checkpoint(root: str, tag: str) -> dict:
    path = checkpoint_path(root, tag)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
