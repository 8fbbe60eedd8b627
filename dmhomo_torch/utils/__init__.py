"""Shared utilities: checkpoints, logging, meters, model constructors,
profiling, image files (named after the JAX package's ``utils`` exports
where a counterpart exists)."""

from dmhomo_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dmhomo_torch.utils.constructor import NetConstructor, model_constructor
from dmhomo_torch.utils.logging import get_logger
from dmhomo_torch.utils.meters import AverageMeter, MetricTracker

__all__ = [
    "NetConstructor",
    "model_constructor",
    "save_checkpoint",
    "load_checkpoint",
    "AverageMeter",
    "MetricTracker",
    "get_logger",
]
