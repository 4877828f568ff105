"""Losses of the mean-teacher step (port of ``core/losses.py``: ``bce``, ``mse``).

``bce`` keeps the JAX package's ``_safe_log``: the exact log for
x >= 1e-37, torch BCELoss's -100 clamp below, and finite gradients at
saturated probabilities. ``F.binary_cross_entropy`` is not used: it clamps
the log itself and its gradient at 0 and 1 differs.
"""

from __future__ import annotations

import torch

_LOG_CLAMP = -100.0
_LOG_TINY = 1e-37


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) for x >= 1e-37, -100 below; both branches have finite
    gradients (the inner floor keeps 1/x finite where the clamp is taken)."""
    floored = torch.clamp_min(x, _LOG_TINY)
    return torch.where(x < _LOG_TINY, torch.full_like(x, _LOG_CLAMP), torch.log(floored))


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities (reference nn.BCELoss semantics)."""
    losses = -(target * safe_log(pred) + (1.0 - target) * safe_log(1.0 - pred))
    return losses.mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()
