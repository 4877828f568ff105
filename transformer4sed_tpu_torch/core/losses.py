"""Losses of the ported train steps (port of ``core/losses.py``: ``bce``,
``bce_logits``, ``mse``, ``asl``, ``reweighted_asl``, ``asymmetric_focal``
and the factory of the config names; ``info_nce`` and ``sup_con``, which no
recipe calls, are ROADMAP.md queue 1 item 13).

``bce`` keeps the JAX package's ``_safe_log``: the exact log for
x >= 1e-37, torch BCELoss's -100 clamp below, and finite gradients at
saturated probabilities. ``F.binary_cross_entropy`` is not used: it clamps
the log itself and its gradient at 0 and 1 differs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

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


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE on logits: softplus(x) - target * x."""
    return (F.softplus(logits) - target * logits).mean()


def asl(pred: torch.Tensor, target: torch.Tensor, rp: float, rn: float,
        margin: float) -> torch.Tensor:
    """Asymmetric loss with probability margin (reference AslLoss)."""
    pred_m = torch.clamp_min(pred - margin, 0.0)
    losses = -(((1.0 - pred) ** rp) * target * safe_log(pred)
               + (pred_m ** rn) * (1.0 - target) * safe_log(1.0 - pred_m))
    return losses.mean()


def reweighted_asl(pred: torch.Tensor, target: torch.Tensor, rp: float, rn: float,
                   margin: float, weight) -> torch.Tensor:
    """ASL with per-class weights on the trailing (class) dimension."""
    weight = torch.as_tensor(weight, dtype=pred.dtype, device=pred.device)
    pred_m = torch.clamp_min(pred - margin, 0.0)
    losses = -weight * (((1.0 - pred) ** rp) * target * safe_log(pred)
                        + (pred_m ** rn) * (1.0 - target) * safe_log(1.0 - pred_m))
    return losses.mean()


def asymmetric_focal(pred: torch.Tensor, target: torch.Tensor, gamma: float = 0.0,
                     zeta: float = 0.0) -> torch.Tensor:
    """Asymmetric focal loss (reference AsymmetricalFocalLoss)."""
    losses = -(((1.0 - pred) ** gamma) * target * safe_log(pred)
               + (pred ** zeta) * (1.0 - target) * safe_log(1.0 - pred))
    return losses.mean()


_REGISTRY: Dict[str, Callable[..., Callable]] = {
    "BCELoss": lambda **kw: bce,
    "MSELoss": lambda **kw: mse,
    "AslLoss": lambda **kw: functools.partial(asl, **kw),
    "ReweightedASL": lambda **kw: functools.partial(reweighted_asl, **kw),
    "AsymmetricalFocalLoss": lambda **kw: functools.partial(asymmetric_focal, **kw),
}


def loss_function_factory(name: str, kwargs: Optional[dict] = None) -> Callable:
    """Build a ``loss(pred, target) -> scalar`` from a config name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**(kwargs or {}))
