"""Pure pooling math shared across models (port of ``core/pooling_math.py``)."""

from __future__ import annotations

import torch


def linear_softmax_pool(sed_probs: torch.Tensor, axis: int = 1, eps_min: float = 1e-7) -> torch.Tensor:
    """Linear-softmax pooling of frame probabilities into clip probabilities:
    ``(p * p).sum(T) / p.sum(T)``, clamped to [eps_min, 1]."""
    num = torch.sum(sed_probs * sed_probs, dim=axis)
    den = torch.sum(sed_probs, dim=axis)
    return torch.clamp(num / torch.clamp_min(den, 1e-12), eps_min, 1.0)
