"""Mean-teacher EMA update (port of ``core/ema.py``).

``teacher <- alpha * teacher + (1 - alpha) * student`` with
``alpha = min(1 - 1/step, ema_factor)`` (reference
``src/utils/scheduler.py:125-130``), once per optimizer step after it. The
teacher's tensors are updated in place (no second copy of the model).
"""

from __future__ import annotations

from typing import Iterable

import torch


@torch.no_grad()
def ema_update(student: Iterable[torch.Tensor], teacher: Iterable[torch.Tensor], step: int,
               ema_factor: float = 0.999) -> float:
    """One EMA step over paired tensors; ``step`` is the 1-based optimizer
    step count. Returns alpha."""
    alpha = min(1.0 - 1.0 / max(float(step), 1.0), ema_factor)
    for t, s in zip(teacher, student):
        t.mul_(alpha).add_(s.detach(), alpha=1.0 - alpha)
    return alpha
