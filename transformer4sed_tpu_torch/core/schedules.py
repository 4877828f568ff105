"""Learning-rate schedules as ``step -> scale`` functions (port of
``core/schedules.py``).

Each returns the multiplicative scale of a group's base learning rate at
the 0-based optimizer step (reference ``src/utils/scheduler.py:7-122``),
the form ``torch.optim.lr_scheduler.LambdaLR`` takes.
"""

from __future__ import annotations

import math

from transformer4sed_tpu_torch.core import ramps


def exponential_warmup(rampup_length: int, exponent: float = -5.0):
    """exp(exponent * (1 - t)^2) warm-up to 1.0 (reference ExponentialWarmup)."""

    def schedule(step):
        if rampup_length == 0:
            return 1.0
        current = min(max(float(step), 0.0), float(rampup_length))
        phase = 1.0 - current / rampup_length
        return math.exp(exponent * phase * phase)

    return schedule


def exponential_down(start_iter: int, total_iter: int, exponent: float = -0.5,
                     warmup_iter: int = 0, warmup_rate: float = 0.1):
    """Linear warm-up -> plateau at 1.0 -> exp(exponent * phase^2) decay
    (reference ``src/utils/scheduler.py:41-76``)."""

    def schedule(step):
        step = float(step)
        if step < warmup_iter:
            return (1.0 - warmup_rate) * (step / max(warmup_iter, 1)) + warmup_rate
        if step > start_iter:
            phase = (step - start_iter) / max(total_iter - start_iter, 1)
            return math.exp(exponent * phase * phase)
        return 1.0

    return schedule


def cosine_down(rampup_iter: int, total_iter: int):
    """Sigmoid ramp-up then cosine ramp-down (reference CosineDown)."""

    def schedule(step):
        step = float(step)
        if step < rampup_iter:
            return ramps.sigmoid_rampup(step, rampup_iter)
        return ramps.cosine_rampdown(min(max(step - rampup_iter, 0.0), total_iter), total_iter)

    return schedule
