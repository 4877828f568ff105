"""Hyper-parameter ramp functions (port of ``core/ramps.py``).

Pure functions of the step count (reference ``src/functional/ramps.py:21-53``),
on Python floats.
"""

from __future__ import annotations

import math


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 * (1 - t)^2) ramp-up from arXiv:1610.02242."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return math.exp(-5.0 * phase * phase)


def linear_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    return min(max(float(current) / rampup_length, 0.0), 1.0)


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    """Cosine ramp-down from arXiv:1608.03983."""
    return 0.5 * (math.cos(math.pi * float(current) / rampdown_length) + 1.0)


def sigmoid_rampdown(current: float, rampup_length: float) -> float:
    """exp(-12.5 * (1 - t)^2) variant used for ramp-downs."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return math.exp(-12.5 * phase * phase)
