"""Shared SED model output contract (port of ``models/sed_model.py``;
the MLM fields come with the MLM slice, ROADMAP.md queue 1 item 1)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class SEDOutput:
    """strong: [B, C, T] frame probabilities; weak: [B, C] linear-softmax
    pooled clip probabilities; at_out: optional [B, C] audio-tagging branch."""

    strong: torch.Tensor
    weak: torch.Tensor
    at_out: Optional[torch.Tensor] = None
