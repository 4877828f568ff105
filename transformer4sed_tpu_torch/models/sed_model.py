"""Shared SED model output contract (port of ``models/sed_model.py``;
the MLM fields come with the MLM slice, ROADMAP.md queue 1 item 1)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class SEDOutput:
    """strong: [B, C, T] frame probabilities; weak: [B, C] linear-softmax
    pooled clip probabilities; at_out: optional [B, C] audio-tagging branch;
    extras: model-specific tensors (HTSAT_CNN's ``logit`` [B, C, T])."""

    strong: torch.Tensor
    weak: torch.Tensor
    at_out: Optional[torch.Tensor] = None
    extras: Optional[Dict[str, torch.Tensor]] = None
