"""Shared SED model output contract (port of ``models/sed_model.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class SEDOutput:
    """strong: [B, C, T] frame probabilities; weak: [B, C] linear-softmax
    pooled clip probabilities; at_out: optional [B, C] audio-tagging branch;
    extras: model-specific tensors (HTSAT_CNN's ``logit`` [B, C, T]);
    frame_before_mask: the decoder's input [B, T, D]. A model in MLM mode
    returns no strong and weak but mlm_pred [B, T, out_dim], the
    reconstruction, and mask_id_seq [B, T] bool, the corrupted frames."""

    strong: Optional[torch.Tensor] = None
    weak: Optional[torch.Tensor] = None
    at_out: Optional[torch.Tensor] = None
    extras: Optional[Dict[str, torch.Tensor]] = None
    mlm_pred: Optional[torch.Tensor] = None
    frame_before_mask: Optional[torch.Tensor] = None
    mask_id_seq: Optional[torch.Tensor] = None
