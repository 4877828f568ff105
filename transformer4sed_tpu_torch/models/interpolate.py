"""Time interpolation with ``F.interpolate`` parity (port of
``models/interpolate.py``): ``linear`` is align_corners=False and
edge-clamped, ``nearest`` takes frame ``floor(i * T / t_out)``."""

from __future__ import annotations

import numpy as np
import torch


def resize_time(seq: torch.Tensor, t_out: int, mode: str = "linear") -> torch.Tensor:
    """Resize [B, T, C] -> [B, t_out, C] along time to any length (up or
    down, integer ratio or not): output i samples input coordinate
    (i + 0.5) * T / t_out - 0.5, clamped to the edges."""
    t = seq.shape[1]
    if t_out == t:
        return seq
    scale = t / t_out
    if mode == "nearest":
        idx = np.clip(np.floor(np.arange(t_out) * scale), 0, t - 1).astype(np.int64)
        return torch.index_select(seq, 1, torch.as_tensor(idx, device=seq.device))
    if mode != "linear":
        raise ValueError(f"unknown interpolation mode {mode!r}")
    coords = np.clip((np.arange(t_out) + 0.5) * scale - 0.5, 0.0, t - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = torch.as_tensor((coords - lo).astype(np.float32), device=seq.device)[None, :, None]
    lo_v = torch.index_select(seq, 1, torch.as_tensor(lo, device=seq.device))
    hi_v = torch.index_select(seq, 1, torch.as_tensor(hi, device=seq.device))
    return lo_v * (1.0 - w) + hi_v * w


def interpolate_time(seq: torch.Tensor, ratio: int, mode: str = "linear") -> torch.Tensor:
    """Upsample [B, T, C] -> [B, T*ratio, C] along time (integer ratio)."""
    return seq if ratio == 1 else resize_time(seq, seq.shape[1] * ratio, mode)
