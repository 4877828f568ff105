"""Linear time interpolation with ``F.interpolate(mode='linear')`` parity
(port of ``models/interpolate.py``): align_corners=False, edge-clamped."""

from __future__ import annotations

import numpy as np
import torch


def resize_time(seq: torch.Tensor, t_out: int) -> torch.Tensor:
    """Resize [B, T, C] -> [B, t_out, C] along time: output i samples input
    coordinate (i + 0.5) * T / t_out - 0.5, clamped to the edges."""
    t = seq.shape[1]
    if t_out == t:
        return seq
    coords = np.clip((np.arange(t_out) + 0.5) * (t / t_out) - 0.5, 0.0, t - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = torch.as_tensor((coords - lo).astype(np.float32), device=seq.device)[None, :, None]
    lo_v = torch.index_select(seq, 1, torch.as_tensor(lo, device=seq.device))
    hi_v = torch.index_select(seq, 1, torch.as_tensor(hi, device=seq.device))
    return lo_v * (1.0 - w) + hi_v * w


def interpolate_time(seq: torch.Tensor, ratio: int) -> torch.Tensor:
    """Upsample [B, T, C] -> [B, T*ratio, C] along time (integer ratio)."""
    return seq if ratio == 1 else resize_time(seq, seq.shape[1] * ratio)
