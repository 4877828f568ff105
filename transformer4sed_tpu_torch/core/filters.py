"""Per-class median filtering of frame scores on the device.

Port of ``transformer4sed_tpu/core/filters.py`` (median kind, scipy's
default "reflect" boundary): windows are gathered with a static index
matrix and sorted along the window axis. Classes that share a width are
filtered together.

The median of an even-width window is the mean of its two middle
values, as ``jnp.median`` (and scipy) define it; ``torch.median``
returns the lower one instead, so the windows are sorted here.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def _window_indices(t: int, width: int) -> np.ndarray:
    """Gather indices [t, width] with scipy.ndimage's "reflect" boundary
    (d c b a | a b c d | d c b a); window centred per scipy's convention
    (left half = width // 2)."""
    idx = np.arange(t)[:, None] + np.arange(width)[None, :] - width // 2
    idx = np.mod(idx, 2 * t)
    return np.where(idx >= t, 2 * t - 1 - idx, idx).astype(np.int64)


def median_filter(x: torch.Tensor, width: int, axis: int = 1) -> torch.Tensor:
    """1-D median filter along ``axis`` (scipy "reflect" boundary)."""
    if width <= 1:
        return x
    idx = torch.as_tensor(_window_indices(x.shape[axis], width), device=x.device)
    win = torch.index_select(x, axis, idx.reshape(-1))
    win = win.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    win, _ = torch.sort(torch.movedim(win, axis + 1, -1), dim=-1)
    mid = width // 2
    if width % 2:
        return win[..., mid]
    return (win[..., mid - 1] + win[..., mid]) * 0.5


def apply_class_filter(scores: torch.Tensor, widths: Union[int, Sequence[int]]) -> torch.Tensor:
    """Median-filter ``[..., T, C]`` scores per class with per-class widths."""
    n_classes = scores.shape[-1]
    if isinstance(widths, (int, np.integer)):
        widths = [int(widths)] * n_classes
    widths = list(widths)
    if len(widths) != n_classes:
        raise ValueError(f"got {len(widths)} widths for {n_classes} classes")
    out = scores
    for width in sorted(set(widths)):
        if width <= 1:
            continue
        class_mask = torch.as_tensor([w == width for w in widths], device=scores.device)
        out = torch.where(class_mask, median_filter(scores, width, axis=scores.ndim - 2), out)
    return out
