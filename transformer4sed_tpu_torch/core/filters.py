"""Per-class median and maximum filtering of frame scores on the device.

Port of the JAX package's ``core/filters.py``: windows are gathered with a
static index matrix and reduced along the window axis (a sort for the
median, a max). Classes that share a width are filtered together. Two
boundary modes, as in scipy.ndimage: "reflect" (d c b a | a b c d | d c b
a, scipy's default and the scores' decode path) and "nearest" (a a a a |
a b c d | d d d d, edge replication, the thresholded decode path).

The median of an even-width window is the mean of its two middle values,
as ``jnp.median`` (and scipy) define it; ``torch.median`` returns the lower
one instead, so the windows are sorted here.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def _window_indices(t: int, width: int, mode: str = "reflect") -> np.ndarray:
    """Gather indices [t, width] with scipy.ndimage's boundary ``mode``;
    window centred per scipy's convention (left half = width // 2)."""
    idx = np.arange(t)[:, None] + np.arange(width)[None, :] - width // 2
    if mode == "nearest":
        return np.clip(idx, 0, t - 1).astype(np.int64)
    if mode != "reflect":
        raise ValueError(f"unknown boundary mode {mode!r}")
    idx = np.mod(idx, 2 * t)
    return np.where(idx >= t, 2 * t - 1 - idx, idx).astype(np.int64)


def _sliding_windows(x: torch.Tensor, width: int, axis: int, mode: str) -> torch.Tensor:
    """Windows of ``width`` along ``axis``, as a new last dim."""
    idx = torch.as_tensor(_window_indices(x.shape[axis], width, mode), device=x.device)
    win = torch.index_select(x, axis, idx.reshape(-1))
    win = win.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    return torch.movedim(win, axis + 1, -1)


def median_filter(x: torch.Tensor, width: int, axis: int = 1,
                  mode: str = "reflect") -> torch.Tensor:
    """1-D median filter along ``axis`` (scipy boundary ``mode``)."""
    if width <= 1:
        return x
    win, _ = torch.sort(_sliding_windows(x, width, axis, mode), dim=-1)
    mid = width // 2
    if width % 2:
        return win[..., mid]
    return (win[..., mid - 1] + win[..., mid]) * 0.5


def max_filter(x: torch.Tensor, width: int, axis: int = 1,
               mode: str = "reflect") -> torch.Tensor:
    """1-D maximum filter along ``axis`` (scipy boundary ``mode``)."""
    if width <= 1:
        return x
    return torch.amax(_sliding_windows(x, width, axis, mode), dim=-1)


_FILTERS = {"median": median_filter, "max": max_filter}


def apply_class_filter(scores: torch.Tensor, widths: Union[int, Sequence[int]],
                       kind: str = "median", mode: str = "reflect") -> torch.Tensor:
    """Filter ``[..., T, C]`` scores per class with per-class widths."""
    n_classes = scores.shape[-1]
    if isinstance(widths, (int, np.integer)):
        widths = [int(widths)] * n_classes
    widths = list(widths)
    if len(widths) != n_classes:
        raise ValueError(f"got {len(widths)} widths for {n_classes} classes")
    if kind not in _FILTERS:
        raise ValueError(f"unknown filter kind {kind!r}; expected 'median' or 'max'")
    out = scores
    for width in sorted(set(widths)):
        if width <= 1:
            continue
        class_mask = torch.as_tensor([w == width for w in widths], device=scores.device)
        filtered = _FILTERS[kind](scores, width, axis=scores.ndim - 2, mode=mode)
        out = torch.where(class_mask, filtered, out)
    return out
