"""Sliding-window overlap-add encoding (port of ``models/slide.py``).

The reference encodes windows of ``win_width`` mel frames at ``step`` one by
one and overlap-adds the count-normalised embeddings into the output grid
(``src/models/encoder_slide_window.py:16-36``). As in the JAX package, the
windows of one width are stacked into the batch and encoded in one backbone
call, width group by width group in the order the groups are first met (the
ragged tail window, shorter than ``win_width``, forms its own group), then
added back at ``round(start * emb_len / input_len)`` (Python's round, half to
even, on Python ints). Positions no window covers stay 0 (the reference's
NaN -> 0).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def window_layout(input_len: int, win_width: int, step: int) -> List[Tuple[int, int]]:
    """(start, width) of each window, matching the reference loop bounds."""
    return [(left, min(win_width, input_len - left))
            for left in range(0, input_len + step - win_width, step)]


def width_groups(input_len: int, win_width: int, step: int) -> Dict[int, List[int]]:
    """Window starts by width, the widths in the order they are first met."""
    groups: Dict[int, List[int]] = {}
    for start, width in window_layout(input_len, win_width, step):
        groups.setdefault(width, []).append(start)
    return groups


def slide_window_encode(encode_fn: Callable[[torch.Tensor, int], torch.Tensor],
                        mel: torch.Tensor, emb_len: int, win_width: int = 512,
                        step: int = 49) -> torch.Tensor:
    """Overlap-add encode. ``mel``: [B, F, T]; returns [B, emb_len, D].

    ``encode_fn(windows, group)`` maps the ``group``-th width group's window
    batch [N, F, W] (window-major: window i of every clip, then window i+1)
    to [N, t_out, D] frame embeddings (backbone, f-pool, interpolation).
    """
    b, _, input_len = mel.shape
    scale = emb_len / input_len
    embedding = counts = None
    for group, (width, starts) in enumerate(width_groups(input_len, win_width, step).items()):
        outs = encode_fn(torch.cat([mel[:, :, s:s + width] for s in starts]), group)
        t_out, d = outs.shape[1], outs.shape[2]
        outs = outs.reshape(len(starts), b, t_out, d)
        if embedding is None:
            embedding = outs.new_zeros(b, emb_len, d)
            counts = outs.new_zeros(1, emb_len, 1)
        for i, s in enumerate(starts):
            left = round(s * scale)
            right = min(emb_len, left + t_out)
            embedding = embedding.index_add(
                1, torch.arange(left, right, device=mel.device), outs[i, :, :right - left])
            counts[:, left:right] += 1.0
    return torch.where(counts > 0, embedding / counts.clamp(min=1.0), 0.0)
