"""Shared recipe helpers (port of the JAX package's ``recipes/common.py``,
begun): the ground-truth and duration tables that scoring reads, through
the port's TSV reader in place of pandas. The trainer wiring, loaders and
step helpers of the JAX module come with the main-path recipes.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

from transformer4sed_tpu_torch.data.tsv import read_tsv


def load_ground_truth(tsv_path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """Events TSV -> {clip_id: [(onset, offset, label)]}; a clip whose row
    has no label is kept with no events."""
    out: Dict[str, List] = {}
    for row in read_tsv(tsv_path).rows():
        clip = os.path.splitext(str(row["filename"]))[0]
        out.setdefault(clip, [])
        label = row.get("event_label", math.nan)
        if not (isinstance(label, float) and math.isnan(label)):
            out[clip].append((float(row["onset"]), float(row["offset"]), str(label)))
    return out


def load_durations(tsv_path: str) -> Dict[str, float]:
    """Durations TSV (filename, duration) -> {clip_id: seconds}."""
    return {
        os.path.splitext(str(row["filename"]))[0]: float(row["duration"])
        for row in read_tsv(tsv_path).rows()
    }
