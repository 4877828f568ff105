"""Waveform padding to the codec's clip length, with its frame pad mask.

Port of ``pad_wav`` from ``transformer4sed_tpu/data/audio_io.py``
(reference ``src/preprocess/feats_extraction.py:7-38``). Decoding and
resampling come with the data slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def pad_wav(wav: np.ndarray, pad_to: int, codec) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad or truncate to ``pad_to`` samples; return (wav, pad_mask).

    pad_mask: [codec.n_frames] bool, True where the frame is padding.
    """
    if len(wav) < pad_to:
        pad_from = len(wav)
        wav = np.pad(wav, (0, pad_to - len(wav)), mode="constant")
    else:
        wav = wav[:pad_to]
        pad_from = pad_to
    pad_idx = math.ceil(float(codec.time_to_frame(pad_from / codec.sr)))
    pad_mask = np.arange(codec.n_frames) >= pad_idx
    return wav.astype(np.float32), pad_mask
