"""Label codec: time <-> frame conversion and strong/weak label tensors.

Copy of ``transformer4sed_tpu/core/codec.py`` (NumPy only), kept here so
the port never imports the JAX package. Semantics match the reference
encoder (``src/codec/encoder.py:7-84`` in cai525/Transformer4SED): a
clip of ``audio_len`` seconds at sample rate ``sr`` maps to
``n_frames = ceil(n_samples / 2 / frame_hop) * 2 / net_pooling``
frames; events are rasterised with ``round`` on the onset frame and
``ceil`` on the offset frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class LabelCodec:
    """Bidirectional event-list <-> frame-grid codec.

    Args:
      labels: ordered class names.
      audio_len: clip length in seconds.
      frame_len: analysis window length in samples (kept for config parity).
      frame_hop: hop size in samples.
      net_pooling: model's temporal pooling ratio relative to the frame grid.
      sr: sample rate in Hz.
    """

    labels: Tuple[str, ...]
    audio_len: float
    frame_len: int
    frame_hop: int
    net_pooling: int = 1
    sr: int = 16000
    n_frames: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "labels", tuple(self.labels))
        n_samples = self.audio_len * self.sr
        n_frames = int(math.ceil(n_samples / 2 / self.frame_hop) * 2 / self.net_pooling)
        object.__setattr__(self, "n_frames", n_frames)

    @property
    def n_classes(self) -> int:
        return len(self.labels)

    def time_to_frame(self, time):
        frame = np.asarray(time) * self.sr / self.frame_hop
        return np.clip(frame / self.net_pooling, a_min=0, a_max=self.n_frames)

    def frame_to_time(self, frame):
        time = np.asarray(frame) * self.net_pooling * self.frame_hop / self.sr
        return np.clip(time, a_min=0, a_max=self.audio_len)

    def encode_strong(self, events: Sequence[Tuple[str, float, float]]) -> np.ndarray:
        """Events ``(label, onset_sec, offset_sec)`` -> ``[n_frames, C]`` 0/1 grid."""
        grid = np.zeros((self.n_frames, self.n_classes), dtype=np.float32)
        for label, onset, offset in events:
            if label is None or (isinstance(label, float) and math.isnan(label)):
                continue
            idx = self.labels.index(label)
            on = int(round(float(self.time_to_frame(onset))))
            off = int(round(np.ceil(self.time_to_frame(offset))))
            grid[on:off, idx] = 1.0
        return grid

    def encode_weak(self, present: Sequence[str]) -> np.ndarray:
        """Class-name list -> ``[C]`` multi-hot vector."""
        vec = np.zeros((self.n_classes,), dtype=np.float32)
        for label in present:
            vec[self.labels.index(label)] = 1.0
        return vec

    def decode_strong(self, outputs: np.ndarray) -> List[List]:
        """Binary frame grid ``[n_frames, C]`` -> list of [label, onset, offset]."""
        outputs = np.asarray(outputs)
        pred = []
        for i, column in enumerate(outputs.T):
            for on_f, off_f in find_contiguous_regions(column):
                onset = float(np.clip(self.frame_to_time(on_f), 0, self.audio_len))
                offset = float(np.clip(self.frame_to_time(off_f), 0, self.audio_len))
                pred.append([self.labels[i], onset, offset])
        return pred

    def decode_weak(self, outputs: np.ndarray) -> List[str]:
        return [self.labels[i] for i, v in enumerate(np.asarray(outputs)) if v == 1]


def find_contiguous_regions(array: np.ndarray) -> np.ndarray:
    """Return ``[k, 2]`` array of (start, stop) indices of truthy runs."""
    array = np.asarray(array).astype(bool)
    change = np.logical_xor(array[1:], array[:-1]).nonzero()[0] + 1
    if array.size and array[0]:
        change = np.r_[0, change]
    if array.size and array[-1]:
        change = np.r_[change, array.size]
    return change.reshape((-1, 2))
