"""Score containers: per-clip frame-score matrices with timestamps.

Port of the JAX package's ``eval/scores.py`` (NumPy only). A plain-array
stand-in for sed_scores_eval's score DataFrames (the reference builds one
per clip in ``src/codec/decoder.py:82-99``): a [T, C] float matrix plus
T+1 frame-boundary timestamps and the class list. Also the MAESTRO-style
overlap-add of sliding-window clip scores into long-file segment scores
(``src/codec/decoder.py:138-230``). The JAX ``to_dataframe`` needs pandas,
which the card's machine lacks: :meth:`ClipScores.to_tsv` writes the same
table through the port's TSV writer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from transformer4sed_tpu_torch.data.tsv import write_tsv


@dataclass
class ClipScores:
    scores: np.ndarray  # [T, C]
    timestamps: np.ndarray  # [T + 1] seconds
    event_classes: Tuple[str, ...]

    def __post_init__(self):
        self.scores = np.asarray(self.scores)
        self.timestamps = np.asarray(self.timestamps, dtype=np.float64)
        self.event_classes = tuple(self.event_classes)
        t, c = self.scores.shape if self.scores.ndim == 2 else (-1, -1)
        if t < 0 or len(self.timestamps) != t + 1 or c != len(self.event_classes):
            raise ValueError(
                f"scores {self.scores.shape}, {len(self.timestamps)} timestamps and "
                f"{len(self.event_classes)} classes do not make a [T, C] table"
            )

    def to_tsv(self, path: str) -> None:
        """Write the sed_scores_eval-layout table (onset, offset, *classes),
        as the JAX ``to_dataframe().to_csv(path, sep="\\t", index=False)``."""
        table = np.concatenate(
            [self.timestamps[:-1, None], self.timestamps[1:, None], self.scores], axis=1
        )
        write_tsv(path, ["onset", "offset", *self.event_classes], table)


def get_segment_scores(
    clip: ClipScores, clip_length: float, segment_length: float = 1.0
) -> ClipScores:
    """Duration-weighted average of frame scores into fixed-length segments
    (reference ``get_segment_scores``, ``decoder.py:193-230``)."""
    ts = clip.timestamps
    arr = clip.scores
    seg_scores = []
    seg_ts = []
    on_idx = 0
    off_idx = 0
    for seg_onset in np.arange(0.0, clip_length, segment_length):
        seg_offset = seg_onset + segment_length
        while ts[on_idx + 1] <= seg_onset:
            on_idx += 1
        while off_idx < len(arr) and ts[off_idx] < seg_offset:
            off_idx += 1
        weights = np.minimum(ts[on_idx + 1 : off_idx + 1], seg_offset) - np.maximum(
            ts[on_idx:off_idx], seg_onset
        )
        seg_scores.append((weights[:, None] * arr[on_idx:off_idx]).sum(0) / weights.sum())
        seg_ts.append(seg_onset)
    seg_ts.append(clip_length)
    return ClipScores(np.array(seg_scores), np.array(seg_ts), clip.event_classes)


def segment_scores_overlap_add(
    frame_scores: Dict[str, ClipScores],
    audio_durations: Dict[str, float],
    event_classes: Sequence[str],
    segment_length: float = 1.0,
) -> Dict[str, ClipScores]:
    """Overlap-add sliding-window clip scores into per-file segment scores.

    Clip ids are ``{file_id}-{onset_cs}-{offset_cs}`` (centiseconds), as
    produced by the AudioSet/MAESTRO recipes
    (``src/codec/decoder.py:138-190``).
    """
    event_classes = tuple(event_classes)
    acc: Dict[str, np.ndarray] = {}
    cnt: Dict[str, np.ndarray] = {}
    for clip_id, clip in frame_scores.items():
        file_id, clip_on, clip_off = clip_id.rsplit("-", maxsplit=2)
        clip_on = float(clip_on) / 100
        clip_off = float(clip_off) / 100
        if file_id not in acc:
            n_seg = math.ceil(audio_durations[file_id] / segment_length)
            acc[file_id] = np.zeros((n_seg, len(event_classes)))
            cnt[file_id] = np.zeros_like(acc[file_id])
        seg = get_segment_scores(
            clip, clip_length=clip_off - clip_on, segment_length=segment_length
        ).scores
        idx = int(clip_on // segment_length)
        acc[file_id][idx : idx + len(seg)] += seg
        cnt[file_id][idx : idx + len(seg)] += 1

    out = {}
    for file_id in acc:
        dur = audio_durations[file_id]
        ts = np.minimum(np.arange(0.0, dur + segment_length, segment_length), dur)
        out[file_id] = ClipScores(
            acc[file_id] / np.maximum(cnt[file_id], 1), ts, event_classes
        )
    return out


def merge_maestro_ground_truth(
    clip_ground_truth: Dict[str, List[Tuple[float, float, str]]]
) -> Dict[str, List[List]]:
    """Merge MAESTRO clip-level ground truth into file-level events
    (reference ``merge_maestro_ground_truth``, ``decoder.py:106-116``).

    Clip ids are ``<file_id>-<onset_cs>-<offset_cs>`` (centiseconds);
    each clip's events are shifted by the clip onset and per-class
    overlaps merged.
    """
    ground_truth: Dict[str, List[Tuple[float, float, str]]] = {}
    for clip_id, events in clip_ground_truth.items():
        file_id, clip_onset, _ = clip_id.rsplit("-", maxsplit=2)
        onset = int(clip_onset) // 100
        ground_truth.setdefault(file_id, []).extend(
            (onset + ev_on, onset + ev_off, ev_cls) for ev_on, ev_off, ev_cls in events
        )
    return merge_overlapping_events(ground_truth)


def merge_overlapping_events(
    ground_truth_events: Dict[str, List[Tuple[float, float, str]]]
) -> Dict[str, List[List]]:
    """Merge per-class overlapping (onset, offset, label) events in place
    (reference ``merge_overlapping_events``, ``decoder.py:118-135``)."""
    for clip_id, events in ground_truth_events.items():
        per_class: Dict[str, list] = {}
        for event in events:
            per_class.setdefault(event[2], []).append(event)
        merged_all = []
        for cls, evs in per_class.items():
            evs = sorted(evs)
            merged = []
            current_offset = -1e6
            for ev in evs:
                if ev[0] > current_offset:
                    merged.append(list(ev))
                else:
                    merged[-1][1] = max(current_offset, ev[1])
                current_offset = merged[-1][1]
            merged_all.extend(merged)
        ground_truth_events[clip_id] = merged_all
    return ground_truth_events
