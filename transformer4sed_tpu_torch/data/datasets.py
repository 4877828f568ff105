"""TSV-driven map-style datasets producing fixed-shape numpy samples.

Port of the JAX package's ``data/datasets.py``: the datasets take the
port's TSV tables (``data/tsv.py:read_tsv``) where the JAX ones take pandas
DataFrames. Same data contract as the reference datasets
(``src/preprocess/dataset.py:15-230``): every sample is
``{wav [S], label [C, T], pad_mask [T], idx, filename, path}``:

  * strong: events TSV (filename/onset/offset/event_label) -> 0/1 grid;
  * weak: clip tags TSV (filename/event_labels comma list) -> the tag
    vector stored in label[:, 0] (the reference convention — trainers
    recover it with ``label.sum(-1)``);
  * unlabeled: a directory glob of wavs, all-zero labels;
  * frame-wise: one TSV per clip with per-frame soft labels (PMAM
    pseudo-labels, columns [onset offset class...]).

A dataset item decodes its file alone (``__getitem__``); :func:`load_samples`
decodes the files of a whole batch in one call of
``data/audio_io.py:load_wav_batch`` (``data/loader.py:DataLoader``), from
each item's :meth:`entry`.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.data.audio_io import load_wav_batch, waveform_modification
from transformer4sed_tpu_torch.data.tsv import Table, read_tsv


class _ClipDataset:
    codec: LabelCodec
    return_name: bool

    def __len__(self):
        return len(self.clip_list)

    @property
    def pad_to(self) -> int:
        return int(self.codec.audio_len * self.codec.sr)

    def __getitem__(self, idx: int) -> Dict:
        path, filename, label = self.entry(idx)
        wav, pad_mask = waveform_modification(path, self.pad_to, self.codec)
        return self._sample(idx, path, filename, label, wav, pad_mask)

    def _sample(self, idx: int, path: str, filename: str, label: np.ndarray, wav: np.ndarray,
                pad_mask: np.ndarray) -> Dict:
        out = {"wav": wav, "label": label.astype(np.float32), "pad_mask": pad_mask, "idx": idx}
        if self.return_name:
            out["filename"] = filename
            out["path"] = path
        return out


def load_samples(items: Sequence, n_threads: int = 8) -> List[Dict]:
    """The samples of ``items``, (dataset, index) pairs of datasets sharing
    one codec, with every file decoded in one ``load_wav_batch`` call."""
    if not items:
        return []
    entries = [ds.entry(i) for ds, i in items]
    first = items[0][0]
    wavs, masks = load_wav_batch([path for path, _, _ in entries], first.pad_to, first.codec,
                                 n_threads=n_threads)
    return [ds._sample(i, path, name, label, wav, mask)
            for (ds, i), (path, name, label), wav, mask in zip(items, entries, wavs, masks)]


class StronglyLabeledDataset(_ClipDataset):
    def __init__(self, tsv: Table, dataset_dir: str, return_name: bool, codec: LabelCodec):
        self.codec = codec
        self.return_name = return_name
        self.clips = {}
        for filename, group in tsv.groupby("filename"):
            events = [(row["event_label"], row["onset"], row["offset"]) for row in group.rows()]
            self.clips[filename] = {
                "path": os.path.join(dataset_dir, filename),
                "events": events,
            }
        self.clip_list = list(self.clips)

    def entry(self, idx: int):
        filename = self.clip_list[idx]
        clip = self.clips[filename]
        label = self.codec.encode_strong(clip["events"]).T  # [C, T]
        return clip["path"], filename, label


class WeaklyLabeledDataset(_ClipDataset):
    def __init__(self, tsv: Table, dataset_dir: str, return_name: bool, codec: LabelCodec):
        self.codec = codec
        self.return_name = return_name
        self.clips = {}
        for row in tsv.rows():
            if row["filename"] not in self.clips:
                self.clips[row["filename"]] = {
                    "path": os.path.join(dataset_dir, row["filename"]),
                    "events": [e for e in str(row["event_labels"]).split(",") if e],
                }
        self.clip_list = list(self.clips)

    def entry(self, idx: int):
        filename = self.clip_list[idx]
        clip = self.clips[filename]
        label = np.zeros((self.codec.n_classes, self.codec.n_frames), dtype=np.float32)
        if clip["events"]:
            label[:, 0] = self.codec.encode_weak(clip["events"])
        return clip["path"], filename, label


class UnlabeledDataset(_ClipDataset):
    def __init__(self, dataset_dir: str, return_name: bool, codec: LabelCodec):
        self.codec = codec
        self.return_name = return_name
        self.clip_list = sorted(glob(os.path.join(dataset_dir, "*.wav")))

    def entry(self, idx: int):
        path = self.clip_list[idx]
        label = np.zeros((self.codec.n_classes, self.codec.n_frames), dtype=np.float32)
        return path, os.path.basename(path), label


class FrameWiseLabeledDataset(_ClipDataset):
    """Per-clip TSVs of frame-level soft labels (PMAM pseudo-labels)."""

    def __init__(self, tsv_dir: str, dataset_dir: str, return_name: bool, codec: LabelCodec):
        self.codec = codec
        self.return_name = return_name
        self.clip_list = []
        self._labels: List[np.ndarray] = []
        for tsv_name in sorted(os.listdir(tsv_dir)):
            if not tsv_name.endswith(".tsv"):
                continue
            wav_path = os.path.join(dataset_dir, tsv_name.replace(".tsv", ".wav"))
            table = read_tsv(os.path.join(tsv_dir, tsv_name)).to_numpy()
            self.clip_list.append(wav_path)
            self._labels.append(table[:, 2:].T.astype(np.float32))  # [C, T]

    def entry(self, idx: int):
        path = self.clip_list[idx]
        return path, os.path.basename(path), self._labels[idx]
