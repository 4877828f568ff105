"""PMAM pseudo-labels: GMM posteriors per frame -> per-clip TSVs (port of
``pmam/pseudo_labels.py``).

Reference: ``recipes/desed/pmam/generate_pseudo_label.py:93-215``. The frozen
network's tapped frame features go through ``predict_proba`` and are written
per clip at the label frame rate (100 Hz: onset and offset columns, then one
probability column per prototype), the layout ``data/datasets.py:
FrameWiseLabeledDataset`` reads. The port goes batch by batch (forward, tap,
posteriors on the card, TSVs), where the JAX stage first holds every mel of
the split; the files written are the same.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from transformer4sed_tpu_torch.models.mlm import MLMDraws


def frame_probs_to_tsv(path: str, probs: np.ndarray, label_sr: float = 100.0) -> None:
    """Write [T, K] frame posteriors as onset/offset + prototype columns
    (``%.6f``, the JAX layout byte for byte)."""
    t, k = probs.shape
    interval = 1.0 / label_sr
    onset = np.arange(t) * interval
    offset = onset + interval
    header = "onset\toffset\t" + "\t".join(f"proto_{i}" for i in range(k))
    table = np.concatenate([onset[:, None], offset[:, None], probs], axis=1)
    np.savetxt(path, table, delimiter="\t", header=header, comments="", fmt="%.6f")


@torch.no_grad()
def generate_pseudo_labels(model, gmm, batches: Iterable[Tuple[torch.Tensor, Sequence[str]]],
                           out_dir: str, feature_layer: str = "transformer_0",
                           label_sr: float = 100.0, generator: Optional[torch.Generator] = None,
                           mlm_draws: Optional[Sequence[MLMDraws]] = None) -> int:
    """For each (mel [B, F, T], filenames) batch: the model's tap (eval mode;
    batch i's mask from ``generator`` or ``mlm_draws[i]``), the GMM's
    posteriors, one TSV per clip named after its file. Returns the number of
    clips written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for i, (mel, filenames) in enumerate(batches):
        feats = model.tap(mel, feature_layer, generator,
                          None if mlm_draws is None else mlm_draws[i])
        b, t, c = feats.shape
        probs = gmm.predict_proba(feats.reshape(-1, c).float()).reshape(b, t, -1)
        probs = probs.cpu().numpy()
        for j, name in enumerate(filenames):
            stem = os.path.splitext(os.path.basename(name))[0]
            frame_probs_to_tsv(os.path.join(out_dir, f"{stem}.tsv"), probs[j], label_sr)
            count += 1
    return count
