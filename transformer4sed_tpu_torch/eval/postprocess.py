"""Offline post-processing: score containers for event-wise reload /
averaging, and weighted multi-model score ensembling; port of the JAX
package's ``eval/postprocess.py``, with the port's TSV reader and writer
(``data/tsv.py``) in place of pandas.

Parity targets: ``src/postprocess/score.py:7-91`` (Score /
ScoreContainer / score_average) and ``src/postprocess/ensemble.py:33-77``
(weighted average of per-model TSV score tables with linear time
interpolation to the longest table). Containers here wrap
:class:`~transformer4sed_tpu_torch.eval.scores.ClipScores` instead of pandas
frames; TSV IO helpers are provided for the on-disk ensemble workflow.
"""

from __future__ import annotations

import copy
import os
from glob import glob
from typing import Dict, List, Sequence

import numpy as np

from transformer4sed_tpu_torch.data.tsv import read_tsv, write_tsv
from transformer4sed_tpu_torch.eval.scores import ClipScores


class ScoreContainer:
    """Per-file frame-score tables with per-class reload/average ops."""

    def __init__(self, events: Sequence[str], score_buffer: Dict[str, ClipScores] = None):
        self.events = tuple(events)
        self.scores: Dict[str, ClipScores] = {}
        if score_buffer:
            for f, clip in score_buffer.items():
                if not set(self.events) <= set(clip.event_classes):
                    raise ValueError(f"missing events in {f}")
                self.scores[f] = clip

    @property
    def files(self) -> List[str]:
        return list(self.scores)

    def __len__(self):
        return len(self.scores)

    def _col(self, clip: ClipScores, event: str) -> int:
        return clip.event_classes.index(event)

    def reload_events(self, reload_events: Sequence[str], other: "ScoreContainer"):
        """Overwrite the listed classes' scores from another container."""
        for f, clip in other.scores.items():
            mine = self.scores[f]
            if len(mine.scores) != len(clip.scores):
                raise ValueError(f"{f}: {len(mine.scores)} frames against {len(clip.scores)}")
            for ev in reload_events:
                mine.scores[:, self._col(mine, ev)] = clip.scores[:, self._col(clip, ev)]

    def average_events(
        self, reload_events: Sequence[str], others: List["ScoreContainer"]
    ) -> "ScoreContainer":
        """Average the listed classes' scores with other containers."""
        res = copy.deepcopy(self)
        for f in res.files:
            mine = res.scores[f]
            for ev in reload_events:
                col = self._col(mine, ev)
                acc = mine.scores[:, col].copy()
                for other in others:
                    acc = acc + other.scores[f].scores[:, self._col(other.scores[f], ev)]
                mine.scores[:, col] = acc / (1 + len(others))
        return res


def score_average(events: Sequence[str], containers: List[ScoreContainer]) -> ScoreContainer:
    if len(containers) == 1:
        return copy.deepcopy(containers[0])
    return containers[0].average_events(events, containers[1:])


# -- TSV score-table ensemble -----------------------------------------------------

def _interp_to_length(table: np.ndarray, target_len: int) -> np.ndarray:
    """Linearly resample score columns to ``target_len`` rows."""
    t = table.shape[0]
    if t == target_len:
        return table
    src = (np.arange(t) + 0.5) / t
    dst = (np.arange(target_len) + 0.5) / target_len
    out = np.stack([np.interp(dst, src, table[:, c]) for c in range(table.shape[1])], axis=1)
    return out


def weighted_average_ensemble(
    predictions: Dict[str, List[np.ndarray]], weights: Sequence[float]
) -> Dict[str, np.ndarray]:
    """Per-file weighted average of [T, 2+C] score tables (onset, offset,
    classes); shorter tables are time-interpolated to the longest and
    borrow its timestamps (reference ``ensemble.py:33-55``)."""
    weights = np.asarray(weights, dtype=np.float64)
    out = {}
    for f, tables in predictions.items():
        max_t = max(t.shape[0] for t in tables)
        ref_idx = [i for i, t in enumerate(tables) if t.shape[0] == max_t][0]
        aligned = []
        for t in tables:
            a = _interp_to_length(np.asarray(t, np.float64), max_t)
            a[:, :2] = tables[ref_idx][:, :2]
            aligned.append(a)
        stacked = np.asarray(aligned)
        avg = np.tensordot(stacked, weights, axes=(0, 0)) / weights.sum()
        out[f] = np.round(avg, 4)
    return out


def load_score_tables(folders: Sequence[str]) -> Dict[str, List[np.ndarray]]:
    """Load per-model TSV score folders into {filename: [tables...]}."""
    if not folders:
        raise ValueError("load_score_tables: no score folders given")
    per_folder = {
        folder: sorted(glob(os.path.join(folder, "*.tsv"))) for folder in folders
    }
    name_sets = {f: {os.path.basename(p) for p in paths} for f, paths in per_folder.items()}
    ref_names = name_sets[folders[0]]
    for folder, names in name_sets.items():
        # mismatched file sets fail loudly (reference ensemble.py:14-19
        # raises on any subfolder with a different set); silently
        # intersecting would ensemble a partial — or empty — set
        if names != ref_names:
            diff = sorted(names ^ ref_names)[:5]
            raise ValueError(
                f"score folder {folder!r} holds a different TSV set than "
                f"{folders[0]!r} (e.g. {diff}); every model folder must "
                "contain the same clip files"
            )
    if not ref_names:
        raise ValueError(f"no .tsv score tables found under {folders[0]!r}")
    predictions: Dict[str, List[np.ndarray]] = {}
    for folder in folders:
        for path in per_folder[folder]:
            predictions.setdefault(os.path.basename(path), []).append(
                read_tsv(path).to_numpy(dtype=np.float64)
            )
    return predictions


def ensemble(root: str, output_dir: str, model_list: Sequence[str], weights: Sequence[float],
             columns: Sequence[str]) -> None:
    """Offline ensemble: per-model TSV subfolders -> weighted-average TSVs.
    Weights are normalised to sum to 1 (the average divides by their sum
    anyway, so unnormalised inputs are fine)."""
    if len(weights) != len(model_list):
        raise ValueError(f"{len(model_list)} models but {len(weights)} weights")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("ensemble weights must sum to a positive value")
    weights = [w / total for w in weights]
    predictions = load_score_tables([os.path.join(root, m) for m in model_list])
    merged = weighted_average_ensemble(predictions, weights)
    os.makedirs(output_dir, exist_ok=True)
    for name, table in merged.items():
        write_tsv(os.path.join(output_dir, name), list(columns), table)


def main(argv=None):
    """CLI: weighted-average ensemble of per-model score-TSV folders
    (the reference's ``src/postprocess/ensemble.py`` __main__ demo as a
    real command)::

        python -m transformer4sed_tpu_torch.eval.postprocess \
            --root scores/ --models m1 m2 --weights 0.6 0.4 \
            --out ensemble/ --columns onset offset dog cat
    """
    import argparse

    parser = argparse.ArgumentParser(description="offline score ensembling")
    parser.add_argument("--root", required=True, help="dir containing per-model subfolders of TSVs")
    parser.add_argument("--models", nargs="+", required=True)
    parser.add_argument("--weights", nargs="+", type=float, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--columns", nargs="+", required=True,
                        help="output header: onset offset <class...>")
    args = parser.parse_args(argv)
    ensemble(args.root, args.out, args.models, args.weights, args.columns)
    print(f"wrote ensembled TSVs to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
