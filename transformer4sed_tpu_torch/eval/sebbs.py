"""Sound Event Bounding Boxes (cSEBB-style) post-processing; port of the
JAX package's ``eval/sebbs.py`` (NumPy only).

The reference depends on the ``sebbs`` package (``requirements.txt:18``)
and reports its best MAT-SED PSDS1 (0.602 vs 0.587 with median
filtering) with SEBB post-processing (``docs/mat-sed/readme.md:44``),
but never calls it from code — the dependency exists for offline
post-processing of dumped score tables. This module provides that
capability natively, following the change-point formulation of
"Sound Event Bounding Boxes" (Ebbers et al., Interspeech 2024):

1. a **step filter** response ``delta[t] = mean(s[t : t+h]) -
   mean(s[t-h : t])`` (h = half the filter length) is computed per
   class;
2. **change points** are local maxima of ``delta`` (rising steps) and
   local minima (falling steps);
3. the clip is segmented at the change points and each segment scored
   with its **mean frame score**;
4. adjacent segments are **agglomeratively merged** (most-similar pair
   first) while their scores are close — absolutely (``|a - b| <=
   merge_threshold_abs``) or relatively (``max(a, b) / min(a, b) <=
   merge_threshold_rel``) — with length-weighted score averaging;
5. the resulting (onset, offset, confidence) boxes are emitted either
   as events at a confidence threshold or as a **piecewise-constant
   score table**, which is the sed_scores_eval-compatible form: feeding
   it to :func:`~transformer4sed_tpu_torch.eval.psds.compute_psds_from_scores`
   sweeps the SEBB confidences exactly (every box survives all
   thresholds below its confidence, vanishing as a whole above it —
   the defining property of bounding-box evaluation).

Parameter provenance: there are no fixed
"published per-class DESED constants" to vendor. The upstream ``sebbs``
package ships *tuning* (``sebbs.utils.tune`` grid-searches per-class
(filter_length, merge_threshold) against PSDS on validation), and the
0.602 MAT-SED row is the product of that tune-on-val flow — which
``filter_type: sebb`` with ``sebb: auto`` reproduces here via
:func:`tune_csebbs` (grid search per class against the fast native PSDS
sweep on validation, applied unchanged to test). The static defaults
(0.48 s filter, 0.15 abs / 1.5 rel merge) are the paper's DESED
operating point and only matter when auto-tuning is disabled.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from transformer4sed_tpu_torch.eval.psds import compute_psds_from_scores
from transformer4sed_tpu_torch.eval.scores import ClipScores


@dataclass(frozen=True)
class CSEBBParams:
    """Per-class (or global) cSEBB parameters.

    step_filter_length: step-detector window in **seconds**.
    merge_threshold_abs: merge when segment scores differ by <= this.
    merge_threshold_rel: merge when max(a, b) / min(a, b) <= this.
    """

    step_filter_length: float = 0.48
    merge_threshold_abs: float = 0.15
    merge_threshold_rel: float = 1.5


ParamsLike = Union[CSEBBParams, Mapping[str, CSEBBParams], None]


def _step_filter(s: np.ndarray, half: int) -> np.ndarray:
    """delta[t] = mean(s[t:t+half]) - mean(s[t-half:t]), edge-replicated."""
    t = s.shape[0]
    p = np.concatenate([np.full(half, s[0]), s, np.full(half, s[-1])])
    c = np.concatenate([[0.0], np.cumsum(p, dtype=np.float64)])
    idx = np.arange(t)
    right = (c[idx + 2 * half] - c[idx + half]) / half
    left = (c[idx + half] - c[idx]) / half
    delta = right - left
    # cumsum float noise would otherwise fabricate local extrema on
    # perfectly flat regions
    delta[np.abs(delta) < 1e-9] = 0.0
    return delta


def _change_points(delta: np.ndarray) -> np.ndarray:
    """Indices of strict local extrema of the step response."""
    if delta.shape[0] < 3:
        return np.empty(0, dtype=np.int64)
    inner = delta[1:-1]
    lmax = (inner > delta[:-2]) & (inner >= delta[2:]) & (inner > 0)
    lmin = (inner < delta[:-2]) & (inner <= delta[2:]) & (inner < 0)
    return np.nonzero(lmax | lmin)[0] + 1


def _merge_segments(
    bounds: np.ndarray, scores: List[float], abs_thr: float, rel_thr: float
) -> Tuple[np.ndarray, List[float]]:
    """Agglomerative merging: among all adjacent pairs that satisfy the
    absolute-or-relative criterion, merge the most similar first; repeat
    until no pair qualifies."""

    def qualifies(a: float, b: float) -> bool:
        ratio = max(a, b) / max(min(a, b), 1e-12)
        return abs(a - b) <= abs_thr or ratio <= rel_thr

    bounds = list(bounds)
    scores = list(scores)
    while len(scores) > 1:
        candidates = [
            i for i in range(len(scores) - 1) if qualifies(scores[i], scores[i + 1])
        ]
        if not candidates:
            break
        i = min(candidates, key=lambda j: abs(scores[j] - scores[j + 1]))
        a, b = scores[i], scores[i + 1]
        la = bounds[i + 1] - bounds[i]
        lb = bounds[i + 2] - bounds[i + 1]
        scores[i] = (a * la + b * lb) / (la + lb)
        del scores[i + 1]
        del bounds[i + 1]
    return np.asarray(bounds), scores


def csebbs_1d(
    s: np.ndarray, frames_per_second: float, params: CSEBBParams
) -> List[Tuple[int, int, float]]:
    """cSEBBs for one class track: [(onset_frame, offset_frame_excl, conf)].

    The returned boxes partition [0, T): low-confidence background
    regions are boxes too (they fall away at any meaningful threshold).
    """
    t = s.shape[0]
    if t == 0:
        return []
    s = np.asarray(s, dtype=np.float64)
    half = max(1, int(round(params.step_filter_length * frames_per_second / 2)))
    delta = _step_filter(s, half)
    cps = _change_points(delta)
    bounds = np.concatenate([[0], cps, [t]])
    bounds = np.unique(bounds)
    seg_scores = [float(s[a:b].mean()) for a, b in zip(bounds[:-1], bounds[1:])]
    bounds, seg_scores = _merge_segments(
        bounds, seg_scores, params.merge_threshold_abs, params.merge_threshold_rel
    )
    return [
        (int(a), int(b), float(v))
        for a, b, v in zip(bounds[:-1], bounds[1:], seg_scores)
    ]


def _params_for(params: ParamsLike, cls: str) -> CSEBBParams:
    if params is None:
        return CSEBBParams()
    if isinstance(params, CSEBBParams):
        return params
    return params.get(cls, CSEBBParams())


def csebbs_clip(clip: ClipScores, params: ParamsLike = None) -> ClipScores:
    """Replace a clip's frame scores with their piecewise-constant SEBBs."""
    ts = clip.timestamps
    t = clip.scores.shape[0]
    fps = t / float(ts[-1] - ts[0]) if ts[-1] > ts[0] else 1.0
    out = np.zeros_like(clip.scores, dtype=np.float64)
    for ci, cls in enumerate(clip.event_classes):
        for a, b, v in csebbs_1d(clip.scores[:, ci], fps, _params_for(params, cls)):
            out[a:b, ci] = v
    return ClipScores(out, ts, clip.event_classes)


def apply_csebbs(
    scores: Dict[str, ClipScores], params: ParamsLike = None
) -> Dict[str, ClipScores]:
    """cSEBB post-process a whole {clip_id: ClipScores} score set."""
    return {k: csebbs_clip(v, params) for k, v in scores.items()}


def sebbs_to_events(
    clip: ClipScores, threshold: float, params: ParamsLike = None
) -> List[Tuple[str, float, float, float]]:
    """Detected events [(label, onset_s, offset_s, confidence)] at a threshold.

    Adjacent surviving boxes merge into one event (confidence = max).
    """
    ts = clip.timestamps
    t = clip.scores.shape[0]
    fps = t / float(ts[-1] - ts[0]) if ts[-1] > ts[0] else 1.0
    events: List[Tuple[str, float, float, float]] = []
    for ci, cls in enumerate(clip.event_classes):
        boxes = csebbs_1d(clip.scores[:, ci], fps, _params_for(params, cls))
        run: Optional[List[float]] = None  # [on_frame, off_frame, conf]
        for a, b, v in boxes + [(t, t, -np.inf)]:
            if v >= threshold and run is not None and a == run[1]:
                run[1], run[2] = b, max(run[2], v)
            else:
                if run is not None:
                    events.append((cls, float(ts[int(run[0])]), float(ts[int(run[1])]), run[2]))
                run = [a, b, v] if v >= threshold else None
    return events


def tune_csebbs(
    scores: Dict[str, ClipScores],
    ground_truth,
    audio_durations,
    step_filter_lengths: Sequence[float] = (0.32, 0.48, 0.64),
    merge_thresholds_abs: Sequence[float] = (0.1, 0.15, 0.2),
    merge_thresholds_rel: Sequence[float] = (1.5, 2.0, 3.0),
    per_class: bool = True,
    **psds_kwargs,
) -> Tuple[ParamsLike, float]:
    """Grid-search cSEBB parameters against PSDS on a validation set.

    Mirrors ``sebbs.tune``: a joint grid over the three parameters; with
    ``per_class=True`` the best parameter set is picked per class from
    the per-class PSDS of each grid point (the classes are independent
    under intersection-based PSDS up to the cross-trigger term).
    Returns (params, best_global_psds_achieved_during_search).
    """
    psds_kwargs.setdefault("dtc_threshold", 0.7)
    psds_kwargs.setdefault("gtc_threshold", 0.7)
    psds_kwargs.setdefault("alpha_st", 1.0)

    grid = [
        CSEBBParams(l, a, r)
        for l, a, r in itertools.product(
            step_filter_lengths, merge_thresholds_abs, merge_thresholds_rel
        )
    ]
    best_global: Tuple[float, CSEBBParams] = (-1.0, grid[0])
    best_per_class: Dict[str, Tuple[float, CSEBBParams]] = {}
    for p in grid:
        post = apply_csebbs(scores, p)
        value, single = compute_psds_from_scores(
            post, ground_truth, audio_durations, **psds_kwargs
        )
        if value > best_global[0]:
            best_global = (value, p)
        for cls, v in single.items():
            if v > best_per_class.get(cls, (-1.0, p))[0]:
                best_per_class[cls] = (v, p)
    if per_class and best_per_class:
        return {c: p for c, (_, p) in best_per_class.items()}, best_global[0]
    return best_global[1], best_global[0]
