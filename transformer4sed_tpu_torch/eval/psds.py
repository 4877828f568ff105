"""Polyphonic Sound Detection Score (PSDS), port of the JAX package's
``eval/psds.py`` (NumPy and the C++ sweep of ``native/psds_core.cpp``).

Intersection-based PSDS (Bilen et al., 2020, arXiv:1910.08440) from
frame-score containers, in place of the reference's sed_scores_eval /
psds_eval (``src/evaluation_measures.py:299-341``):

  * DTC: a detection is valid when >= dtc of its duration intersects
    same-class ground truth; invalid detections are FPs;
  * GTC: a ground-truth event is a TP when >= gtc of its duration is
    covered by DTC-valid detections;
  * CTTC: an FP detection cross-triggers a ground-truth event of
    another class when it covers >= cttc of that event;
  * per class: TPR = TP/N, eFPR = FP/dataset-hours + alpha_ct * mean
    cross-trigger rate; PSD-ROC = staircase max; effective TPR =
    mu - alpha_st * sigma across classes; PSDS = normalised AUC up to
    max_efpr.

Each class is swept by the native library at every observed score value
(sed_scores_eval's exact curves) where it builds; else by the NumPy
operating-point loop over up to ``max_thresholds`` quantiles of the class's
scores (every unique value when there are no more). ``SWEEPS`` counts the
class sweeps each path ran. The JAX module hands the whole computation to
``sed_scores_eval`` when that package is importable; the port does not:
neither machine has it, and it needs pandas, which the card's machine lacks.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from transformer4sed_tpu_torch.eval.scores import ClipScores
from transformer4sed_tpu_torch.native.build import load_psds_core

# class sweeps run by each path, "native" and "numpy"
SWEEPS: collections.Counter = collections.Counter()

GroundTruth = Mapping[str, Sequence[Tuple[float, float, str]]]  # clip -> (on, off, label)


@dataclass
class PSDSResult:
    value: float
    single_class_psds: Dict[str, float]
    efpr_grid: np.ndarray
    etpr: np.ndarray
    per_class_rocs: Dict[str, Tuple[np.ndarray, np.ndarray]]


def _intervals_from_binary(binary: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
    """[T] bool -> [k, 2] (onset, offset) seconds."""
    b = np.asarray(binary, dtype=bool)
    if not b.any():
        return np.zeros((0, 2))
    change = np.flatnonzero(np.diff(b.astype(np.int8)))
    starts = np.r_[0, change + 1][np.r_[b[0], b[change + 1]]]
    stops_idx = np.r_[change, len(b) - 1]
    stops = stops_idx[b[stops_idx]] + 1
    return np.stack([timestamps[starts], timestamps[stops]], axis=1)


def _intersection(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Pairwise intersection durations: [n_det, n_gt]."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lo = np.maximum(dets[:, None, 0], gts[None, :, 0])
    hi = np.minimum(dets[:, None, 1], gts[None, :, 1])
    return np.maximum(hi - lo, 0.0)


def _merged_coverage(intervals: np.ndarray, target: Tuple[float, float]) -> float:
    """Duration of ``target`` covered by the union of ``intervals``."""
    on, off = target
    if len(intervals) == 0:
        return 0.0
    clipped = np.clip(intervals, on, off)
    order = np.argsort(clipped[:, 0])
    covered = 0.0
    cur_end = on
    for a, b in clipped[order]:
        if b <= cur_end:
            continue
        covered += b - max(a, cur_end)
        cur_end = b
    return covered


def evaluate_operating_point(
    detections: Dict[str, Dict[str, np.ndarray]],  # clip -> class -> [k, 2]
    gt_by_clip_class: Dict[str, Dict[str, np.ndarray]],
    classes: Sequence[str],
    dtc_threshold: float,
    gtc_threshold: float,
    cttc_threshold: float,
) -> Tuple[Dict[str, int], Dict[str, int], Dict[str, Dict[str, int]]]:
    """One OP -> (TP per class, FP per class, cross-trigger counts [c][c_hat])."""
    tp = {c: 0 for c in classes}
    fp = {c: 0 for c in classes}
    ct = {c: {c2: 0 for c2 in classes} for c in classes}

    for clip_id, per_class in detections.items():
        gts_all = gt_by_clip_class.get(clip_id, {})
        for c, dets in per_class.items():
            if len(dets) == 0:
                continue
            gts = gts_all.get(c, np.zeros((0, 2)))
            inter = _intersection(dets, gts)
            det_dur = dets[:, 1] - dets[:, 0]
            dtc_ratio = inter.sum(axis=1) / np.maximum(det_dur, 1e-12)
            valid = dtc_ratio >= dtc_threshold
            fp[c] += int((~valid).sum())
            # GTC on union coverage by valid detections
            vdets = dets[valid]
            for gi, (g_on, g_off) in enumerate(gts):
                cov = _merged_coverage(vdets, (g_on, g_off))
                if cov / max(g_off - g_on, 1e-12) >= gtc_threshold:
                    tp[c] += 1
            # CTTC: FP detections vs other-class ground truths
            fdets = dets[~valid]
            if len(fdets):
                for c2, gts2 in gts_all.items():
                    if c2 == c or len(gts2) == 0:
                        continue
                    inter2 = _intersection(fdets, gts2)
                    gt_dur2 = gts2[:, 1] - gts2[:, 0]
                    # a gt of c2 is cross-triggered if covered >= cttc by some FP det
                    hit = (inter2 / np.maximum(gt_dur2[None, :], 1e-12)) >= cttc_threshold
                    ct[c][c2] += int(hit.any(axis=0).sum())
    return tp, fp, ct


def _native_sweeper(scores, gt_by_clip_class, classes):
    """Build a per-class threshold-sweep closure over the C++ core
    (``native/psds_core.cpp``), or None when the library is unavailable.
    Arrays are flattened once; the classes are swept one after another."""
    lib = load_psds_core()
    if lib is None:
        return None
    import ctypes

    clip_ids = list(scores)
    n_classes = len(classes)
    score_off = np.zeros(len(clip_ids) + 1, np.int64)
    stamp_off = np.zeros(len(clip_ids) + 1, np.int64)
    for i, cid in enumerate(clip_ids):
        score_off[i + 1] = score_off[i] + scores[cid].scores.shape[0]
        stamp_off[i + 1] = stamp_off[i] + len(scores[cid].timestamps)
    stamps = np.concatenate([scores[c].timestamps for c in clip_ids]).astype(np.float64)
    score_mat = np.concatenate([scores[c].scores for c in clip_ids]).astype(np.float32)
    # [n_total_frames, C], per-class columns taken contiguously on demand

    gt_rows: List[np.ndarray] = []
    gt_off = np.zeros(len(clip_ids) * n_classes + 1, np.int64)
    pos = 0
    for i, cid in enumerate(clip_ids):
        per = gt_by_clip_class.get(cid, {})
        for j, c in enumerate(classes):
            rows = per.get(c)
            if rows is not None and len(rows):
                gt_rows.append(np.asarray(rows, np.float64).reshape(-1, 2))
                pos += len(gt_rows[-1])
            gt_off[i * n_classes + j + 1] = pos
    gt_flat = (
        np.concatenate(gt_rows, axis=0) if gt_rows else np.zeros((0, 2))
    ).astype(np.float64)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    def sweep(ci, thresholds, dtc, gtc, cttc, compute_ct):
        col = np.ascontiguousarray(score_mat[:, ci], np.float32)
        thr = np.ascontiguousarray(thresholds, np.float64)
        tp = np.zeros(len(thr), np.int64)
        fp = np.zeros(len(thr), np.int64)
        ct = np.zeros((len(thr), n_classes), np.int64)
        lib.psds_class_sweep(
            ptr(col, ctypes.c_float), ptr(score_off, ctypes.c_int64),
            ptr(stamps, ctypes.c_double), ptr(stamp_off, ctypes.c_int64),
            len(clip_ids),
            ptr(gt_flat, ctypes.c_double), ptr(gt_off, ctypes.c_int64),
            n_classes, ci,
            ptr(thr, ctypes.c_double), len(thr),
            float(dtc), float(gtc), float(cttc), int(bool(compute_ct)),
            ptr(tp, ctypes.c_int64), ptr(fp, ctypes.c_int64),
            ptr(ct, ctypes.c_int64),
        )
        return tp, fp, ct

    def exact(ci, gt_dur_hours, dtc, gtc, cttc, compute_ct):
        """Exact per-class curves at EVERY observed score value
        (sed_scores_eval semantics): returns (thr, tp, fp, ctr) arrays."""
        col = np.ascontiguousarray(score_mat[:, ci], np.float32)
        cap = int(score_off[-1])
        thr = np.zeros(cap, np.float64)
        tp = np.zeros(cap, np.int64)
        fp = np.zeros(cap, np.int64)
        ctr = np.zeros(cap, np.float64)
        durs = np.ascontiguousarray(gt_dur_hours, np.float64)
        n = lib.psds_class_exact(
            ptr(col, ctypes.c_float), ptr(score_off, ctypes.c_int64),
            ptr(stamps, ctypes.c_double), ptr(stamp_off, ctypes.c_int64),
            len(clip_ids),
            ptr(gt_flat, ctypes.c_double), ptr(gt_off, ctypes.c_int64),
            n_classes, ci,
            ptr(durs, ctypes.c_double), int(bool(compute_ct)),
            float(dtc), float(gtc), float(cttc),
            ptr(thr, ctypes.c_double), ptr(tp, ctypes.c_int64),
            ptr(fp, ctypes.c_int64), ptr(ctr, ctypes.c_double),
        )
        return thr[:n], tp[:n], fp[:n], ctr[:n]

    sweep.exact = exact
    return sweep


def compute_psd_roc(
    scores: Dict[str, ClipScores],
    ground_truth: GroundTruth,
    audio_durations: Mapping[str, float],
    dtc_threshold: float,
    gtc_threshold: float,
    cttc_threshold: float,
    alpha_ct: float,
    alpha_st: float,
    max_efpr: float,
    max_thresholds: int = 200,
) -> PSDSResult:
    classes = list(next(iter(scores.values())).event_classes)
    # NaN guard (the de-facto numeric sanitizer, SURVEY §5.2): non-finite
    # scores mean the model diverged; fail loudly instead of producing a
    # garbage metric (and NaN used to drive the native sweep's merge loop
    # out of bounds)
    for clip_id, clip in scores.items():
        if not np.isfinite(clip.scores).all():
            raise ValueError(
                f"non-finite scores for clip {clip_id!r} — model diverged?"
            )
    total_hours = sum(audio_durations[c] for c in scores) / 3600.0

    # index ground truth
    gt_by_clip_class: Dict[str, Dict[str, np.ndarray]] = {}
    n_events = {c: 0 for c in classes}
    gt_dur = {c: 0.0 for c in classes}
    for clip_id, events in ground_truth.items():
        d: Dict[str, List] = {}
        for on, off, label in events:
            d.setdefault(label, []).append((on, off))
            if label in n_events:
                n_events[label] += 1
                gt_dur[label] += off - on
        gt_by_clip_class[clip_id] = {k: np.asarray(v) for k, v in d.items()}

    # per-class threshold sets (sed_scores_eval evaluates each class at its
    # own observed score values; a global sweep under-resolves classes whose
    # score distributions differ)
    def class_thresholds(ci: int) -> np.ndarray:
        sample = np.concatenate([c.scores[:, ci] for c in scores.values()])
        uniq = np.unique(sample)
        if len(uniq) > max_thresholds:
            uniq = np.unique(np.quantile(sample, np.linspace(0.0, 1.0, max_thresholds)))
        return uniq

    native = _native_sweeper(scores, gt_by_clip_class, classes)

    def _rates(c, thr_count, tp_arr, fp_arr, ct_mat):
        """(tp, fp, ct) count arrays over thresholds -> (efpr, tpr) points."""
        pts = []
        for ti in range(thr_count):
            tpr = tp_arr[ti] / n_events[c] if n_events[c] else np.nan
            rate = fp_arr[ti] / max(total_hours, 1e-12)
            if alpha_ct > 0:
                ctr = [
                    ct_mat[ti][c2i] / max(gt_dur[c2] / 3600.0, 1e-12)
                    for c2i, c2 in enumerate(classes)
                    if c2 != c and gt_dur[c2] > 0
                ]
                rate += alpha_ct * (np.mean(ctr) if ctr else 0.0)
            pts.append((rate, tpr))
        return np.asarray(pts)

    def eval_class(ci: int):
        """Sweep one class: returns arrays (efpr, tpr) over its thresholds."""
        c = classes[ci]
        if native is not None:
            # exact curves at every observed score value (sed_scores_eval
            # semantics); the cross-trigger rate arrives pre-aggregated
            gt_dur_hours = np.asarray([gt_dur[c2] / 3600.0 for c2 in classes])
            _, tp_arr, fp_arr, ctr_arr = native.exact(
                ci, gt_dur_hours, dtc_threshold, gtc_threshold,
                cttc_threshold, alpha_ct > 0,
            )
            tpr = tp_arr / n_events[c] if n_events[c] else np.full(len(tp_arr), np.nan)
            rate = fp_arr / max(total_hours, 1e-12) + alpha_ct * ctr_arr
            return np.stack([rate, tpr], axis=1)
        thrs = class_thresholds(ci)
        tp_arr, fp_arr, ct_rows = [], [], []
        for thr in thrs:
            # >= semantics at the observed score values — identical to the
            # native exact sweep and sed_scores_eval (no epsilon games)
            detections = {
                clip_id: {c: _intervals_from_binary(clip.scores[:, ci] >= thr, clip.timestamps)}
                for clip_id, clip in scores.items()
            }
            tp, fp, ct = evaluate_operating_point(
                detections, gt_by_clip_class, classes, dtc_threshold, gtc_threshold, cttc_threshold
            )
            tp_arr.append(tp[c])
            fp_arr.append(fp[c])
            ct_rows.append([ct[c][c2] for c2 in classes])
        return _rates(c, len(thrs), tp_arr, fp_arr, ct_rows)

    live_classes = [c for c in classes if n_events[c] > 0]
    live_idx = [classes.index(c) for c in live_classes]
    per_class_pts = [eval_class(ci) for ci in live_idx]
    SWEEPS["numpy" if native is None else "native"] += len(live_idx)

    grid = np.unique(
        np.concatenate([[0.0, max_efpr]] + [pts[:, 0] for pts in per_class_pts])
    )
    grid = grid[grid <= max_efpr]
    rocs = {}
    tpr_curves = []
    for c, pts in zip(live_classes, per_class_pts):
        order = np.argsort(pts[:, 0])
        e_sorted, t_sorted = pts[order, 0], pts[order, 1]
        t_stair = np.maximum.accumulate(t_sorted)
        curve = np.zeros_like(grid)
        idx = np.searchsorted(e_sorted, grid, side="right") - 1
        valid = idx >= 0
        curve[valid] = t_stair[idx[valid]]
        rocs[c] = (grid, curve)
        tpr_curves.append(curve)

    tpr_mat = np.stack(tpr_curves)  # [C, grid]
    mu = tpr_mat.mean(axis=0)
    sigma = tpr_mat.std(axis=0)
    etpr = np.maximum(mu - alpha_st * sigma, 0.0)

    # AUC via right-continuous staircase up to max_efpr
    def stair_auc(x, y, x_max):
        x = np.r_[x, x_max]
        widths = np.diff(x)
        return float(np.sum(widths * y))

    value = stair_auc(grid, etpr, max_efpr) / max_efpr
    single = {
        c: stair_auc(rocs[c][0], rocs[c][1], max_efpr) / max_efpr for c in live_classes
    }
    return PSDSResult(value, single, grid, etpr, rocs)


def compute_psds_from_scores(
    scores: Dict[str, ClipScores],
    ground_truth: GroundTruth,
    audio_durations: Mapping[str, float],
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
    cttc_threshold: float = 0.3,
    alpha_ct: float = 0.0,
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
    max_thresholds: int = 200,
) -> Tuple[float, Dict[str, float]]:
    """PSDS + per-class PSDS."""
    result = compute_psd_roc(
        scores,
        ground_truth,
        audio_durations,
        dtc_threshold,
        gtc_threshold,
        cttc_threshold,
        alpha_ct,
        alpha_st,
        max_efpr,
        max_thresholds,
    )
    return result.value, result.single_class_psds
