"""Event-based and segment-based F1 metrics (sed_eval semantics) and
intersection-criterion macro F1 (psds_eval semantics); port of the JAX
package's ``eval/sed_f1.py`` (NumPy only).

The reference calls sed_eval's EventBasedMetrics (t_collar=0.2,
percentage_of_length=0.2) and SegmentBasedMetrics (1 s) via
``log_sedeval_metrics`` (``src/evaluation_measures.py:258-293``) and
psds_eval's ``compute_macro_f_score`` via
``compute_per_intersection_macro_f1`` (``:155-197``). Neither library
ships in this image, so the algorithms are implemented natively:

  * event-based: greedy bipartite matching — a prediction matches a
    ground truth of the same class when |onset difference| <= collar and
    |offset difference| <= max(collar, perc * gt duration);
  * segment-based: activity grids over fixed segments;
  * intersection macro F1: DTC/GTC counting from
    :mod:`transformer4sed_tpu_torch.eval.psds`, macro-averaged F1 over
    classes, averaged over thresholds.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from transformer4sed_tpu_torch.eval.psds import evaluate_operating_point

Events = Mapping[str, Sequence[Tuple[float, float, str]]]  # clip -> (onset, offset, label)


def _f1(tp: int, fp: int, fn: int) -> float:
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def event_based_f1(
    predictions: Events,
    ground_truth: Events,
    classes: Sequence[str],
    t_collar: float = 0.2,
    percentage_of_length: float = 0.2,
) -> Dict[str, float]:
    """Macro/micro event-based F1 with onset/offset collars."""
    counts = {c: [0, 0, 0] for c in classes}  # tp, fp, fn
    clip_ids = set(predictions) | set(ground_truth)
    for clip in clip_ids:
        preds = [e for e in predictions.get(clip, [])]
        gts = [e for e in ground_truth.get(clip, [])]
        for c in classes:
            p = [e for e in preds if e[2] == c]
            g = [e for e in gts if e[2] == c]
            matched_g = set()
            tp = 0
            for pe in p:
                for gi, ge in enumerate(g):
                    if gi in matched_g:
                        continue
                    off_collar = max(t_collar, percentage_of_length * (ge[1] - ge[0]))
                    if abs(pe[0] - ge[0]) <= t_collar and abs(pe[1] - ge[1]) <= off_collar:
                        matched_g.add(gi)
                        tp += 1
                        break
            counts[c][0] += tp
            counts[c][1] += len(p) - tp
            counts[c][2] += len(g) - tp

    class_f1 = {c: _f1(*counts[c]) for c in classes}
    tot = np.sum(list(counts.values()), axis=0) if counts else np.zeros(3)
    return {
        "class_wise_f1": class_f1,
        "macro_f1": float(np.mean(list(class_f1.values()))) if class_f1 else 0.0,
        "micro_f1": _f1(int(tot[0]), int(tot[1]), int(tot[2])),
    }


def segment_based_f1(
    predictions: Events,
    ground_truth: Events,
    classes: Sequence[str],
    audio_durations: Mapping[str, float],
    segment_length: float = 1.0,
) -> Dict[str, float]:
    """Macro/micro segment-based F1 over fixed-length segments."""
    counts = {c: [0, 0, 0] for c in classes}
    for clip, dur in audio_durations.items():
        n_seg = int(np.ceil(dur / segment_length))
        edges = np.arange(n_seg + 1) * segment_length

        def grid(events):
            g = np.zeros((n_seg, len(classes)), dtype=bool)
            for on, off, label in events:
                if label not in classes:
                    continue
                ci = list(classes).index(label)
                lo = int(np.floor(on / segment_length))
                hi = int(np.ceil(off / segment_length))
                g[lo : max(hi, lo + 1), ci] = True
            return g

        pg = grid(predictions.get(clip, []))
        gg = grid(ground_truth.get(clip, []))
        for ci, c in enumerate(classes):
            counts[c][0] += int((pg[:, ci] & gg[:, ci]).sum())
            counts[c][1] += int((pg[:, ci] & ~gg[:, ci]).sum())
            counts[c][2] += int((~pg[:, ci] & gg[:, ci]).sum())

    class_f1 = {c: _f1(*counts[c]) for c in classes}
    tot = np.sum(list(counts.values()), axis=0) if counts else np.zeros(3)
    return {
        "class_wise_f1": class_f1,
        "macro_f1": float(np.mean(list(class_f1.values()))) if class_f1 else 0.0,
        "micro_f1": _f1(int(tot[0]), int(tot[1]), int(tot[2])),
    }


def intersection_macro_f1(
    prediction_dfs: Mapping[float, Sequence[Tuple[str, str, float, float]]],
    ground_truth: Events,
    classes: Sequence[str],
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
) -> float:
    """Macro F1 with intersection (DTC/GTC) matching, averaged over thresholds
    (reference ``compute_per_intersection_macro_f1``)."""
    gt_by_clip_class: Dict[str, Dict[str, np.ndarray]] = {}
    n_events = {c: 0 for c in classes}
    for clip_id, events in ground_truth.items():
        d: Dict[str, List] = {}
        for on, off, label in events:
            d.setdefault(label, []).append((on, off))
            if label in n_events:
                n_events[label] += 1
        gt_by_clip_class[clip_id] = {k: np.asarray(v) for k, v in d.items()}

    f1s = []
    for thr, rows in prediction_dfs.items():
        detections: Dict[str, Dict[str, List]] = {}
        for fname, label, onset, offset in rows:
            clip = fname.rsplit(".", 1)[0]
            detections.setdefault(clip, {}).setdefault(label, []).append((onset, offset))
        det_arr = {
            clip: {c: np.asarray(v) for c, v in per.items()}
            for clip, per in detections.items()
        }
        tp, fp, _ = evaluate_operating_point(
            det_arr, gt_by_clip_class, classes, dtc_threshold, gtc_threshold, cttc_threshold=1.1
        )
        # classes with no ground-truth events are EXCLUDED from the macro
        # mean (psds_eval's compute_macro_f_score leaves their F as NaN and
        # nan-means — counting them as 0 would deflate the metric)
        per_class = []
        for c in classes:
            if n_events[c] == 0:
                continue
            fn = n_events[c] - tp[c]
            per_class.append(_f1(tp[c], fp[c], fn))
        f1s.append(float(np.mean(per_class)) if per_class else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0
