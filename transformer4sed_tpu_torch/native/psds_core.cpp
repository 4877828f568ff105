// Native PSDS operating-point sweep.
//
// The intersection-based PSDS threshold sweep (eval/psds.py:compute_psd_roc)
// evaluates n_classes x n_thresholds x n_clips operating points; in Python
// that is ~2M interval evaluations and measured 315 s for a DESED-sized
// validation set (1000 clips x 10 classes x 200 thresholds). This C++ core
// runs the same math in ~1 s. Semantics mirror
// eval/psds.py:evaluate_operating_point exactly:
//   * detections = maximal runs of (score >= threshold) frames
//     (sed_scores_eval semantics, matching the exact sweep);
//   * DTC: a detection is valid iff sum of same-class GT intersections
//     >= dtc * detection length, else it is an FP;
//   * GTC: a GT event is a TP iff valid detections cover >= gtc of it
//     (detections from binarisation are disjoint, so coverage = sum);
//   * CTTC: a GT event of another class is cross-triggered iff some FP
//     detection covers >= cttc of it.
//
// Exposed with a plain C ABI for ctypes (pybind11 is not in the image).
// Built by native/build.py with g++ -O3 on first use.

#include <cstdint>
#include <vector>
#include <algorithm>

namespace {

struct Interval {
  double on;
  double off;
};

inline double overlap(const Interval& a, double on, double off) {
  double lo = a.on > on ? a.on : on;
  double hi = a.off < off ? a.off : off;
  return hi > lo ? hi - lo : 0.0;
}

}  // namespace

extern "C" {

// One class's full threshold sweep.
//
// scores:      concatenated per-clip frame scores for this class
// score_off:   [n_clips + 1] offsets into `scores`
// stamps:      concatenated per-clip timestamps (len T_i + 1 per clip)
// stamp_off:   [n_clips + 1] offsets into `stamps`
// gt:          [*, 2] (onset, offset) rows flattened over (clip, class)
// gt_off:      [n_clips * n_classes + 1] row offsets into `gt`
// thresholds:  [n_thr]
// tp_out/fp_out: [n_thr]
// ct_out:      [n_thr * n_classes] cross-trigger counts (written only
//              when compute_ct != 0)
void psds_class_sweep(
    const float* scores, const int64_t* score_off,
    const double* stamps, const int64_t* stamp_off,
    int64_t n_clips,
    const double* gt, const int64_t* gt_off,
    int64_t n_classes, int64_t class_idx,
    const double* thresholds, int64_t n_thr,
    double dtc, double gtc, double cttc, int compute_ct,
    int64_t* tp_out, int64_t* fp_out, int64_t* ct_out) {
  std::vector<Interval> dets;
  dets.reserve(256);

  for (int64_t ti = 0; ti < n_thr; ++ti) {
    const double thr = thresholds[ti];
    int64_t tp = 0, fp = 0;
    int64_t* ct_row = ct_out + ti * n_classes;

    for (int64_t ci = 0; ci < n_clips; ++ci) {
      const float* s = scores + score_off[ci];
      const int64_t t_len = score_off[ci + 1] - score_off[ci];
      const double* st = stamps + stamp_off[ci];

      // detections: maximal runs of score >= thr
      dets.clear();
      bool open = false;
      double onset = 0.0;
      for (int64_t t = 0; t < t_len; ++t) {
        const bool hi = static_cast<double>(s[t]) >= thr;
        if (hi && !open) {
          onset = st[t];
          open = true;
        } else if (!hi && open) {
          dets.push_back({onset, st[t]});
          open = false;
        }
      }
      if (open) dets.push_back({onset, st[t_len]});
      if (dets.empty()) continue;

      const int64_t base = ci * n_classes;
      const double* g = gt + 2 * gt_off[base + class_idx];
      const int64_t n_gt = gt_off[base + class_idx + 1] - gt_off[base + class_idx];

      // DTC validity per detection
      // (store FP dets for CTTC; valid dets for GTC)
      std::vector<char> valid(dets.size());
      int64_t n_fp_here = 0;
      for (size_t di = 0; di < dets.size(); ++di) {
        double inter = 0.0;
        for (int64_t gi = 0; gi < n_gt; ++gi) {
          inter += overlap(dets[di], g[2 * gi], g[2 * gi + 1]);
        }
        const double len = dets[di].off - dets[di].on;
        const bool ok = inter >= dtc * (len > 1e-12 ? len : 1e-12);
        valid[di] = ok;
        if (!ok) ++n_fp_here;
      }
      fp += n_fp_here;

      // GTC: coverage of each GT by valid (disjoint) detections
      for (int64_t gi = 0; gi < n_gt; ++gi) {
        const double g_on = g[2 * gi], g_off = g[2 * gi + 1];
        double cov = 0.0;
        for (size_t di = 0; di < dets.size(); ++di) {
          if (valid[di]) cov += overlap(dets[di], g_on, g_off);
        }
        const double g_len = g_off - g_on;
        if (cov >= gtc * (g_len > 1e-12 ? g_len : 1e-12)) ++tp;
      }

      // CTTC: FP detections vs other-class ground truths
      if (compute_ct && n_fp_here > 0) {
        for (int64_t c2 = 0; c2 < n_classes; ++c2) {
          if (c2 == class_idx) continue;
          const double* g2 = gt + 2 * gt_off[base + c2];
          const int64_t n_g2 = gt_off[base + c2 + 1] - gt_off[base + c2];
          for (int64_t gi = 0; gi < n_g2; ++gi) {
            const double g_on = g2[2 * gi], g_off = g2[2 * gi + 1];
            const double g_len = g_off - g_on;
            const double need = cttc * (g_len > 1e-12 ? g_len : 1e-12);
            for (size_t di = 0; di < dets.size(); ++di) {
              if (valid[di]) continue;
              if (overlap(dets[di], g_on, g_off) >= need) {
                ++ct_row[c2];
                break;
              }
            }
          }
        }
      }
    }
    tp_out[ti] = tp;
    fp_out[ti] = fp;
  }
}

}  // extern "C"

extern "C" {

// Exact sweep: evaluates the operating point at EVERY observed score
// value (sed_scores_eval semantics) instead of a quantile subset.
//
// Per clip, counts are piecewise-constant in the threshold and change
// only at that clip's own score values, so each clip is evaluated at its
// own unique values (detections = frames with score >= v, matching the
// quantile path's `> v - eps` convention) and emits count DELTAS; the
// deltas of all clips are merge-sorted by threshold (descending) and
// prefix-summed into exact global (tp, fp, cross-trigger-rate) curves.
//
// gt_dur_hours: [n_classes] total GT duration per class in hours (for
// the cross-trigger rate); ctr contributions average over other classes
// with nonzero duration. Outputs are written at each DISTINCT global
// threshold; the return value is the number of points written (always
// <= total number of frames). Output buffers must hold score_off[n_clips]
// entries.
int64_t psds_class_exact(
    const float* scores, const int64_t* score_off,
    const double* stamps, const int64_t* stamp_off,
    int64_t n_clips,
    const double* gt, const int64_t* gt_off,
    int64_t n_classes, int64_t class_idx,
    const double* gt_dur_hours, int compute_ct,
    double dtc, double gtc, double cttc,
    double* thr_out, int64_t* tp_out, int64_t* fp_out, double* ctr_out) {
  struct Event {
    float v;
    int32_t dtp;
    int32_t dfp;
    double dctr;
  };
  std::vector<Event> events;
  events.reserve(score_off[n_clips]);
  std::vector<float> vals;
  std::vector<Interval> dets;
  std::vector<char> valid;

  // number of other classes with nonzero GT duration (ctr denominator)
  int64_t n_valid_c2 = 0;
  for (int64_t c2 = 0; c2 < n_classes; ++c2) {
    if (c2 != class_idx && gt_dur_hours[c2] > 0.0) ++n_valid_c2;
  }

  for (int64_t ci = 0; ci < n_clips; ++ci) {
    const float* s = scores + score_off[ci];
    const int64_t t_len = score_off[ci + 1] - score_off[ci];
    const double* st = stamps + stamp_off[ci];
    const int64_t base = ci * n_classes;
    const double* g = gt + 2 * gt_off[base + class_idx];
    const int64_t n_gt = gt_off[base + class_idx + 1] - gt_off[base + class_idx];

    vals.assign(s, s + t_len);
    // drop non-finite scores BEFORE sorting: NaN breaks the comparator's
    // strict weak ordering (UB) and NaN != NaN makes the merge loop below
    // never advance — an unbounded write into the caller's buffers
    vals.erase(std::remove_if(vals.begin(), vals.end(),
                              [](float v) { return !(v == v); }),
               vals.end());
    std::sort(vals.begin(), vals.end(), std::greater<float>());
    vals.erase(std::unique(vals.begin(), vals.end()), vals.end());

    int64_t prev_tp = 0, prev_fp = 0;
    double prev_ctr = 0.0;
    for (const float v : vals) {
      // detections: maximal runs of score >= v
      dets.clear();
      bool open = false;
      double onset = 0.0;
      for (int64_t t = 0; t < t_len; ++t) {
        const bool hi = s[t] >= v;
        if (hi && !open) {
          onset = st[t];
          open = true;
        } else if (!hi && open) {
          dets.push_back({onset, st[t]});
          open = false;
        }
      }
      if (open) dets.push_back({onset, st[t_len]});

      int64_t tp = 0, fp = 0;
      double ctr = 0.0;
      if (!dets.empty()) {
        valid.assign(dets.size(), 0);
        int64_t n_fp_here = 0;
        for (size_t di = 0; di < dets.size(); ++di) {
          double inter = 0.0;
          for (int64_t gi = 0; gi < n_gt; ++gi) {
            inter += overlap(dets[di], g[2 * gi], g[2 * gi + 1]);
          }
          const double len = dets[di].off - dets[di].on;
          const bool ok = inter >= dtc * (len > 1e-12 ? len : 1e-12);
          valid[di] = ok;
          if (!ok) ++n_fp_here;
        }
        fp = n_fp_here;
        for (int64_t gi = 0; gi < n_gt; ++gi) {
          const double g_on = g[2 * gi], g_off = g[2 * gi + 1];
          double cov = 0.0;
          for (size_t di = 0; di < dets.size(); ++di) {
            if (valid[di]) cov += overlap(dets[di], g_on, g_off);
          }
          const double g_len = g_off - g_on;
          if (cov >= gtc * (g_len > 1e-12 ? g_len : 1e-12)) ++tp;
        }
        if (compute_ct && n_fp_here > 0 && n_valid_c2 > 0) {
          for (int64_t c2 = 0; c2 < n_classes; ++c2) {
            if (c2 == class_idx || gt_dur_hours[c2] <= 0.0) continue;
            const double* g2 = gt + 2 * gt_off[base + c2];
            const int64_t n_g2 = gt_off[base + c2 + 1] - gt_off[base + c2];
            int64_t hits = 0;
            for (int64_t gi = 0; gi < n_g2; ++gi) {
              const double g_on = g2[2 * gi], g_off = g2[2 * gi + 1];
              const double g_len = g_off - g_on;
              const double need = cttc * (g_len > 1e-12 ? g_len : 1e-12);
              for (size_t di = 0; di < dets.size(); ++di) {
                if (valid[di]) continue;
                if (overlap(dets[di], g_on, g_off) >= need) {
                  ++hits;
                  break;
                }
              }
            }
            ctr += static_cast<double>(hits) /
                   (gt_dur_hours[c2] * static_cast<double>(n_valid_c2));
          }
        }
      }
      events.push_back({v, static_cast<int32_t>(tp - prev_tp),
                        static_cast<int32_t>(fp - prev_fp), ctr - prev_ctr});
      prev_tp = tp;
      prev_fp = fp;
      prev_ctr = ctr;
    }
  }

  std::sort(events.begin(), events.end(),
            [](const Event& a, const Event& b) { return a.v > b.v; });

  int64_t n_out = 0;
  int64_t tp = 0, fp = 0;
  double ctr = 0.0;
  for (size_t i = 0; i < events.size();) {
    const float v = events[i].v;
    while (i < events.size() && events[i].v == v) {
      tp += events[i].dtp;
      fp += events[i].dfp;
      ctr += events[i].dctr;
      ++i;
    }
    thr_out[n_out] = static_cast<double>(v);
    tp_out[n_out] = tp;
    fp_out[n_out] = fp;
    ctr_out[n_out] = ctr;
    ++n_out;
  }
  return n_out;
}

}  // extern "C"
