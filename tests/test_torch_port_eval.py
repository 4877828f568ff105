"""The port's eval layer, held against the JAX package on the CPU.

Filters, both decode functions, PSDS on the native and the NumPy sweep, the
F1s, cSEBB, the score containers and the TSV ensemble, from seeded numpy
scores. Everything but the filters' even-width medians is equal bit for
bit: the same float64 NumPy code and the same C++ source on both sides.
"""

import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformer4sed_tpu.eval.psds as jax_psds
import transformer4sed_tpu_torch.eval.psds as port_psds
from transformer4sed_tpu.core.codec import LabelCodec as JaxCodec
from transformer4sed_tpu.core.filters import apply_class_filter as jax_filter
from transformer4sed_tpu.eval import decode as jax_decode
from transformer4sed_tpu.eval import postprocess as jax_post
from transformer4sed_tpu.eval import scores as jax_scores
from transformer4sed_tpu.eval import sebbs as jax_sebbs
from transformer4sed_tpu.eval import sed_f1 as jax_f1
from transformer4sed_tpu.recipes import common as jax_common
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.core.filters import apply_class_filter
from transformer4sed_tpu_torch.eval import decode, postprocess, scores, sebbs, sed_f1
from transformer4sed_tpu_torch.native.build import load_psds_core
from transformer4sed_tpu_torch.recipes import common

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ("alarm", "cat", "dog")
CODEC_ARGS = dict(audio_len=1.0, frame_len=1024, frame_hop=320, sr=16000)  # 50 frames
PSDS1 = dict(dtc_threshold=0.7, gtc_threshold=0.7, cttc_threshold=0.3, alpha_ct=0.0,
             alpha_st=1.0)
PSDS2 = dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3, alpha_ct=0.5,
             alpha_st=1.0)
# jnp.median and the port form the mean of an even window's two middle
# values in another order: one f32 ulp of a score in [0, 1]
EVEN_MEDIAN_ATOL = 1e-6


def batch(seed, b=4, t=50):
    rng = np.random.RandomState(seed)
    strong = rng.rand(b, len(CLASSES), t).astype(np.float32)
    weak = rng.rand(b, len(CLASSES)).astype(np.float32)
    return strong, weak, [f"clip{i}.wav" for i in range(b)]


@pytest.mark.parametrize("kind", ["median", "max"])
@pytest.mark.parametrize("mode", ["reflect", "nearest"])
@pytest.mark.parametrize("widths", [5, 4, [5, 4, 1]], ids=["odd", "even", "mixed"])
def test_filters_match_jax(kind, mode, widths):
    x = np.random.RandomState(0).rand(2, 50, 3).astype(np.float32)
    ours = apply_class_filter(torch.from_numpy(x), widths, kind=kind, mode=mode).numpy()
    ref = np.asarray(jax_filter(jnp.asarray(x), widths, kind=kind, mode=mode))
    if kind == "median" and widths != 5:
        np.testing.assert_allclose(ours, ref, atol=EVEN_MEDIAN_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(ours, ref)


def _same_clips(ours, ref, atol=0.0):
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].event_classes == ref[k].event_classes
        np.testing.assert_array_equal(ours[k].timestamps, ref[k].timestamps)
        np.testing.assert_allclose(ours[k].scores, ref[k].scores, atol=atol, rtol=0)


DECODE_CASES = {
    "median": dict(filter=[5, 4, 7]),
    "median_weak_mask": dict(filter=[5, 4, 7], need_weak_mask=True),
    "max": dict(filter=5, filter_type="max"),
    "none": dict(filter=None, need_weak_mask=True),
    "pad_groups": dict(filter=[5, 4, 7], pad_idx=[1.0, 0.6, 1.0, 0.6]),
    "pad_groups_max_weak": dict(filter=3, filter_type="max", pad_idx=[0.5, 1.0, 0.5, 0.8],
                                need_weak_mask=True),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_batched_decode_preds_matches_jax(case):
    kw = DECODE_CASES[case]
    strong, weak, names = batch(1)
    ours = decode.batched_decode_preds(strong, names, LabelCodec(CLASSES, **CODEC_ARGS),
                                       weak_preds=weak, device="cpu", **kw)
    ref = jax_decode.batched_decode_preds(strong, names, JaxCodec(CLASSES, **CODEC_ARGS),
                                          weak_preds=weak, **kw)
    _same_clips(ours[0], ref[0])  # raw: a transpose and a product
    even = any(w % 2 == 0 for w in np.atleast_1d(kw["filter"] or 1))
    _same_clips(ours[1], ref[1], EVEN_MEDIAN_ATOL if even else 0.0)
    assert (ours[1] is ours[0]) == (ref[1] is ref[0])  # no filter: the same containers


def test_batched_decode_preds_takes_tensors_where_they_lie():
    strong, weak, names = batch(2)
    codec = LabelCodec(CLASSES, **CODEC_ARGS)
    from_numpy = decode.batched_decode_preds(strong, names, codec, filter=5, device="cpu")
    from_tensor = decode.batched_decode_preds(torch.from_numpy(strong), names, codec, filter=5)
    _same_clips(from_tensor[1], from_numpy[1])


@pytest.mark.parametrize("with_weak", [True, False])
@pytest.mark.parametrize("widths", [7, [5, 4, 7]], ids=["one", "per_class"])
def test_decode_pred_batch_matches_jax(with_weak, widths):
    strong, weak, names = batch(3)
    weak = weak if with_weak else None
    ours = decode.decode_pred_batch(strong, weak, names, LabelCodec(CLASSES, **CODEC_ARGS),
                                    [0.3, 0.5], widths, device="cpu")
    ref = jax_decode.decode_pred_batch(strong, weak, names, JaxCodec(CLASSES, **CODEC_ARGS),
                                       [0.3, 0.5], widths)
    assert ours == ref
    assert len(ours[0.5]) > 0


def synthetic_scores(seed, n_clips=10, t=40):
    """(port ClipScores, JAX ClipScores, ground truth, durations)."""
    rng = np.random.RandomState(seed)
    ours, ref, gt, durs = {}, {}, {}, {}
    for i in range(n_clips):
        arr = (rng.rand(t, len(CLASSES)) * 0.75).astype(np.float32)
        events = []
        for _ in range(rng.randint(0, 4)):
            c = rng.randint(len(CLASSES))
            on, ln = rng.randint(0, t - 8), rng.randint(4, 10)
            arr[on:on + ln, c] = 0.55 + 0.45 * rng.rand()
            events.append((on / t * 10.0, min(on + ln, t) / t * 10.0, CLASSES[c]))
        on = rng.randint(0, t - 6)  # a false alarm
        arr[on:on + 6, rng.randint(len(CLASSES))] = 0.6 + 0.35 * rng.rand()
        ts = np.linspace(0, 10, t + 1)
        ours[f"clip{i}"] = scores.ClipScores(arr, ts, CLASSES)
        ref[f"clip{i}"] = jax_scores.ClipScores(arr, ts, CLASSES)
        gt[f"clip{i}"] = events
        durs[f"clip{i}"] = 10.0
    return ours, ref, gt, durs


@pytest.fixture(scope="module")
def psds_data():
    return synthetic_scores(0)


def _sweep_path(monkeypatch, path):
    if path == "numpy":
        monkeypatch.setattr(port_psds, "_native_sweeper", lambda *a, **k: None)
        monkeypatch.setattr(jax_psds, "_native_sweeper", lambda *a, **k: None)
    else:
        assert load_psds_core() is not None, "g++ is here: the native sweep must build"


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("setting", ["psds1", "psds2"])
def test_psds_matches_jax_bitwise(monkeypatch, psds_data, path, setting):
    ours_s, ref_s, gt, durs = psds_data
    kw = PSDS1 if setting == "psds1" else PSDS2
    _sweep_path(monkeypatch, path)
    before = port_psds.SWEEPS[path]
    # 400 scores a class: the NumPy sweep takes 80 of their quantiles
    ours = port_psds.compute_psd_roc(ours_s, gt, durs, max_efpr=100.0, max_thresholds=80, **kw)
    assert port_psds.SWEEPS[path] == before + len(CLASSES)
    ref = jax_psds.compute_psd_roc(ref_s, gt, durs, max_efpr=100.0, max_thresholds=80, **kw)
    assert ours.value == ref.value and 0.0 < ours.value < 1.0
    assert ours.single_class_psds == ref.single_class_psds
    np.testing.assert_array_equal(ours.efpr_grid, ref.efpr_grid)
    np.testing.assert_array_equal(ours.etpr, ref.etpr)
    for c in ref.per_class_rocs:
        for a, b in zip(ours.per_class_rocs[c], ref.per_class_rocs[c]):
            np.testing.assert_array_equal(a, b)
    assert (port_psds.compute_psds_from_scores(ours_s, gt, durs, max_thresholds=80, **kw)
            == jax_psds.compute_psds_from_scores(ref_s, gt, durs, max_thresholds=80, **kw))


def test_psds_refuses_non_finite_scores(psds_data):
    ours_s, _, gt, durs = psds_data
    bad = dict(ours_s, clip0=scores.ClipScores(np.full((40, 3), np.nan, np.float32),
                                                ours_s["clip0"].timestamps, CLASSES))
    with pytest.raises(ValueError, match="non-finite"):
        port_psds.compute_psds_from_scores(bad, gt, durs)


def test_f1s_match_jax(psds_data):
    _, _, gt, durs = psds_data
    preds = {}
    for clip, events in gt.items():  # the ground truth shifted and cut: some hits, some not
        preds[clip] = [(on + 0.15, off - 0.4, lab) for on, off, lab in events][::2]
    for a, b in ((sed_f1.event_based_f1(preds, gt, CLASSES),
                  jax_f1.event_based_f1(preds, gt, CLASSES)),
                 (sed_f1.segment_based_f1(preds, gt, CLASSES, durs),
                  jax_f1.segment_based_f1(preds, gt, CLASSES, durs))):
        assert a == b and 0.0 < a["macro_f1"] < 1.0
    rows = {thr: [(f"{clip}.wav", lab, on, off) for clip, events in preds.items()
                  for on, off, lab in events[:keep]] for thr, keep in ((0.5, None), (0.7, 1))}
    ours = sed_f1.intersection_macro_f1(rows, gt, CLASSES)
    assert ours == jax_f1.intersection_macro_f1(rows, gt, CLASSES) and ours > 0.0


def test_csebbs_match_jax(psds_data):
    ours_s, ref_s, gt, durs = psds_data
    params = {"cat": sebbs.CSEBBParams(0.32, 0.1, 2.0)}
    jparams = {"cat": jax_sebbs.CSEBBParams(0.32, 0.1, 2.0)}
    ours, ref = sebbs.apply_csebbs(ours_s, params), jax_sebbs.apply_csebbs(ref_s, jparams)
    _same_clips(ours, ref)
    for clip in ("clip0", "clip5"):
        assert (sebbs.sebbs_to_events(ours_s[clip], 0.5, params)
                == jax_sebbs.sebbs_to_events(ref_s[clip], 0.5, jparams))
    grid = dict(step_filter_lengths=(0.32, 0.64), merge_thresholds_abs=(0.15,),
                merge_thresholds_rel=(1.5, 3.0))
    for per_class in (True, False):
        p_ours, best_ours = sebbs.tune_csebbs(ours_s, gt, durs, per_class=per_class, **grid)
        p_ref, best_ref = jax_sebbs.tune_csebbs(ref_s, gt, durs, per_class=per_class, **grid)
        assert best_ours == best_ref
        as_tuple = (lambda p: {c: tuple(vars(v).values()) for c, v in p.items()}
                    if isinstance(p, dict) else tuple(vars(p).values()))
        assert as_tuple(p_ours) == as_tuple(p_ref)


def test_segment_scores_and_merges_match_jax():
    rng = np.random.RandomState(5)
    ts = np.linspace(0, 4.0, 41)
    arr = rng.rand(40, 3).astype(np.float32)
    clips = {"f-000-400": arr, "f-200-600": arr[::-1].copy(), "g-000-400": arr * 0.5}
    durs = {"f": 6.0, "g": 4.0}
    ours = scores.segment_scores_overlap_add(
        {k: scores.ClipScores(v, ts, CLASSES) for k, v in clips.items()}, durs, CLASSES)
    ref = jax_scores.segment_scores_overlap_add(
        {k: jax_scores.ClipScores(v, ts, CLASSES) for k, v in clips.items()}, durs, CLASSES)
    _same_clips(ours, ref)
    clip_gt = {"f-000-1000": [(1.0, 3.0, "cat"), (2.5, 4.0, "cat"), (0.0, 1.0, "dog")],
               "f-500-1500": [(0.0, 2.0, "cat")], "g-000-1000": []}
    assert (scores.merge_maestro_ground_truth(clip_gt)
            == jax_scores.merge_maestro_ground_truth(clip_gt))


def test_score_tsvs_and_ensemble_match_jax(tmp_path, psds_data):
    ours_s, ref_s, _, _ = psds_data
    for model, scale in (("m1", 1.0), ("m2", 0.5)):
        for d in ("ours", "ref"):
            (tmp_path / d / model).mkdir(parents=True)
        for clip in list(ours_s)[:4]:
            s = ours_s[clip].scores * scale
            t = ours_s[clip].timestamps if model == "m1" else np.linspace(0, 10, 31)
            s = s if model == "m1" else s[:30]
            scores.ClipScores(s, t, CLASSES).to_tsv(str(tmp_path / "ours" / model / f"{clip}.tsv"))
            jax_scores.ClipScores(s, t, CLASSES).to_dataframe().to_csv(
                tmp_path / "ref" / model / f"{clip}.tsv", sep="\t", index=False)
            assert ((tmp_path / "ours" / model / f"{clip}.tsv").read_bytes()
                    == (tmp_path / "ref" / model / f"{clip}.tsv").read_bytes())
    cols = ["onset", "offset", *CLASSES]
    postprocess.ensemble(str(tmp_path / "ours"), str(tmp_path / "ours_out"), ["m1", "m2"],
                         [0.6, 0.4], cols)
    jax_post.ensemble(str(tmp_path / "ours"), str(tmp_path / "ref_out"), ["m1", "m2"],
                      [0.6, 0.4], cols)
    names = sorted(p.name for p in (tmp_path / "ref_out").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ours_out").iterdir()) and len(names) == 4
    for name in names:
        ours = (tmp_path / "ours_out" / name).read_bytes()
        assert ours == (tmp_path / "ref_out" / name).read_bytes()


def test_score_container_average_matches_jax(psds_data):
    ours_s, ref_s, _, _ = psds_data
    pick = list(ours_s)[:3]

    def containers(mod, clips, scale):
        return mod.ScoreContainer(CLASSES, {k: type(clips[k])(clips[k].scores * scale,
                                                              clips[k].timestamps, CLASSES)
                                            for k in pick})

    ours = postprocess.score_average(["cat", "dog"], [containers(postprocess, ours_s, s)
                                                      for s in (1.0, 0.5, 0.25)])
    ref = jax_post.score_average(["cat", "dog"], [containers(jax_post, ref_s, s)
                                                  for s in (1.0, 0.5, 0.25)])
    _same_clips(ours.scores, ref.scores)


def test_ground_truth_and_duration_tables_match_jax(tmp_path):
    (tmp_path / "gt.tsv").write_text(
        "filename\tonset\toffset\tevent_label\n"
        "a.wav\t0.5\t2.25\tcat\nb.wav\t\t\t\na.wav\t3\t4.125\tdog\nc.wav\t1.0\t9.5\talarm\n")
    (tmp_path / "dur.tsv").write_text("filename\tduration\na.wav\t10.0\nb.wav\t7.5\nc.wav\t10\n")
    assert (common.load_ground_truth(str(tmp_path / "gt.tsv"))
            == jax_common.load_ground_truth(str(tmp_path / "gt.tsv")))
    assert (common.load_durations(str(tmp_path / "dur.tsv"))
            == jax_common.load_durations(str(tmp_path / "dur.tsv")))


# -- the port builds only from its own sources --------------------------------

JAX_PATH = re.compile(r"transformer4sed_tpu(?!_torch)\b")


def _code_strings(path: Path):
    """String constants of a module's code, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


def test_port_names_no_path_of_the_jax_package():
    pkg = ROOT / "transformer4sed_tpu_torch"
    sources = [p for p in sorted(pkg.rglob("*.py")) if "_build" not in p.relative_to(pkg).parts]
    assert len(sources) > 40
    for path in sources:
        for text in _code_strings(path):
            assert not JAX_PATH.search(text), (path, text)
    # C and C++ sources include only the port's own headers
    native = sorted(pkg.rglob("*.cpp")) + sorted(pkg.rglob("*.cu")) + sorted(pkg.rglob("*.cuh"))
    for path in native:
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert (path.parent / inc).exists() and "transformer4sed_tpu" not in inc, (path, inc)
    from transformer4sed_tpu_torch.native import build

    for name in ("psds_core", "wav_core"):
        src = build.SRC_DIR / f"{name}.cpp"
        assert src.exists() and pkg in src.parents
    assert build.BUILD_DIR == pkg / "_build"
