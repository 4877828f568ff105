"""The port's serving entry points (``recipes/serve.py``, ``infer.py``,
``stream.py``, ``export.py``) and the kernels' custom ops, held against the
JAX package on the CPU.

A tiny PaSST_SED (``tests/test_torch_port_recipes.py:TINY``) with seeded
port weights, saved as an upstream-style ``.pt`` state dict, serves a
directory of 1.2-s clips through the port's ``serve.main --device cpu`` and
the JAX package's ``serve.main`` on the same file; ``infer_clip``,
``infer_long_audio`` and ``StreamingScorer`` meet their JAX counterparts on
the same audio. The JAX side runs on a worker thread from the module's
start, each program compiled once (``tests/torch_port_jax.py:jit0``) at two
batch shapes, 1 and 3. Everything is float32.
"""

import concurrent.futures
import json
import unittest.mock
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transformer4sed_tpu.recipes import infer as jax_infer
from transformer4sed_tpu.recipes import serve as jax_serve
from transformer4sed_tpu.recipes import stream as jax_stream
from transformer4sed_tpu.recipes.cli import build_model as jax_build_model
from transformer4sed_tpu.recipes import common as jax_common
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint, load_torch_state_dict
from transformer4sed_tpu_torch.kernels import flash_attention as fa
from transformer4sed_tpu_torch.kernels import window_attention as wa
from transformer4sed_tpu_torch.kernels import xl_attention as xa
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.parallel import multihost
from transformer4sed_tpu_torch.recipes import cli, export, infer, serve, stream
from transformer4sed_tpu_torch.utils.checkpoint import save_params
from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
from transformer4sed_tpu_torch.utils.weights import init_weights_
from transformer4sed_tpu_torch.utils.yamlio import safe_dump
from tests.test_torch_port_recipes import TINY
from tests.torch_port_jax import jit0

SR = 32000
CLIP_SECONDS = 1.2
N_SAMPLES = int(SR * CLIP_SECONDS)
CLASSES = ["beep", "noise"]
BATCH = 3  # five clips: a full batch and a ragged one of two
HOP_SECONDS = 0.24  # the stream's window hop (on the window's 120-frame grid)
THRESHOLD = 0.5
# the port's and the JAX model's outputs on the same weights: the bound of
# tests/test_torch_port_slice.py:ATOL_MODEL (a dozen f32 matmuls summed in
# another order)
ATOL_MODEL = 5e-5
# TINY's heads are 8 wide, so its attention takes the head-major family:
# rows 3 and 9. The exported artifact is checked on the same network at
# head dim 64, whose attention is rows 1 and 2.
TINY_D64 = dict(TINY, embed_dim=64, decoder_dim=64, backbone_num_heads=1, decoder_num_heads=1,
                at_adapter_heads=1)


def serve_config(init_kwargs):
    """What the serving entry points read of a config: features, classes,
    median windows, the model and its forward kwargs."""
    return {
        "generals": {"num_workers": 2},
        "model_name": "PaSST_SED",
        "feature": {"pred_len": 120, "sr": SR, "hopsize": 320, "n_fft": 1024,
                    "audio_max_len": CLIP_SECONDS, "net_subsample": 1},
        "dataset": {"labels": CLASSES},
        "training": {"median_window": [5, 20]},
        "PaSST_SED": {"init_kwargs": {**init_kwargs, "at_adapter": True},
                      "test_kwargs": {"temp_w": 0.5}},
    }


def _audio(n, rng):
    wav = 0.02 * rng.randn(n)
    on = rng.randint(0, max(n - SR // 2, 1))
    wav[on:on + SR // 2] += 0.3 * np.sin(2 * np.pi * 880 * np.arange(SR // 2) / SR)[:n - on]
    return wav.astype(np.float32)


def _write_wav(path, wav):
    wavfile.write(path, SR, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Five clips (one 0.8 s long), a 2.4-s file, the configs and the seeded
    weights as ``.pt`` state dicts and port checkpoints."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.RandomState(5)
    (root / "clips").mkdir()
    for i in range(5):
        _write_wav(root / "clips" / f"c{i}.wav",
                   _audio(int(0.8 * SR) if i == 3 else N_SAMPLES, rng))
    # 2.4 s: three windows at the default stride (half a window), the serving batch
    long = np.concatenate([_audio(N_SAMPLES, rng) for _ in range(2)])
    _write_wav(root / "long.wav", long)
    out = {"root": root, "clips": root / "clips", "long": root / "long.wav"}
    for tag, kwargs, seed in (("tiny", TINY, 3), ("d64", TINY_D64, 4)):
        model = init_weights_(PaSST_SED(**kwargs, at_adapter=True, device="cpu"), seed=seed)
        torch.save(model.state_dict(), root / f"{tag}.pt")
        save_params(str(root / f"{tag}.ckpt"), model.state_dict())
        (root / f"{tag}.yaml").write_text(safe_dump(serve_config(kwargs)))
        out[tag] = {k: str(root / f"{tag}.{k}") for k in ("pt", "ckpt", "yaml")}
    return out


def _read_wav(path):
    return wavfile.read(path)[1].astype(np.float32) / 32767


# -- the JAX side, on a worker thread ---------------------------------------------


class _Jax0:
    """``jax`` with ``jit`` compiling each signature once at OPT0 (the JAX
    engine's and streamer's programs)."""

    jit = staticmethod(jit0)

    def __getattr__(self, name):
        return getattr(jax, name)


class _JitModel:
    """A flax model whose ``apply`` is compiled once a shape (the JAX
    ``infer_*`` functions call ``model.apply`` eagerly)."""

    def __init__(self, model, kwargs):
        self.call = jit0(lambda variables, mel, pm: model.apply(variables, mel, pad_mask=pm,
                                                                **kwargs))

    def apply(self, variables, mel, pad_mask=None, **_):
        return self.call(variables, mel, pad_mask)


class _JitFrontend:
    def __init__(self, frontend):
        self.call, self.normalize = jit0(frontend.__call__), jit0(frontend.normalize)

    def __call__(self, wav):
        return self.call(wav)


def _jax_side(files):
    """JAX ``serve.main`` on the clips, ``infer_clip`` on clip 0,
    ``infer_long_audio`` on the long file and ``StreamingScorer`` on it in
    chunks of 0.3 s."""
    tiny, root = files["tiny"], files["root"]
    with unittest.mock.patch.object(jax_serve, "jax", _Jax0()):
        jax_serve.main(["--config_dir", tiny["yaml"], "--ckpt", tiny["pt"], "--wav_dir",
                        str(files["clips"]), "--out_dir", str(root / "jax_served"),
                        "--batch_size", str(BATCH), "--threshold", str(THRESHOLD)])
    config = serve_config(TINY)
    codec = jax_common.codec_from_config(config)
    widths = jax_common.median_filter_from_config(config, codec)
    model, frontend = jax_build_model(config)
    params, _ = convert_torch_checkpoint(load_torch_state_dict(tiny["pt"]), "PaSST_SED",
                                         init_kwargs={**TINY, "at_adapter": True})
    kwargs = config["PaSST_SED"]["test_kwargs"]
    jmodel, jfront = _JitModel(model, kwargs), _JitFrontend(frontend)
    clip = _read_wav(files["clips"] / "c0.wav")
    long = _read_wav(files["long"])
    out = {
        "clip": jax_infer.infer_clip(jmodel, jfront, params, clip, codec, THRESHOLD, widths),
        "long": jax_infer.infer_long_audio(jmodel, jfront, params, long, codec, THRESHOLD,
                                           widths),
    }
    with unittest.mock.patch.object(jax_stream, "jax", _Jax0()):
        scorer = jax_stream.StreamingScorer(model, frontend, params, codec, HOP_SECONDS, widths,
                                            kwargs)
        chunk = int(0.3 * SR)
        out["stream"] = list(scorer.stream(long[i:i + chunk] for i in range(0, len(long), chunk)))
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_side(files):
    """:func:`_jax_side` on a worker thread, started before the module's
    first test: the tests without JAX run while it compiles."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_jax_side, files)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def port_model(files):
    return cli.serving_model(load_yaml_with_include(files["tiny"]["yaml"]), files["tiny"]["pt"],
                             torch.device("cpu"))


def _serve(files, out_dir, *args):
    assert serve.main(["--wav_dir", str(files["clips"]), "--out_dir", str(out_dir),
                       "--batch_size", str(BATCH), "--device", "cpu", *args]) == 0
    return _read_served(out_dir)


def _read_served(out_dir):
    """({clip: scores [T, C]}, {clip: TSV text}, events.jsonl lines)."""
    tsvs = sorted(Path(out_dir).glob("*.tsv"))
    scores = {p.stem: np.loadtxt(p, delimiter="\t", skiprows=1)[:, 2:] for p in tsvs}
    texts = {p.stem: p.read_text() for p in tsvs}
    lines = (Path(out_dir) / "events.jsonl").read_text().splitlines()
    return scores, texts, lines


# -- the kernels' ops ---------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 7, 3 * 128, generator=g)
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    bu, bv = torch.randn(2, 64, generator=g), torch.randn(2, 64, generator=g)
    p = torch.randn(2, 13, 64, generator=g)
    heads = [x.unflatten(-1, (4, 32)).transpose(1, 2) for x in (q, k, v)]
    p4 = torch.randn(4, 13, 32, generator=g)
    win = torch.randn(4, 16, 3 * 16, generator=g)
    wq, wk, wv = (win[..., 16 * i:16 * (i + 1)].unflatten(-1, (2, 8)) for i in range(3))
    bias, mask = torch.randn(2, 16, 16, generator=g), torch.randn(2, 16, 16, generator=g)
    return {
        "flash_nhd_fwd": (fa.flash_nhd_fwd, fa.flash_attention_nhd_reference, (q, k, v, 2, 0.125)),
        "xl_nhd_fwd": (xa.xl_nhd_fwd, xa.xl_attention_nhd_reference,
                       (q, k, v, bu, bv, p, 2, 0.125, [3, 5])),
        "xl_hm_fwd": (xa.xl_hm_fwd, xa.flash_xl_attention_reference,
                      (heads[0], heads[0] + 1, heads[1], heads[2], p4, 0.2, None)),
        "window_fwd": (wa.window_fwd, wa.window_attention_plain,
                       (wq, wk, wv, bias, mask, 2, 0.3)),
    }


@pytest.mark.parametrize("name", ["flash_nhd_fwd", "xl_nhd_fwd", "xl_hm_fwd", "window_fwd"])
def test_kernel_op_passes_opcheck_and_its_cpu_kernel_is_the_plain_version(name):
    op, plain, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    assert torch.equal(op(*args), plain(*args))


# -- export ---------------------------------------------------------------------------

PLAIN_ATTENTION = [(fa, "flash_attention_nhd_reference"), (fa, "flash_attention_reference"),
                   (fa, "flash_attention_bias_reference"), (xa, "xl_attention_nhd_reference"),
                   (xa, "flash_xl_attention_reference"), (wa, "window_attention_plain")]


def test_exported_artifact_serves_what_the_config_and_checkpoint_serve(files, tmp_path,
                                                                       monkeypatch):
    """``export.main --device cpu`` at head dim 64, with every plain
    attention version made to raise while it traces: the program calls
    rows 1 and 2's ops, once per attention layer, and ``serve.main
    --exported`` writes the TSVs and events of ``--config_dir/--ckpt``
    bitwise."""
    cfg = files["d64"]
    art = str(tmp_path / "d64.pt2")
    with monkeypatch.context() as m:
        for module, name in PLAIN_ATTENTION:
            m.setattr(module, name, unittest.mock.Mock(side_effect=AssertionError(name)))
        assert export.main(["--config_dir", cfg["yaml"], "--ckpt", cfg["ckpt"], "--out", art,
                            "--batch_size", str(BATCH), "--device", "cpu"]) == 0
    program, meta = export.load_exported(art)
    calls = [str(n.target) for n in program.graph.nodes if str(n.target).startswith("t4s.")]
    assert sorted(calls) == ["t4s.flash_nhd_fwd.default"] * 2 + ["t4s.xl_nhd_fwd.default"]
    assert meta["batch_size"] == BATCH and meta["labels"] == CLASSES and "torch_version" in meta
    direct = _serve(files, tmp_path / "direct", "--config_dir", cfg["yaml"], "--ckpt", cfg["pt"])
    exported = _serve(files, tmp_path / "exported", "--exported", art)
    assert exported[1] == direct[1] and exported[2] == direct[2]


# -- errors ----------------------------------------------------------------------------


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(files, tmp_path, capsys):
    """Without ``--device cpu`` on a host without a card each entry point
    raises before it writes anything; ``--lora_ckpt`` loads (the tiny model
    has no LoRA layer, so either policy serves the ``.pt``'s weights as they
    are); ``--query`` on a network without queries is refused; an orbax
    directory is refused by name."""
    cfg = files["tiny"]
    common = ["--config_dir", cfg["yaml"], "--ckpt", cfg["pt"]]
    if not torch.cuda.is_available():
        for main, args in ((serve.main, ["--wav_dir", str(files["clips"]), "--out_dir",
                                         str(tmp_path / "x")]),
                           (infer.main, ["--wav", str(files["long"]), "--long"]),
                           (stream.main, ["--wav", str(files["long"])]),
                           (export.main, ["--out", str(tmp_path / "x.pt2")])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                main(common + args)
        assert not list(tmp_path.iterdir())
    out = ["--wav_dir", str(files["clips"]), "--out_dir", str(tmp_path / "y"), "--device", "cpu"]
    plain = _serve(files, tmp_path / "plain", *common)
    for policy in ("merged", "unmerged"):
        served = _serve(files, tmp_path / policy, *common, "--lora_ckpt", policy)
        assert served[1] == plain[1] and served[2] == plain[2]
    capsys.readouterr()
    with pytest.raises(SystemExit):
        serve.main(common + out + ["--query", "q.npy"])
    assert "--query serves an open-vocabulary DASM" in capsys.readouterr().err
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        serve.main(["--config_dir", cfg["yaml"], "--ckpt", str(tmp_path / "orbax")] + out)


# -- serve ------------------------------------------------------------------------


def test_serve_reads_a_port_checkpoint_as_its_pt(files, tmp_path):
    cfg = files["tiny"]
    a = _serve(files, tmp_path / "pt", "--config_dir", cfg["yaml"], "--ckpt", cfg["pt"])
    b = _serve(files, tmp_path / "ckpt", "--config_dir", cfg["yaml"], "--ckpt", cfg["ckpt"])
    assert a[1] == b[1] and a[2] == b[2]


def test_strided_rank_split_merges_to_one_ranks_output(files, port_model, tmp_path,
                                                       monkeypatch):
    """Two ranks' strided shares (clips 0, 2, 4 and 1, 3), each scored alone
    and merged by ``merge_strided``, equal one rank's lines and TSVs."""
    s = port_model
    engine = serve.InferenceEngine(s.model, s.frontend, s.codec, s.median_filter,
                                   batch_size=2, model_kwargs=s.model_kwargs, device="cpu")
    one = serve.score_directory(engine, str(files["clips"]), str(tmp_path), 2, 0)
    parts = []
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for rank in (0, 1):
        monkeypatch.setattr(multihost, "process_index", lambda rank=rank: rank)
        (tmp_path / f"r{rank}").mkdir()
        parts.append(serve.score_directory(engine, str(files["clips"]), str(tmp_path / f"r{rank}"),
                                           2, 0))
    assert [len(p) for p in parts] == [3, 2]
    assert serve.merge_strided(parts) == one
    for rank, part in enumerate(parts):
        for line in part:
            stem = json.loads(line)["filename"][:-4]
            assert (tmp_path / f"r{rank}" / f"{stem}.tsv").read_text() == (
                tmp_path / f"{stem}.tsv").read_text()


# -- against the JAX package (its worker thread runs while the tests above do) -----


def test_serve_main_matches_jax_serve_main(files, jax_side, tmp_path):
    """The same ``.pt``: the TSVs' frame edges equal and their scores within
    ATOL_MODEL, the events equal (no filtered score lies within ATOL_MODEL
    of the threshold), five clips in two batches, the ragged one padded."""
    cfg = files["tiny"]
    got, got_text, got_lines = _serve(files, tmp_path / "port", "--config_dir", cfg["yaml"],
                                      "--ckpt", cfg["pt"], "--threshold", str(THRESHOLD))
    jax_side.result()
    want, want_text, want_lines = _read_served(files["root"] / "jax_served")
    assert sorted(got) == sorted(want) == [f"c{i}" for i in range(5)]
    near = 0
    for clip in want:
        np.testing.assert_allclose(got[clip], want[clip], atol=ATOL_MODEL, rtol=0, err_msg=clip)
        assert [ln.split("\t")[:2] for ln in got_text[clip].splitlines()] == [
            ln.split("\t")[:2] for ln in want_text[clip].splitlines()]
        near += int(np.sum(np.abs(want[clip] - THRESHOLD) <= ATOL_MODEL))
    assert near == 0
    assert got_lines == want_lines
    assert [json.loads(ln)["filename"] for ln in got_lines] == [f"c{i}.wav" for i in range(5)]
    assert sum(len(json.loads(ln)["events"]) for ln in got_lines) > 0
    assert np.all(got["c3"][80 + 10:] == 0.0)  # the 0.8-s clip's padded frames


def test_infer_clip_matches_jax(files, port_model, jax_side):
    s = port_model
    clip = _read_wav(files["clips"] / "c0.wav")
    events, strong, weak = infer.infer_clip(s.model, s.frontend, clip, s.codec, THRESHOLD,
                                            s.median_filter, s.model_kwargs)
    want_events, want_strong, want_weak = jax_side.result()["clip"]
    np.testing.assert_allclose(strong, np.asarray(want_strong), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(weak, np.asarray(want_weak), atol=ATOL_MODEL, rtol=0)
    assert events == want_events


def test_infer_long_audio_matches_jax(files, port_model, jax_side):
    """Three windows of the 2.4-s file in one forward, overlap-added into
    three 1-s segments (the last one 0.4 s)."""
    s = port_model
    events, segs = infer.infer_long_audio(s.model, s.frontend, _read_wav(files["long"]), s.codec,
                                          THRESHOLD, s.median_filter,
                                          model_kwargs=s.model_kwargs)
    want_events, want_segs = jax_side.result()["long"]
    assert segs.shape == (3, 2)
    np.testing.assert_allclose(segs, want_segs, atol=ATOL_MODEL, rtol=0)
    assert np.min(np.abs(want_segs - THRESHOLD)) > ATOL_MODEL
    assert events == want_events


def test_streaming_scorer_matches_jax_and_any_chunking(files, port_model, jax_side):
    """JAX's rows on the same chunks (0.3 s) within ATOL_MODEL at the same
    onsets; the port's rows bitwise the same under chunks of 0.7 s."""
    s = port_model
    long = _read_wav(files["long"])

    def rows(chunk_s):
        scorer = stream.StreamingScorer(s.model, s.frontend, s.codec, HOP_SECONDS,
                                        s.median_filter, s.model_kwargs)
        chunk = int(chunk_s * SR)
        return list(scorer.stream(long[i:i + chunk] for i in range(0, len(long), chunk)))

    got, other = rows(0.3), rows(0.7)
    want = jax_side.result()["stream"]
    assert len(got) == len(want) == 240
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose(np.stack([r for _, r in got]), np.stack([r for _, r in want]),
                               atol=ATOL_MODEL, rtol=0)
    assert [t for t, _ in other] == [t for t, _ in got]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(other, got))
