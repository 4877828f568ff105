"""The port's data layer and config reader, held against the JAX package on
the CPU.

TSV tables against pandas, WAV and FLAC decoding on the Python path (bit
for bit) and the native one (the same C++ source), datasets, samplers and
the threaded loader (identical batches from the same TSVs and seeds), the
scaler across a carried ``state_dict``, and the YAML reader against
PyYAML on every shipped config. FLAC streams come from
``tests/test_flac.py``'s encoder.
"""

import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from scipy.io import wavfile

from tests.test_flac import encode_flac
from transformer4sed_tpu.core.codec import LabelCodec as JaxCodec
from transformer4sed_tpu.data import audio_io as jax_audio
from transformer4sed_tpu.data import datasets as jax_datasets
from transformer4sed_tpu.data import loader as jax_loader
from transformer4sed_tpu.data import sampler as jax_sampler
from transformer4sed_tpu.data.scaler import Scaler as JaxScaler
from transformer4sed_tpu.utils import config as jax_config
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.data import audio_io, datasets, loader, sampler
from transformer4sed_tpu_torch.data.scaler import Scaler
from transformer4sed_tpu_torch.data.tsv import read_tsv, write_tsv
from transformer4sed_tpu_torch.native.build import load_wav_core
from transformer4sed_tpu_torch.utils import config
from transformer4sed_tpu_torch.utils.yamlio import safe_dump, safe_load

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "config").glob("*/*.yaml"))
SR = 32000
LABELS = ("alarm", "cat", "dog")
CODEC_ARGS = dict(audio_len=0.5, frame_len=1024, frame_hop=320, sr=SR)  # 50 frames
PAD_TO = 16000
# native decoder against the Python path at the target rate: float32 of the
# same integer over the same power of two, mono means summed in another
# order (tests/test_native_wav.py's bound)
NATIVE_ATOL = 1e-6


def tone(n, seed, ch=1):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    x = 0.4 * np.sin(2 * np.pi * (300 + 200 * seed) * t)[:, None] + 0.05 * rng.randn(n, ch)
    return x[:, 0] if ch == 1 else x


def write_audio(path: Path, kind: str, seed: int) -> Path:
    if kind == "pcm16":
        wavfile.write(path, SR, (tone(12000, seed) * 32767).astype(np.int16))
    elif kind == "float_stereo":
        wavfile.write(path, SR, tone(14000, seed, ch=2).astype(np.float32))
    elif kind == "pcm16_44k":
        wavfile.write(path, 44100, (tone(18000, seed) * 32767).astype(np.int16))
    elif kind == "flac_lpc":
        sig = np.round(tone(9000, seed) * 12000).astype(np.int64)
        path.write_bytes(encode_flac(sig, SR, kind="lpc",
                                     lpc={"coef": [3, -2], "shift": 1, "precision": 5}))
    elif kind == "flac_stereo":
        sig = np.round(tone(8192, seed, ch=2) * 12000).astype(np.int64)
        path.write_bytes(encode_flac(sig, SR, kind="fixed2", stereo="mid_side"))
    elif kind == "flac_3bit":  # 3 bits a sample: the native decoder refuses it
        sig = np.random.RandomState(seed).randint(-4, 4, 5000)
        path.write_bytes(encode_flac(sig, SR, bps=3))
    return path


KINDS = ["pcm16", "float_stereo", "pcm16_44k", "flac_lpc", "flac_stereo"]


def test_read_tsv_matches_pandas(tmp_path):
    path = tmp_path / "t.tsv"
    path.write_text("filename\tonset\toffset\tevent_label\tn\n"
                    "b.wav\t0.5\t2.25\tcat\t3\na.wav\t\t\t\t4\n"
                    "b.wav\t1e-3\t7\tNA\t5\nc.wav\t3.125\t9.5\tdog\t6\n")
    ours, ref = read_tsv(str(path)), pd.read_csv(path, sep="\t")
    assert ours.columns == list(ref.columns) and len(ours) == len(ref)
    for name in ref.columns:
        a, b = ours[name], ref[name].to_numpy()
        if not pd.api.types.is_numeric_dtype(ref[name]):
            assert [x if isinstance(x, str) else "nan" for x in a] == [
                x if isinstance(x, str) else "nan" for x in b]
        else:
            np.testing.assert_array_equal(a, b.astype(np.float64))
    assert [k for k, _ in ours.groupby("filename")] == [k for k, _ in ref.groupby("filename")]
    header_only = tmp_path / "h.tsv"
    header_only.write_text("filename\tduration\n")
    assert len(read_tsv(str(header_only))) == 0 and read_tsv(str(header_only)).columns == [
        "filename", "duration"]


def test_write_tsv_matches_pandas(tmp_path):
    table = np.array([[0.0, 0.1, 1e-5, 123456789.123], [1 / 3, np.nan, -2.5, 1e20],
                      [np.float32(0.3), 5.0, 1e-300, -0.0]])
    cols = ["onset", "offset", "a", "b"]
    write_tsv(str(tmp_path / "ours.tsv"), cols, table)
    pd.DataFrame(table, columns=cols).to_csv(tmp_path / "ref.tsv", sep="\t", index=False)
    assert (tmp_path / "ours.tsv").read_bytes() == (tmp_path / "ref.tsv").read_bytes()
    # the shortest round-trip decimals read back to the same doubles
    np.testing.assert_array_equal(read_tsv(str(tmp_path / "ours.tsv")).to_numpy(), table)


@pytest.mark.parametrize("kind", KINDS)
def test_waveforms_match_jax(tmp_path, monkeypatch, kind):
    path = str(write_audio(tmp_path / f"x.{'flac' if 'flac' in kind else 'wav'}", kind, 1))
    codec, jcodec = LabelCodec(LABELS, **CODEC_ARGS), JaxCodec(LABELS, **CODEC_ARGS)
    before = dict(audio_io.DECODES)
    native = audio_io.waveform_modification(path, PAD_TO, codec)
    python = audio_io.waveform_modification(path, PAD_TO, codec, native=False)
    assert audio_io.DECODES["native"] == before.get("native", 0) + 1
    assert audio_io.DECODES["python"] == before.get("python", 0) + 1
    jax_native = jax_audio.waveform_modification(path, PAD_TO, jcodec)
    monkeypatch.setenv("T4S_DISABLE_NATIVE_WAV", "1")
    jax_python = jax_audio.waveform_modification(path, PAD_TO, jcodec)
    for ours, ref in ((native, jax_native), (python, jax_python)):
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(native[1], python[1])
    if kind != "pcm16_44k":  # the native resampler is a windowed sinc, not resample_poly
        np.testing.assert_allclose(native[0], python[0], atol=NATIVE_ATOL, rtol=0)
    assert native[1].any() and not native[1].all()  # padded to PAD_TO


def test_load_wav_batch_matches_jax_and_redoes_refused_files(tmp_path):
    kinds = KINDS + ["flac_3bit"]
    paths = [str(write_audio(tmp_path / f"{i}.{'flac' if 'flac' in k else 'wav'}", k, i))
             for i, k in enumerate(kinds)]
    codec, jcodec = LabelCodec(LABELS, **CODEC_ARGS), JaxCodec(LABELS, **CODEC_ARGS)
    assert load_wav_core() is not None, "g++ is here: the native loader must build"
    before = dict(audio_io.DECODES)
    ours = audio_io.load_wav_batch(paths, PAD_TO, codec, n_threads=2)
    assert audio_io.DECODES["native"] == before.get("native", 0) + len(kinds) - 1
    assert audio_io.DECODES["python"] == before.get("python", 0) + 1  # the 3-bit FLAC
    ref = jax_audio.load_wav_batch(paths, PAD_TO, jcodec, n_threads=2)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    fallback = audio_io.load_wav_batch(paths, PAD_TO, codec, native=False)
    np.testing.assert_array_equal(fallback[1], ours[1])
    np.testing.assert_allclose(np.delete(fallback[0], 2, 0), np.delete(ours[0], 2, 0),
                               atol=NATIVE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def mini_split(tmp_path_factory):
    """Four clips (one stereo, one 44.1 kHz), strong / weak TSVs, an
    unlabeled folder and per-clip frame-label TSVs."""
    root = tmp_path_factory.mktemp("split")
    (root / "audio").mkdir()
    kinds = ["pcm16", "float_stereo", "pcm16_44k", "pcm16"]
    for i, kind in enumerate(kinds):
        write_audio(root / "audio" / f"c{i}.wav", kind, i)
    (root / "strong.tsv").write_text(
        "filename\tonset\toffset\tevent_label\n"
        "c2.wav\t0.1\t0.3\tcat\nc0.wav\t0.0\t0.25\tdog\nc1.wav\t\t\t\n"
        "c0.wav\t0.2\t0.45\talarm\nc3.wav\t0.05\t0.5\tcat\n")
    (root / "weak.tsv").write_text("filename\tevent_labels\nc1.wav\tcat,dog\nc0.wav\talarm\n"
                                   "c3.wav\tdog\nc2.wav\tcat\n")
    (root / "frames").mkdir()
    rng = np.random.RandomState(3)
    for i in range(4):
        t = np.arange(51) * 0.01
        table = np.concatenate([t[:-1, None], t[1:, None], rng.rand(50, 3)], axis=1)
        pd.DataFrame(table, columns=["onset", "offset", *LABELS]).to_csv(
            root / "frames" / f"c{i}.tsv", sep="\t", index=False)
    return root


def _datasets(mod, tsv, root, codec):
    return [
        mod.StronglyLabeledDataset(tsv(root / "strong.tsv"), str(root / "audio"), True, codec),
        mod.WeaklyLabeledDataset(tsv(root / "weak.tsv"), str(root / "audio"), True, codec),
        mod.UnlabeledDataset(str(root / "audio"), True, codec),
        mod.FrameWiseLabeledDataset(str(root / "frames"), str(root / "audio"), True, codec),
    ]


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_datasets_match_jax(mini_split):
    ours = _datasets(datasets, lambda p: read_tsv(str(p)), mini_split,
                     LabelCodec(LABELS, **CODEC_ARGS))
    ref = _datasets(jax_datasets, lambda p: pd.read_csv(p, sep="\t"), mini_split,
                    JaxCodec(LABELS, **CODEC_ARGS))
    for o, r in zip(ours, ref):
        assert len(o) == len(r) == 4
        for i in range(len(r)):
            _same_batch(o[i], r[i])
    assert ours[0][0]["label"].sum() > 0 and ours[0][1]["label"].sum() == 0  # c1: no events


def test_samplers_match_jax():
    for epoch in (0, 3):
        for ours, ref in ((sampler.RandomSampler(11, seed=5),
                           jax_sampler.RandomSampler(11, seed=5)),
                          (sampler.WeightedSampler(np.arange(1, 8), 20, seed=2),
                           jax_sampler.WeightedSampler(np.arange(1, 8), 20, seed=2))):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref)
    mk = lambda m: m.ConcatBatchSampler([m.RandomSampler(8, 1), m.SequentialSampler(5),
                                         m.RandomSampler(6, 2)], [2, 1, 2], epoch=1)
    assert list(mk(sampler)) == list(mk(jax_sampler)) and len(mk(sampler)) == 3


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(mini_split, workers):
    def batches(ds_mod, ld_mod, sp_mod, tsv, codec):
        strong, weak, unlabeled, _ = _datasets(ds_mod, tsv, mini_split, codec)
        bs = sp_mod.ConcatBatchSampler([sp_mod.RandomSampler(4, seed=7),
                                        sp_mod.RandomSampler(4, seed=8),
                                        sp_mod.SequentialSampler(4)], [2, 1, 1])
        train = ld_mod.DataLoader([strong, weak, unlabeled], batch_sampler=bs,
                                  num_workers=workers)
        train.set_epoch(2)
        val = ld_mod.DataLoader(strong, batch_size=3, drop_last=False, num_workers=workers,
                                process_shard_items=True)
        return list(train) + list(val)

    ours = batches(datasets, loader, sampler, lambda p: read_tsv(str(p)),
                   LabelCodec(LABELS, **CODEC_ARGS))
    ref = batches(jax_datasets, jax_loader, jax_sampler, lambda p: pd.read_csv(p, sep="\t"),
                  JaxCodec(LABELS, **CODEC_ARGS))
    assert len(ours) == len(ref) == 2 + 2
    for a, b in zip(ours, ref):
        _same_batch(a, b)


@pytest.mark.parametrize("statistic,normtype", [("dataset", "standard"), ("dataset", "mean"),
                                                ("instance", "standard"), ("instance", "mean"),
                                                ("instance", "minmax")])
def test_scaler_matches_jax_across_a_state_dict(statistic, normtype):
    rng = np.random.RandomState(4)
    fit_batches = [rng.randn(3, 8, 20).astype(np.float32) * 2 + 1 for _ in range(3)]
    x = rng.randn(2, 8, 20).astype(np.float32) * 2 + 1
    ref = JaxScaler(statistic, normtype)
    ours = Scaler(statistic, normtype)
    if statistic == "dataset":
        ref.fit(fit_batches)
        ours.load_state_dict(ref.state_dict())
        fitted = Scaler(statistic, normtype).fit([torch.from_numpy(b) for b in fit_batches])
        for k, v in ref.state_dict().items():
            np.testing.assert_allclose(fitted.state_dict()[k].numpy(), v, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(), np.asarray(ref(x)),
                               atol=1e-6, rtol=0)


def _equal(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_yaml_reader_equals_pyyaml_on_shipped_configs(path):
    text = path.read_text()
    ours = safe_load(text)
    assert _equal(ours, yaml.safe_load(text))
    if "include" in ours:
        assert _equal(config.load_yaml_with_include(str(path)),
                      jax_config.load_yaml_with_include(str(path)))


def test_shipped_configs_are_twelve_with_six_includes():
    assert len(CONFIGS) == 12
    assert sum("include" in safe_load(p.read_text()) for p in CONFIGS) == 6


TRICKY = {
    "strings": ["yes", "1e-4", "1.0e-4", "null", "a: b", "#x", "", " lead", "[x]", "it's",
                "x #y", "-x", "017", "0o17", "1_000", "1:30", "~", "2001-12-14", "=", "tab\tx",
                "line\nbreak", 'q"d', "back\\slash", "\x85"],
    "floats": [1e-4, 1e17, 0.1, -2.5, math.inf, -math.inf, 3.0, math.nan],
    "ints": [0, -7, 10 ** 20], "consts": [True, False, None],
    "nested": {"a": [[1, 2], {"k": "v", "e": {}}, []], "empty": {}, 3: "int key", "yes": 1},
}


@pytest.mark.parametrize("name", ["tricky", "finetune1"])
def test_config_writer_reads_back_under_both_readers(tmp_path, name):
    cfg = TRICKY if name == "tricky" else config.load_yaml_with_include(
        str(ROOT / "config" / "mat-sed" / "finetune1.yaml"))
    out = config.get_save_directories(cfg, str(tmp_path / "run"))["save_folder"]
    text = (Path(out) / "config.yaml").read_text()
    assert _equal(safe_load(text), cfg) and _equal(yaml.safe_load(text), cfg)
    assert safe_dump(safe_load(text)) == text


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: !!str 1\n", "a: |\n  x\n", "a: b\n  c\n",
                                  "? a\n: b\n", "---\na: 1\n", "a: 2001-12-14\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        safe_load(text)
