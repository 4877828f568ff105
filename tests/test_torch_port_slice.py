"""The port's serving slice, held against the JAX package on the CPU.

Frontend, median filter, the whole tiny PaSST_SED (strong, weak, at_out),
the weight bridge both ways, and the serving engine end to end. The JAX
model is never initialised (flax ``init`` of even the tiny config takes
seconds): the port model is seeded, its state dict goes through the JAX
package's ``convert_torch_checkpoint``, and those params come back into
a fresh port model through the port's own ``load_jax_params``. Inputs
come from numpy with a seed; everything compares in float32.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.core.codec import LabelCodec as JaxCodec
from transformer4sed_tpu.core.filters import apply_class_filter as jax_class_filter
from transformer4sed_tpu.frontend.mel import PasstFrontend as JaxFrontend
from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxSED
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.core.filters import apply_class_filter
from transformer4sed_tpu_torch.data.audio_io import pad_wav
from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.recipes.serve import InferenceEngine
from transformer4sed_tpu_torch.utils.device import resolve_device
from transformer4sed_tpu_torch.utils.weights import init_weights_, load_jax_params
from tests.torch_port_jax import jit0

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(
    class_num=2, embed_dim=32, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
    decoder_num_heads=4, passt_feature_layer=2, decoder_layer_num=1,
    decoder_pos_emd_len=120, at_adapter=True, at_adapter_heads=4,
)
SR, CLIP = 32000, 38400  # 1.2-s clips -> 120 frames
# model outputs after a dozen f32 matmuls, summed in another order: the
# bound of tests/test_torch_parity.py
ATOL_MODEL = 5e-5
# normalised log-mel: the STFT is pocketfft here and a DFT matmul in the
# JAX package, and log(x + 1e-5) magnifies relative error near silence
ATOL_MEL = 1e-4
WIDTHS = [5, 20]  # odd and even median windows


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    """(seeded port model, port model reloaded from JAX params, JAX params, JAX model)."""
    port = init_weights_(PaSST_SED(**TINY, device="cpu"), seed=0).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, _ = convert_torch_checkpoint(sd, "PaSST_SED", init_kwargs=TINY)
    reloaded = load_jax_params(PaSST_SED(**TINY, device="cpu"), params).eval()
    return port, reloaded, params, JaxSED(**TINY, use_flash=True)


@pytest.fixture(scope="module")
def jax_forward(tiny):
    """JAX mel [2, 128, 120] + pad mask -> SEDOutput, jitted once for the
    module (eager flax apply compiles op by op, ~10x slower here)."""
    _, _, params, jmodel = tiny
    return jit0(lambda mel, pm: jmodel.apply({"params": params}, mel, pad_mask=pm, temp_w=0.5))


@pytest.fixture(scope="module")
def jax_logmel():
    fe = JaxFrontend()
    return jit0(lambda wav: fe.normalize(fe(wav)))


def _waves(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(CLIP) / SR
    waves = []
    for i in range(n):
        w = 0.1 * rng.randn(CLIP) + np.sin(2 * np.pi * (440 + 220 * i) * t) * (t > 0.3 * i)
        waves.append(w.astype(np.float32))
    return waves


def test_frontend_matches_jax(jax_logmel):
    wav = np.stack(_waves(2, seed=1))
    wav[1, :9600] = 0.0  # leading silence
    ours = PasstFrontend(device="cpu")
    ours = ours.normalize(ours(torch.from_numpy(wav)))
    ref = jax_logmel(jnp.asarray(wav))
    assert ours.shape == (2, 128, 120)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL_MEL)


def test_class_filter_matches_jax_median():
    scores = np.random.RandomState(2).rand(2, 120, 2).astype(np.float32)
    ours = apply_class_filter(torch.from_numpy(scores), WIDTHS)
    ref = jax_class_filter(jnp.asarray(scores), WIDTHS, kind="median")
    # a selection and at most one mean of two values: equal to an f32 ulp
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_weights_round_trip_exactly(tiny):
    port, reloaded, _, _ = tiny
    a, b = port.state_dict(), reloaded.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_load_jax_params_raises_on_missing_or_extra_keys(tiny):
    _, _, params, _ = tiny
    short = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    del short["classifier"]
    with pytest.raises(KeyError, match="classifier"):
        load_jax_params(PaSST_SED(**TINY, device="cpu"), short)
    extra = dict(params, mask_token=np.zeros((1, 1, 32), np.float32))
    with pytest.raises(KeyError, match="mask_token"):
        load_jax_params(PaSST_SED(**TINY, device="cpu"), extra)


def test_tiny_passt_sed_matches_jax(tiny, jax_forward):
    _, reloaded, _, _ = tiny
    mel = (np.random.RandomState(3).randn(2, 128, 120) * 0.5).astype(np.float32)
    ref = jax_forward(jnp.asarray(mel), jnp.zeros((2, 120), bool))
    with torch.no_grad():
        ours = reloaded(torch.from_numpy(mel), temp_w=0.5)
    assert ours.strong.shape == (2, 2, 120) and ours.weak.shape == (2, 2)
    for name in ("strong", "weak", "at_out"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=ATOL_MODEL, err_msg=name)


def test_inference_engine_matches_jax_pipeline(tiny, jax_forward, jax_logmel):
    port = tiny[0]
    labels = ("beep", "noise")
    codec = LabelCodec(labels, audio_len=1.2, frame_len=1024, frame_hop=320, sr=SR)
    jcodec = JaxCodec(labels, audio_len=1.2, frame_len=1024, frame_hop=320, sr=SR)
    waves = _waves(3, seed=4)
    waves[2] = waves[2][:22400]  # one 0.7-s clip
    clips = [pad_wav(w, CLIP, codec) for w in waves]
    batches = [
        {"wav": np.stack([c[0] for c in clips[i:i + 2]]),
         "pad_mask": np.stack([c[1] for c in clips[i:i + 2]]),
         "filename": [f"clip{j}.wav" for j in range(i, min(i + 2, 3))]}
        for i in (0, 2)
    ]
    engine = InferenceEngine(port, PasstFrontend(device="cpu"), codec, median_filter=WIDTHS,
                             batch_size=2, model_kwargs={"temp_w": 0.5}, device="cpu")
    served = list(engine.score_batches(batches))
    assert [names for names, _, _ in served] == [["clip0.wav", "clip1.wav"], ["clip2.wav"]]

    for (names, scores, weak), batch in zip(served, batches):
        n = len(names)
        wav, pm = batch["wav"], batch["pad_mask"]
        if n < 2:  # the engine's ragged-tail padding
            wav = np.concatenate([wav, np.zeros_like(wav)])
            pm = np.concatenate([pm, np.ones_like(pm)])
        out = jax_forward(jax_logmel(jnp.asarray(wav)), jnp.asarray(pm))
        ref_scores = np.asarray(jax_class_filter(out.strong.transpose(0, 2, 1), WIDTHS))[:n]
        np.testing.assert_allclose(scores, ref_scores, atol=ATOL_MODEL)
        np.testing.assert_allclose(weak, np.asarray(out.weak)[:n], atol=ATOL_MODEL)
        # no score sits so near the threshold that the tolerance could flip it
        assert np.min(np.abs(ref_scores - 0.5)) > 10 * ATOL_MODEL
        for i in range(n):
            assert engine.decode(scores[i]) == jcodec.decode_strong(
                (ref_scores[i] > 0.5).astype(np.float32))
    assert np.all(served[1][1][0, 80:] == 0.0)  # padded frames past the widest window


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PasstFrontend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PaSST_SED(**TINY)
    model = PaSST_SED(**TINY, device="cpu")
    codec = LabelCodec(("a", "b"), audio_len=1.2, frame_len=1024, frame_hop=320, sr=SR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, PasstFrontend(device="cpu"), codec, [5, 5])


# the JAX stack, and the JAX package's host libraries the card's machine lacks
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml"}


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    pkg = ROOT / "transformer4sed_tpu_torch"
    files = [p for p in sorted(pkg.rglob("*.py"))
             if "_build" not in p.relative_to(pkg).parts]  # build outputs, not sources
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    assert {pkg / "recipes" / f"{m}.py" for m in ("cli", "common", "matsed", "serve", "infer",
                                                   "stream", "export")} | {
        pkg / "utils" / f"{m}.py" for m in ("checkpoint", "logging")} | {
        pkg / "pmam" / f"{m}.py" for m in ("__init__", "features", "gmm", "pseudo_labels",
                                           "train")} | {pkg / "models" / "lora.py"} <= set(files)
    for path in files:
        for name in _top_level_imports(path):
            assert name not in FORBIDDEN and name != "transformer4sed_tpu", (path, name)
