"""The port's HTSAT_CNN models, held against the JAX package on the CPU.

BatchNorm, the HTSAT frontend, the numpy helpers, the interpolation modes,
a tiny HTSAT (all five outputs), a tiny CNN, a tiny HTSAT_CNN in eval and
in training mode (with the new running statistics) and the serving engine;
the supervised train step is in ``tests/test_torch_port_supervised.py``.
The JAX models are never initialised: the port model is seeded and its
state dict goes through the JAX package's ``convert_torch_checkpoint``.
Inputs come from numpy with a seed; everything compares in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.core.codec import LabelCodec as JaxCodec
from transformer4sed_tpu.core.filters import apply_class_filter as jax_class_filter
from transformer4sed_tpu.models import htsat as jax_htsat
from transformer4sed_tpu.models import interpolate as jax_interp
from transformer4sed_tpu.models.cnn import CNN as JaxCNN
from transformer4sed_tpu.models.htsat_heads import HTSAT_CNN as JaxHTSATCNN
from transformer4sed_tpu.models.norm import RefBatchNorm as JaxBatchNorm
from transformer4sed_tpu.utils.torch_import import (
    convert_cnn,
    convert_htsat,
    convert_torch_checkpoint,
)
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.data.audio_io import pad_wav
from transformer4sed_tpu_torch.models import htsat, interpolate
from transformer4sed_tpu_torch.models.cnn import CNN, device_generator, draw_dropout
from transformer4sed_tpu_torch.models.htsat_heads import HTSAT_CNN
from transformer4sed_tpu_torch.models.norm import RefBatchNorm
from transformer4sed_tpu_torch.recipes.serve import InferenceEngine
from transformer4sed_tpu_torch.utils.weights import (
    init_weights_,
    jax_params_to_state_dict,
    load_jax_params,
)
from tests.torch_port_jax import jit0

# the sizes of tests/test_htsat.py:tiny_htsat, with two blocks in stage 0 so
# that one of them is shifted (resolution 16, window 4: 16 windows an image)
TINY_HTSAT = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), num_classes=7, embed_dim=16,
                  depths=(2, 1), num_heads=(2, 4), window_size=4, mel_bins=16)
TINY_CNN = dict(nb_filters=(4, 8), kernel_size=(3, 3), padding=(1, 1), stride=(1, 1),
                pooling=((2, 4), (1, 4)), activation="cg", conv_dropout=0.0)
# 32 latent frames x 2 = 64 output frames; the CNN gives 50, resized to 64
TINY = dict(class_num=5, decoder_dim=32, num_heads=4, decoder="transformerXL",
            decoder_layer_num=1, decoder_pos_emd_len=80, decoder_expand_rate=2.0,
            backbone_upsample_ratio=2, htsat_kwargs=TINY_HTSAT, cnn_param=TINY_CNN)
MEL_T, MEL_F, FRAMES = 100, 16, 64
# model outputs after a dozen f32 matmuls, summed in another order
# (tests/test_torch_port_slice.py, tests/test_torch_parity.py)
ATOL_MODEL = 5e-5
# elementwise f32 functions and small sums: a few ulps
ATOL_ELEM = 1e-6
# log-mel in dB: the STFT is pocketfft here and a DFT matmul in the JAX
# package; the normalised log-mel's bound of 1e-4 is on ln(x) / 5, and
# 10 log10(x) = 4.34 ln(x) is 21.7 times that scale
ATOL_MEL_DB = 21.7e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _mel(b, seed):
    """A [B, 1, T, F] log-mel stand-in at the dB scale's spread."""
    return (np.random.RandomState(seed).randn(b, 1, MEL_T, MEL_F) * 3.0).astype(np.float32)


# -- BatchNorm, frontend, helpers ---------------------------------------------------------


@pytest.mark.parametrize("momentum,eps", [(0.1, 1e-5), (0.99, 1e-3)])
def test_ref_batchnorm_two_training_calls_then_eval(momentum, eps):
    """Batch statistics normalise, the unbiased variance and torch's momentum
    feed the running statistics, eval uses them: bn0's and the CNN's settings."""
    rng = np.random.RandomState(0)
    xs = [(rng.randn(3, 5, 4) * 2 + 1).astype(np.float32) for _ in range(3)]
    ours = RefBatchNorm(4, momentum=momentum, eps=eps)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(rng.rand(4).astype(np.float32) + 0.5))
        ours.bias.copy_(torch.from_numpy(rng.randn(4).astype(np.float32)))
    variables = {"params": {"scale": ours.weight.detach().numpy(),
                            "bias": ours.bias.detach().numpy()},
                 "batch_stats": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}
    ref_train = JaxBatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
    ours.train()
    for x in xs[:2]:
        want, new = ref_train.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], **new}
        got = ours(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL_ELEM * 10)
    for name, stat in (("mean", ours.running_mean), ("var", ours.running_var)):
        np.testing.assert_allclose(stat.numpy(), np.asarray(variables["batch_stats"][name]),
                                   atol=ATOL_ELEM * 10, err_msg=name)
    assert int(ours.num_batches_tracked) == 2
    want = JaxBatchNorm(use_running_average=True, momentum=momentum, epsilon=eps).apply(
        variables, jnp.asarray(xs[2]))
    got = ours.eval()(torch.from_numpy(xs[2]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL_ELEM * 10)


def test_htsat_frontend_matches_jax():
    rng = np.random.RandomState(1)
    t = np.arange(16000) / 32000
    wav = np.stack([0.1 * rng.randn(16000) + np.sin(2 * np.pi * 440 * (i + 1) * t)
                    for i in range(2)]).astype(np.float32)
    fe = htsat.HTSATFrontend(device="cpu")
    got = fe.normalize(fe(torch.from_numpy(wav)))
    want = jit0(lambda w: jax_htsat.HTSATFrontend()(w))(jnp.asarray(wav))
    assert got.shape == (2, 1, 51, 64) and fe.draw_fminmax(torch.Generator()) is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MEL_DB)


@pytest.mark.parametrize("name,args", [
    ("slaney_mel_banks", (64, 1024, 32000, 50.0, 14000.0)),
    ("bicubic_resize_matrix", (1001, 1024)),
    ("bicubic_resize_matrix", (7, 16)),
    ("_relative_position_index", (8,)),
    ("_shift_attn_mask", (16, 16, 8, 4)),
    ("_shift_attn_mask", (8, 8, 8, 4)),
])
def test_htsat_numpy_helpers_equal_the_jax_package(name, args):
    """The port keeps its own copy of the JAX package's numpy helpers."""
    np.testing.assert_array_equal(getattr(htsat, name)(*args), getattr(jax_htsat, name)(*args))


def test_window_partition_and_reverse_match_jax():
    x = np.random.RandomState(2).randn(2, 8, 12, 3).astype(np.float32)
    win = htsat.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jax_htsat.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(htsat.window_reverse(win, 4, 8, 12).numpy(), x)


@pytest.mark.parametrize("t_in,t_out,mode", [
    (32, 64, "linear"), (50, 64, "linear"), (64, 50, "linear"), (250, 320, "linear"),
    (8, 256, "nearest"), (50, 64, "nearest"),
])
def test_resize_time_matches_jax(t_in, t_out, mode):
    """Integer and non-integer ratios, up and down, both modes (the CNN's
    250 -> 320 frames and the framewise output's x32 nearest)."""
    x = np.random.RandomState(t_in).randn(2, t_in, 3).astype(np.float32)
    got = interpolate.resize_time(torch.from_numpy(x), t_out, mode)
    want = jit0(lambda a: jax_interp.resize_time(a, t_out, mode))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_ELEM)
    with pytest.raises(ValueError, match="unknown interpolation mode"):
        interpolate.resize_time(torch.from_numpy(x), t_out, "cubic")


# -- HTSAT and CNN -------------------------------------------------------------------------


def test_tiny_htsat_matches_jax_all_outputs():
    """Every output of the backbone in eval mode (running statistics),
    weights through ``convert_htsat`` and back through ``load_jax_params``."""
    port = init_weights_(htsat.HTSAT(**TINY_HTSAT), seed=0).eval()
    variables = convert_htsat(_np_state(port))
    reloaded = load_jax_params(htsat.HTSAT(**TINY_HTSAT), variables).eval()
    for key, val in port.state_dict().items():
        assert torch.equal(val, reloaded.state_dict()[key]), key
    assert port.layers[0].blocks[1].attn_mask.shape == (16, 16, 16)
    assert port.layers[0].blocks[0].attn_mask is None and port.layers[1].blocks[0].shift_size == 0
    mel = _mel(2, seed=3)
    jmodel = jax_htsat.HTSAT(**TINY_HTSAT)
    want = jit0(lambda v, m: jmodel.apply(v, m))(variables, jnp.asarray(mel))
    with torch.no_grad():
        got = reloaded(torch.from_numpy(mel))
    assert got["latent_t"] == want["latent_t"] == 32
    assert got["framewise_output"].shape == (2, 1024, 7)
    for name in ("framewise_output", "clipwise_output", "fine_grained_embedding", "embedding"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=ATOL_MODEL,
                                   err_msg=name)


@pytest.mark.parametrize("activation,normalization", [("cg", "batch"), ("glu", "layer"),
                                                      ("leakyrelu", "batch")])
def test_tiny_cnn_matches_jax(activation, normalization):
    cfg = dict(TINY_CNN, activation=activation, normalization=normalization)
    port = init_weights_(CNN(**cfg), seed=1).eval()
    params, stats = convert_cnn({f"cnn.{k}": v for k, v in _np_state(port).items()}, "cnn.cnn")
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
    mel = _mel(2, seed=4)
    want = jit0(JaxCNN(**cfg).apply)(variables, jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert got.shape == (2, 8, 50, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MODEL)


def test_cnn_dropout_is_a_draw_step_and_an_apply_step():
    """Training with conv_dropout needs a generator (or given masks); the
    same seed gives the same output; masks are scaled keep masks, drawn from
    the generator itself when it lives on the activations' device."""
    port = init_weights_(CNN(**dict(TINY_CNN, conv_dropout=0.5)), seed=1).train()
    mel = torch.from_numpy(_mel(2, seed=5))
    with pytest.raises(ValueError, match="Generator"):
        port(mel)
    a, b = (port(mel, generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, port(mel, torch.Generator().manual_seed(4)))
    mask = draw_dropout(torch.Generator().manual_seed(0), (2, 50, 16, 4), 0.5, "cpu")
    assert set(mask.unique().tolist()) == {0.0, 2.0}
    gen = torch.Generator().manual_seed(0)
    assert device_generator(gen, "cpu") is gen and device_generator(gen, mel.device) is gen
    ones = [torch.ones(2, 100, 16, 4), torch.ones(2, 50, 4, 8)]
    port.eval()
    with torch.no_grad():
        want = port(mel)
        running = [port.cnn.batchnorm0.running_mean.clone(), port.cnn.batchnorm0.running_var.clone()]
        port.train()
        got_eval_stats = port(mel, dropout_masks=ones)
    # masks of ones drop nothing: the output differs from eval only by the batch statistics
    assert got_eval_stats.shape == want.shape
    assert not torch.equal(port.cnn.batchnorm0.running_mean, running[0])


# -- HTSAT_CNN --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(seeded port model, its JAX variables, the JAX model)."""
    port = init_weights_(HTSAT_CNN(**TINY, device="cpu"), seed=0)
    params, model_state = convert_torch_checkpoint(_np_state(port), "HTSAT_CNN")
    return port, {"params": params, **model_state}, JaxHTSATCNN(**TINY)


@pytest.fixture(scope="module")
def jax_eval(tiny):
    _, variables, jmodel = tiny
    return jit0(lambda v, mel, pm: jmodel.apply(v, mel, pad_mask=pm, temp_w=0.5))


def test_htsat_cnn_weights_round_trip_and_key_checks(tiny):
    port, variables, _ = tiny
    reloaded = load_jax_params(HTSAT_CNN(**TINY, device="cpu"), variables)
    for key, val in port.state_dict().items():
        assert torch.equal(val, reloaded.state_dict()[key]), key
    assert {"cnn.cnn.batchnorm0.running_var", "cnn.cnn.cg1.linear.weight", "merge_weight",
            "backbone.layers.0.blocks.1.attn.relative_position_bias_table",
            "backbone.layers.0.downsample.reduction.weight", "backbone.patch_embed.proj.weight",
            "backbone.bn0.running_mean"} <= set(jax_params_to_state_dict(variables))
    short = {"params": {k: v for k, v in variables["params"].items() if k != "sed_head"},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="sed_head"):
        load_jax_params(HTSAT_CNN(**TINY, device="cpu"), short)
    no_stats = {"params": variables["params"]}
    with pytest.raises(KeyError, match="running_mean"):
        load_jax_params(HTSAT_CNN(**TINY, device="cpu"), no_stats)


def test_tiny_htsat_cnn_eval_matches_jax(tiny, jax_eval):
    port, variables, _ = tiny
    mel = _mel(2, seed=6)
    pm = np.zeros((2, FRAMES), bool)
    pm[1, 40:] = True
    want = jax_eval(variables, jnp.asarray(mel), jnp.asarray(pm))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(mel), temp_w=0.5, pad_mask=torch.from_numpy(pm))
    assert got.strong.shape == (2, 5, FRAMES) and got.weak.shape == (2, 5)
    assert float(got.strong[1, :, 40:].max()) == pytest.approx(1e-7)  # padded, then clipped
    for name, a, w in (("strong", got.strong, want.strong), ("weak", got.weak, want.weak),
                       ("logit", got.extras["logit"], want.extras["logit"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL_MODEL, err_msg=name)
    with pytest.raises(ValueError, match="eval mode"):
        port(torch.from_numpy(mel), train=True)


def test_tiny_htsat_cnn_train_mode_matches_jax_with_new_statistics(tiny):
    """Training mode: batch statistics in bn0 and the CNN, and the running
    statistics after the call, against flax's mutable ``batch_stats``."""
    port, variables, jmodel = tiny
    model = HTSAT_CNN(**TINY, device="cpu").train()
    model.load_state_dict(port.state_dict())
    mel = _mel(3, seed=7)
    want, new = jit0(lambda v, m: jmodel.apply(v, m, train=True, temp_w=1.0,
                                                  mutable=["batch_stats"]))(variables,
                                                                            jnp.asarray(mel))
    got = model(torch.from_numpy(mel), temp_w=1.0, train=True)
    for name in ("strong", "weak"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), atol=ATOL_MODEL, err_msg=name)
    ours = model.state_dict()
    stats = jax_params_to_state_dict({"params": {}, "batch_stats": new["batch_stats"]},
                                     names=ours.keys())
    assert len(stats) == 6  # bn0 and two CNN layers, mean and var
    for name, val in stats.items():
        np.testing.assert_allclose(ours[name].numpy(), val, atol=ATOL_MODEL, err_msg=name)
        assert not torch.equal(ours[name], port.state_dict()[name]), name


@pytest.mark.parametrize("kw,match", [
    (dict(decoder="gru"), "queue 1, item 12"), (dict(decoder="conformer"), "queue 1, item 12"),
    (dict(mlm_dict={"mask_rate": 0.75}), "queue 1, item 9"),
])
def test_unported_htsat_cnn_options_raise_with_their_roadmap_item(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        HTSAT_CNN(**dict(TINY, **kw), device="cpu")


def test_htsat_cnn_decoder_no_and_no_cnn_branch_match_jax():
    cfg = dict(TINY, decoder="no", cnn_param=None)
    port = init_weights_(HTSAT_CNN(**cfg, device="cpu"), seed=2).eval()
    params, model_state = convert_torch_checkpoint(_np_state(port), "HTSAT_CNN")
    mel = _mel(2, seed=8)
    want = jit0(lambda v, m: JaxHTSATCNN(**cfg).apply(v, m, temp_w=0.5))(
        {"params": params, **model_state}, jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), temp_w=0.5)
    np.testing.assert_allclose(got.strong.numpy(), np.asarray(want.strong), atol=ATOL_MODEL)
    with pytest.raises(ValueError, match="invalid decoder"):
        HTSAT_CNN(**dict(TINY, decoder="lstm"), device="cpu")


def test_htsat_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        htsat.HTSATFrontend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HTSAT_CNN(**TINY)


def test_inference_engine_serves_htsat_cnn_like_the_jax_pipeline(tiny, jax_eval):
    """A [B, 1, T, F] frontend and a model with BatchNorm buffers through the
    engine: frontend, eval forward, median filter, ragged last batch."""
    port, variables, _ = tiny
    sr, clip = 32000, 32000  # 1-s clips: 101 mel frames, 64 output frames
    labels = tuple("abcde")
    kw = dict(audio_len=1.0, frame_len=1024, frame_hop=320, net_pooling=100 / FRAMES, sr=sr)
    codec, jcodec = LabelCodec(labels, **kw), JaxCodec(labels, **kw)
    assert codec.n_frames == FRAMES
    rng = np.random.RandomState(9)
    waves = [(0.1 * rng.randn(n)).astype(np.float32) for n in (clip, clip, 20000)]
    clips = [pad_wav(w, clip, codec) for w in waves]
    batches = [{"wav": np.stack([c[0] for c in clips[i:i + 2]]),
                "pad_mask": np.stack([c[1] for c in clips[i:i + 2]]),
                "filename": [f"clip{j}.wav" for j in range(i, min(i + 2, 3))]} for i in (0, 2)]
    fe = htsat.HTSATFrontend(n_mels=MEL_F, device="cpu")
    jfe = jit0(lambda w: jax_htsat.HTSATFrontend(n_mels=MEL_F)(w))
    engine = InferenceEngine(port, fe, codec, median_filter=7, batch_size=2,
                             model_kwargs={"temp_w": 0.5}, device="cpu")
    served = list(engine.score_batches(batches))
    assert not port.training and [len(n) for n, _, _ in served] == [2, 1]
    for (names, scores, weak), batch in zip(served, batches):
        n = len(names)
        wav, pm = batch["wav"], batch["pad_mask"]
        if n < 2:
            wav = np.concatenate([wav, np.zeros_like(wav)])
            pm = np.concatenate([pm, np.ones_like(pm)])
        out = jax_eval(variables, jfe(jnp.asarray(wav)), jnp.asarray(pm))
        ref = np.asarray(jax_class_filter(out.strong.transpose(0, 2, 1), 7))[:n]
        np.testing.assert_allclose(scores, ref, atol=ATOL_MODEL)
        np.testing.assert_allclose(weak, np.asarray(out.weak)[:n], atol=ATOL_MODEL)
        assert engine.decode(scores[0]) == jcodec.decode_strong(
            (ref[0] > 0.5).astype(np.float32))
