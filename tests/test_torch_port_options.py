"""The port's finetune2 and decoder options, held against the JAX package on
the CPU.

  * ``window_layout`` and ``slide_window_encode`` (a ragged tail group, the
    half-to-even offsets) against ``models/slide.py``.
  * Tiny PaSST_SED and PaSST_CNN eval forwards with ``encoder_win`` (and
    ``decoder_win_len``, ``interpolate_mode='nearest'``) against JAX ``apply``;
    one train forward and one finetune2 mean-teacher step with JAX's window
    offsets, recorded while the compiled JAX program runs, handed to the port.
  * ``TransformerXLDecoder(window_len=...)``, and the XL attention and block
    with explicit [T, T], [H, T, T] and [B, H, T, T] masks (JAX's masked
    branch under ``use_flash``), forward and ``jax.vjp``.
  * ``load_jax_params`` on a finetune2 PaSST_SED.
  * The AudioSet losses that raised here until the AudioSet slice ported
    them (``ReweightedASL``, ``AsymmetricalFocalLoss``) against JAX's.

The JAX models are never initialised: the port model is seeded and its state
dict goes through the JAX package's ``convert_torch_checkpoint``. Inputs come
from numpy with a seed; everything compares in float32. Each JAX program is
compiled once, at XLA's lowest backend optimization level (the bounds hold);
the two eval forwards' in a worker process started with the module
(``tests/torch_port_options_jax.py``, which imports no torch), the training
programs in a worker thread.
"""

import concurrent.futures
import multiprocessing
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.core import losses as jax_losses
from transformer4sed_tpu.models import slide as jax_slide
from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxSED
from transformer4sed_tpu.models.xl import TransformerXLBlock as JaxXLBlock
from transformer4sed_tpu.models.xl import TransformerXLDecoder as JaxXLDecoder
from transformer4sed_tpu.models.xl import build_band_mask
from transformer4sed_tpu.train import mean_teacher as jax_mt
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.core import losses
from transformer4sed_tpu_torch.models import slide
from transformer4sed_tpu_torch.models.passt import PaSST, PatchoutDraws
from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder
from transformer4sed_tpu_torch.train import mean_teacher as mt
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import init_weights_, load_jax_params
from tests import torch_port_options_jax as options_jax
from tests.torch_port_jax import OPT0, jit0
from tests.torch_port_options_jax import BANDS, TINY, TINY_FT2, TINY_PMAM, WIN
from tests.torch_port_options_jax import mel as _mel

# model outputs after a dozen f32 matmuls, summed in another order
# (tests/test_torch_port_slice.py, tests/test_torch_port_pmam.py)
ATOL_MODEL = 5e-5
# one XL block: its output, and the gradients, which sum T products
ATOL_BLOCK = 2e-5
ATOL_BLOCK_GRAD = 1e-4
# overlap-add of the same f32 embeddings in the same order
ATOL_SLIDE = 1e-6
# the losses of one train step (tests/test_torch_port_train.py)
ATOL_LOSS = RTOL_LOSS = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# held by every trace of this module's JAX programs: the recorder below
# replaces the global ``jax.random.randint`` while it traces, in a worker
# thread, and no other program may take up its stand-in
_TRACE_LOCK = threading.Lock()


def _jit0(fn):
    return jit0(fn, _TRACE_LOCK)


def _compile_recording_offsets(fn, args, record):
    """``fn`` compiled at OPT0 for ``args``, traced with every
    ``jax.random.randint`` (PaSST's time-embedding offset,
    models/passt.py:118-120) reporting its value to ``record`` in program
    order while the program runs; call ``jax.effects_barrier()`` after the
    run to have them all."""
    orig = jax.random.randint

    def randint(*a, **kw):
        out = orig(*a, **kw)
        jax.debug.callback(lambda x: record.append(int(x)), out, ordered=True)
        return out

    with _TRACE_LOCK:
        jax.random.randint = randint
        try:
            lowered = jax.jit(fn).lower(*args)
        finally:
            jax.random.randint = orig
    return lowered.compile(OPT0)


def _port(cls, cfg, **kw):
    return init_weights_(cls(**cfg, **kw, device="cpu"), seed=0)


def _params(port, name, cfg):
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, state = convert_torch_checkpoint(sd, name, init_kwargs=cfg)
    return {"params": params, **state}


@pytest.fixture(scope="module")
def tiny():
    """The finetune2 PaSST_SED (local attention, nearest interpolation): the
    seeded port model, its JAX variables and the JAX model."""
    port = _port(PaSST_SED, TINY_FT2)
    return port, _params(port, "PaSST_SED", TINY_FT2), JaxSED(**TINY_FT2)


# -- models/slide.py ---------------------------------------------------------------------


@pytest.mark.parametrize("input_len,width,step", [(1001, 512, 31), (1001, 512, 49),
                                                  (121, 64, 20), (40, 64, 20), (100, 30, 30)])
def test_window_layout_matches_jax(input_len, width, step):
    assert slide.window_layout(input_len, width, step) == jax_slide.window_layout(
        input_len, width, step)


@pytest.mark.parametrize("emb_len", [10, 37])
def test_slide_window_encode_matches_jax_with_a_ragged_tail_group(emb_len):
    """8 frames in windows of 3 at a step of 2 (widths 3, 3, 3 and a ragged
    2): the window's frames as embeddings, upsampled x3, overlap-added at
    round(s * emb_len / 8) (half to even at emb_len 10: 2.5 -> 2, 7.5 -> 8),
    positions no window covers zero."""
    mel = np.random.RandomState(0).randn(2, 3, 8).astype(np.float32)
    want = _jit0(lambda m: jax_slide.slide_window_encode(
        lambda w: jnp.repeat(w.transpose(0, 2, 1), 3, axis=1), m, emb_len, 3, 2))(
        jnp.asarray(mel))
    groups = []
    got = slide.slide_window_encode(
        lambda w, g: groups.append(g) or w.transpose(1, 2).repeat_interleave(3, dim=1),
        torch.from_numpy(mel), emb_len, 3, 2)
    assert groups == [0, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_SLIDE)


# -- the decoder's local attention and explicit masks ------------------------------------


@pytest.mark.parametrize("window_len", [5, BANDS])
def test_decoder_window_len_matches_jax(tiny, window_len):
    """``TransformerXLDecoder(window_len=...)`` (one width, or one per head)
    against the JAX decoder under ``use_flash`` (band widths)."""
    port, variables, _ = tiny
    dec = TransformerXLDecoder(32, 1, 4, 120, window_len=window_len)
    dec.load_state_dict(port.decoder.state_dict())
    jdec = JaxXLDecoder(decoder_layer_num=1, num_heads=4, seq_len=120, window_len=window_len,
                        use_flash=True)
    x = np.random.RandomState(4).randn(2, 100, 32).astype(np.float32)
    dparams = {"params": variables["params"]["decoder_module"]}
    want = _jit0(lambda v, xx: jdec.apply(v, xx))(dparams, jnp.asarray(x))
    with torch.no_grad():
        got = dec(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_BLOCK)


def _mask(kind, b, h, t):
    """A bool mask (True = blocked) of the given rank: a per-head band, the
    last keys of batch 0, and every key of row 2 (a fully masked row)."""
    m = np.broadcast_to(build_band_mask(t, [3, 8, 1, 20][:h]), (b, h, t, t)).copy()
    m[0, :, :, t - 4:] = True
    m[:, :, 2, :] = True
    return {"TT": m[0, 0], "HTT": m[0], "BHTT": m}[kind]


@pytest.mark.parametrize("kind", ["TT", "HTT", "BHTT"])
def test_xl_block_with_an_explicit_mask_matches_jax_masked_branch(tiny, kind):
    """``TransformerXLBlock`` (and its ``RelPositionMultiheadAttention``) with
    a mask against the JAX block under ``use_flash`` (its masked branch:
    rel-shifted position scores as a -1e30-blocked bias to
    ``flash_attention_bias``), forward and ``jax.vjp`` for the input and
    every param."""
    port, variables, _ = tiny
    blk = port.decoder.encoder_blocks[0]
    jblk = JaxXLBlock(num_heads=4, use_flash=True)
    bparams = variables["params"]["decoder_module"]["encoder_blocks_0"]
    b, t = 2, 30
    rng = np.random.RandomState(5)
    x = rng.randn(b, t, 32).astype(np.float32)
    g = rng.randn(b, t, 32).astype(np.float32)
    mask = _mask(kind, b, 4, t)
    pos = port.decoder.pos_emb(t).numpy()

    def fwd(p, xx):
        return jblk.apply({"params": p}, xx, jnp.asarray(pos), mask=jnp.asarray(mask))

    def vjp(p, xx, gg):
        out, pull = jax.vjp(fwd, p, xx)
        return out, pull(gg)

    out, (dparams, dx) = _jit0(vjp)(bparams, jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    blk.zero_grad(set_to_none=True)
    got = blk(xt, torch.from_numpy(pos), mask=torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=ATOL_BLOCK)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=ATOL_BLOCK_GRAD)
    attn = dparams["attn"]
    for name, want in (("pos_bias_u", attn["pos_bias_u"]), ("pos_bias_v", attn["pos_bias_v"]),
                       ("linear_pos.weight", np.asarray(attn["linear_pos"]["kernel"]).T),
                       ("in_proj.weight", np.asarray(attn["in_proj"]["kernel"]).T),
                       ("out_proj.bias", attn["out_proj"]["bias"])):
        mod = blk.attn
        for part in name.split("."):
            mod = getattr(mod, part)
        np.testing.assert_allclose(mod.grad.numpy(), np.asarray(want), atol=ATOL_BLOCK_GRAD,
                                   err_msg=name)


_AUDIOSET_LOSS_KWARGS = {"ReweightedASL": dict(rp=1, rn=3, margin=0.05,
                                                weight=[0.5, 2.0, 1.0, 3.0]),
                         "AsymmetricalFocalLoss": dict(gamma=2.0, zeta=1.0)}


@pytest.mark.parametrize("name", ["ReweightedASL", "AsymmetricalFocalLoss"])
def test_unported_options_raise_naming_their_queue_item(name):
    """The two losses of the JAX registry that raised here, citing ROADMAP.md
    queue 1, item 9, until the AudioSet slice ported them: the factory now
    builds each, equal to JAX's with finite gradients at saturated
    probabilities; an unknown name still raises."""
    kwargs = _AUDIOSET_LOSS_KWARGS[name]
    pred = np.array([[1e-7, 1.0, 0.03, 0.3], [0.999, 0.05, 0.5, 1.0 - 1e-7]], np.float32)
    target = np.array([[0.0, 1.0, 0.5, 1.0], [1.0, 0.0, 0.2, 0.7]], np.float32)
    want, jgrad = _jit0(jax.value_and_grad(jax_losses.loss_function_factory(name, kwargs)))(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.loss_function_factory(name, kwargs)(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(p.grad).all()
    with pytest.raises(KeyError, match="unknown loss"):
        losses.loss_function_factory("FocalLoss")


def test_window_backbone_call_stops_at_the_tap_layer():
    """A window's backbone call (``upto_tap``, all that ``_encode_window``
    reads) enters no block after the tap layer and returns the whole call's
    tap output, without the final-norm tokens."""
    backbone = init_weights_(PaSST(embed_dim=32, depth=3, num_heads=4, img_size=(128, 120),
                                   tap_layer=2), seed=0)
    entered = []
    backbone.blocks[2].register_forward_pre_hook(lambda mod, args: entered.append(1))
    mel = torch.from_numpy(_mel(2, seed=6)[:, None, :, :64])
    with torch.no_grad():
        whole = backbone(mel)
        assert entered == [1]
        window = backbone(mel, upto_tap=True)
    assert entered == [1] and "frame" not in window
    assert (window["f_dim"], window["t_dim"]) == (whole["f_dim"], whole["t_dim"])
    assert torch.equal(window["layer2_out"], whole["layer2_out"])


# -- the weight bridge ---------------------------------------------------------------------


def test_load_jax_params_carries_a_finetune2_passt_sed(tiny):
    """``decoder_win_len`` and ``encoder_win`` add no param: a finetune2
    checkpoint loads into the port as it is, key for key."""
    port, variables, _ = tiny
    reloaded = load_jax_params(PaSST_SED(**TINY, decoder_win_len=list(BANDS), device="cpu"),
                               variables)
    assert reloaded.state_dict().keys() == port.state_dict().keys()
    for key, val in port.state_dict().items():
        assert torch.equal(val, reloaded.state_dict()[key]), key
    assert reloaded.decoder.band_widths == BANDS


# -- training with JAX's draws (recorded in a worker thread from the module's start) --------


def _train_forward(tiny):
    """The JAX finetune2 forward with ``train=True``, compiled with its offsets
    recorded, run once: (JAX's output, the offsets in program order)."""
    _, variables, jmodel = tiny
    mel = jnp.asarray(_mel(2, seed=3))
    rngs = {"patchout": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    offsets = []
    want = _compile_recording_offsets(
        lambda v, m, r: jmodel.apply(v, m, train=True, rngs=r, temp_w=0.5, **WIN),
        (variables, mel, rngs), offsets)(variables, mel, rngs)
    jax.effects_barrier()
    return want, offsets


def test_passt_sed_finetune2_train_forward_matches_jax_with_its_draws(tiny, recorded):
    """``train=True``: each window group's backbone call draws its own time
    offset; JAX's, recorded while its compiled forward runs, go to the port
    as ``window_draws``."""
    port = tiny[0]
    want, offsets = recorded.result()["forward"]
    assert len(offsets) == 2  # one per width group; the clip fills the nominal grid
    with torch.no_grad():
        got = port(torch.from_numpy(_mel(2, seed=3)), temp_w=0.5, train=True,
                   window_draws=[PatchoutDraws(offset=o) for o in offsets], **WIN)
    for key in ("strong", "weak", "at_out"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   atol=ATOL_MODEL, err_msg=key)


class _IdentityFrontend:
    """mel in, mel out: the train step without the STFT."""

    def __call__(self, wav, fminmax=None, key=None, training=False):
        return wav

    def draw_fminmax(self, gen):
        return None

    def normalize(self, mel):
        return mel


OPT_CFG = dict(encoder=dict(lr=5e-4, weight_decay=1e-4, step_lr=1, freeze_layer=0),
               decoder=dict(lr=1e-3, weight_decay=1e-2), head=dict(lr=2e-3, weight_decay=0.0))
STEP_CFG = dict(strong_num=2, weak_num=1, unlabel_num=1, self_loss_warmup_steps=3,
                w_cons_max=2.0, mixup_prob=0.0, max_shift_frame=0, n_transform=0)


def _step_setup():
    """The JAX finetune2 step (student and teacher windowed, augmentation off,
    identity frontend) compiled with its offsets recorded, run once: (the
    port model, the batch, JAX's metrics, the offsets in program order)."""
    port = _port(PaSST_SED, TINY)
    params = _params(port, "PaSST_SED", TINY)["params"]
    jmodel = JaxSED(**TINY)
    kw = dict(WIN, temp_w=0.5)
    jcfg = jax_mt.MeanTeacherConfig(**STEP_CFG, stu_kwargs=kw, tch_kwargs=kw)
    jopt = jax_optim.ParamGroupConfig(
        **{k: jax_optim.GroupSpec(**v) for k, v in OPT_CFG.items()}, backbone_depth=2,
        clip_grad=20.0)
    tx, _ = jax_optim.build_optimizer(params, jopt)

    def apply(p, m, train=False, rngs=None, **kws):
        return jmodel.apply({"params": p}, m, train=train, rngs=rngs, **kws)

    rng = np.random.RandomState(11)
    batch = {"wav": jnp.asarray(_mel(4, seed=11)),
             "labels": jnp.asarray((rng.rand(4, 2, 120) > 0.7).astype(np.float32))}
    state = jit0(lambda p: jax_mt.create_mean_teacher_state(p, tx))(params)
    offsets = []
    step = _compile_recording_offsets(
        jax_mt.make_mean_teacher_step(apply, _IdentityFrontend(), tx, jcfg),
        (state, batch, jax.random.PRNGKey(0)), offsets)
    _, metrics = step(state, batch, jax.random.PRNGKey(0))
    jax.effects_barrier()
    return port, batch, {k: float(v) for k, v in metrics.items()}, offsets


@pytest.fixture(scope="module", autouse=True)
def recorded(tiny):
    """:func:`_train_forward` and :func:`_step_setup`, one after the other,
    in a worker thread from the module's start: XLA compiles without holding
    the GIL, alongside the other tests, whose traces wait on _TRACE_LOCK
    while ``jax.random.randint`` is replaced."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(lambda: {"forward": _train_forward(tiny), "step": _step_setup()})
    yield future
    pool.shutdown(wait=True)


def test_finetune2_train_step_losses_match_jax_with_its_offsets(recorded):
    """One mean-teacher step with student and teacher windowed: every loss,
    the consistency weight and the gradient norm against
    ``make_mean_teacher_step``, the teacher's and then the student's window
    offsets handed in through the forward kwargs."""
    port, batch, want, offsets = recorded.result()["step"]
    assert len(offsets) == 4  # teacher, then student; one per width group
    draws = [PatchoutDraws(offset=o) for o in offsets]
    kw = dict(WIN, temp_w=0.5)
    cfg = mt.MeanTeacherConfig(**STEP_CFG, tch_kwargs=dict(kw, window_draws=draws[:2]),
                               stu_kwargs=dict(kw, window_draws=draws[2:]))
    pcfg = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                  backbone_depth=2, clip_grad=20.0)
    trainer = mt.MeanTeacherTrainer(port, _IdentityFrontend(), cfg, pcfg)
    got = trainer.step({"wav": np.asarray(batch["wav"]), "labels": np.asarray(batch["labels"])},
                       torch.Generator().manual_seed(0))
    for key in ("loss_total", "loss_class_strong", "loss_class_weak", "loss_class_at_specific",
                "loss_cons_strong", "loss_cons_weak", "loss_cons_at_specific", "w_cons",
                "grad_norm"):
        np.testing.assert_allclose(float(got[key]), want[key], rtol=RTOL_LOSS, atol=ATOL_LOSS,
                                   err_msg=key)


# -- the finetune2 eval forwards (their JAX side in a worker process) ---------------------


@pytest.fixture(scope="module", autouse=True)
def spawned(tiny):
    """The two finetune2 eval forwards' JAX side in a worker process started
    with the module (its tracing would hold this process's GIL, which the
    worker thread of :func:`recorded` needs), importing only
    ``tests/torch_port_options_jax.py``; the tests that read it come last."""
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    states = [{k: v.numpy() for k, v in port.state_dict().items()}
              for port in (tiny[0], _port(PaSST_CNN, TINY_PMAM))]
    future = pool.submit(options_jax.finetune2_evals, *states)
    yield future
    pool.shutdown(wait=True)


def test_passt_sed_finetune2_eval_matches_jax(tiny, spawned):
    """Windows, local attention and nearest interpolation together, with a
    padded tail, against JAX ``apply``."""
    port = tiny[0]
    pm = options_jax.pad_mask()
    want = spawned.result()["passt_sed"]
    with torch.no_grad():
        got = port(torch.from_numpy(_mel(2, seed=1)), pad_mask=torch.from_numpy(pm), temp_w=0.5,
                   **WIN)
    for key in ("strong", "weak", "at_out"):
        np.testing.assert_allclose(getattr(got, key).numpy(), want[key], atol=ATOL_MODEL,
                                   err_msg=key)


def test_passt_cnn_finetune2_eval_matches_jax(spawned):
    """PaSST_CNN (PMAM's shape) with the windows: only the PaSST branch is
    windowed."""
    port = _port(PaSST_CNN, TINY_PMAM).eval()
    want = spawned.result()["passt_cnn"]
    with torch.no_grad():
        got = port(torch.from_numpy(_mel(2, seed=2)), temp_w=0.5, **WIN)
    for key in ("strong", "weak", "at_out"):
        np.testing.assert_allclose(getattr(got, key).numpy(), want[key], atol=ATOL_MODEL,
                                   err_msg=key)
