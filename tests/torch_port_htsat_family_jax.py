"""The JAX side of ``tests/test_torch_port_htsat_family.py``, run in worker
processes.

It imports JAX, flax, numpy and the JAX package only (no torch and nothing of
the port), so that a spawned worker starts in about half the time; it takes
the port's seeded weights as numpy state dicts and returns numpy. The tiny
configurations and inputs live here, where both sides read them.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax

from transformer4sed_tpu.models import htsat_heads as jax_heads
from transformer4sed_tpu.recipes import clap as jax_clap
from transformer4sed_tpu.recipes import dasm_recipe as jax_recipe
from transformer4sed_tpu.recipes.audioset_strong import SupervisedConfig
from transformer4sed_tpu.recipes.common import make_model_apply
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.train.mlm import MLMState
from transformer4sed_tpu.utils.torch_import import convert_clap_sed, convert_cnn, convert_dasm
from tests.torch_port_dasm_jax import recording_apply
from tests.torch_port_jax import OPT0, filt_draws_program, jit0

# tests/test_htsat.py:tiny_htsat: a 64 x 64 Swin image of 16 mel bins, one block a
# stage (the shifted blocks are tests/test_torch_port_htsat.py's), 32 fine-grained frames
TINY_HTSAT = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), num_classes=7, embed_dim=16,
                  depths=(1, 1), num_heads=(2, 4), window_size=4, mel_bins=16)
TINY_CNN = dict(nb_filters=(4, 8), kernel_size=(3, 3), padding=(1, 1), stride=(1, 1),
                pooling=((2, 4), (1, 4)), activation="cg", conv_dropout=0.0)
MEL_T, MEL_F, B = 100, 16, 4
CLAP_FRAMES, DASM_FRAMES = 32, 64  # the fine-grained frames; x2 interpolation
QUERY_DIM = (6, 5)  # [text, audio]
CLAP = dict(embed_dim=24, class_num=5, query_dim=QUERY_DIM[0], htsat_kwargs=TINY_HTSAT)
DASM = dict(class_num=3, decoder_dim=32, num_heads=4, decoder="transformerXL",
            decoder_layer_num=1, decoder_pos_emd_len=80, backbone_upsample_ratio=2,
            htsat_kwargs=TINY_HTSAT, at_decoder_layer=1, out_type="sigmoid")
TWO = dict(query_projector=True, query_dim=list(QUERY_DIM))
VARIANTS = {  # network -> (constructor kwargs, forward kwargs' variant)
    "clap_own_bank_pad_mask": ("CLAP_SED", {}),
    "clap_external_query": ("CLAP_SED", {}),
    "dasm_learnable_sigmoid_pad_mask": ("DASM_HTSAT", {}),
    "dasm_two_modalities_logit_tgt_mask": ("DASM_HTSAT", dict(TWO, out_type="logit")),
    "dasm_one_bank_audio_no_decoder_no_head": ("DASM_HTSAT", dict(TWO, out_type=None,
                                                                  decoder="no")),
    "dasm_one_projector_text": ("DASM_HTSAT", dict(query_projector=True,
                                                   query_dim=QUERY_DIM[0])),
    "dasm_cnn_branch_windows": ("DASM_HTSAT", dict(cnn_param=TINY_CNN)),
}
# the steps' param groups: the head's weight decay large enough that AdamW's
# decay of CLAP_SED's text_query, which gets no gradient, shows in f32
OPT = dict(encoder=dict(lr=1e-4, weight_decay=1e-4, step_lr=1),
           decoder=dict(lr=2e-4, weight_decay=1e-4), head=dict(lr=4e-4, weight_decay=0.5))
CLAP_COMMON = (True, False, True, True, False)
LOSS = dict(loss_name="AslLoss", loss_kwargs=dict(rp=0, rn=4, margin=0.05))
AT_KEEP = 0.9  # the JAX AT decoder's dropout keep probability


def constructor(variant):
    net, kw = VARIANTS[variant]
    return net, {**(CLAP if net == "CLAP_SED" else DASM), **kw}


def banks(seed=1, rows=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(rows, d).astype(np.float32) for d in QUERY_DIM]


def mel(b, seed):
    """A [B, 1, T, F] log-mel stand-in at the dB scale's spread."""
    return (np.random.RandomState(seed).randn(b, 1, MEL_T, MEL_F) * 3.0).astype(np.float32)


def forward_kwargs(variant):
    """The forward's kwargs of each variant, numpy."""
    net, _ = VARIANTS[variant]
    frames = CLAP_FRAMES if net == "CLAP_SED" else DASM_FRAMES
    pad = np.zeros((2, frames), bool)
    pad[1, frames * 3 // 4:] = True
    kw = {"temp_w": 0.5 if net == "CLAP_SED" else 0.1, "pad_mask": pad}
    if variant == "clap_external_query":
        kw = {"temp_w": 1.0, "query": banks(4, 7)[0]}
    elif variant == "dasm_two_modalities_logit_tgt_mask":
        mask = np.zeros((3, 3), bool)
        mask[2, :2] = True
        kw.update(query=banks(), tgt_mask=mask)
    elif variant == "dasm_one_bank_audio_no_decoder_no_head":
        kw.update(query=banks()[1], query_type="audio")
    elif variant == "dasm_one_projector_text":
        kw.update(query=banks()[0], query_type="text")
    elif variant == "dasm_cnn_branch_windows":
        kw.update(encoder_win=True, win_param=(64, 40), mix_rate=0.3)
    return kw


def jax_variables(net, sd):
    """The JAX variables of a seeded port network's numpy state dict
    (``convert_clap_sed`` / ``convert_dasm``; DASM_HTSAT's CNN branch, which
    ``convert_dasm`` leaves out, through ``convert_cnn``)."""
    if net == "CLAP_SED":
        return convert_clap_sed(sd)
    tree = convert_dasm(sd, num_heads=4)
    if "cnn.cnn.conv0.weight" in sd:
        cnn_params, stats = convert_cnn({k[4:]: v for k, v in sd.items() if k.startswith("cnn.")})
        tree["params"].update(cnn=cnn_params, cnn_projector={
            "kernel": sd["cnn_projector.weight"].T, "bias": sd["cnn_projector.bias"]},
            merge_weight=sd["merge_weight"])
        tree["batch_stats"]["cnn"] = stats
    return tree


def _to_jax(v):
    if isinstance(v, list):
        return [jnp.asarray(x) for x in v]
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def forward_outputs(states):
    """Each variant's JAX outputs on two clips from the port's state dicts
    ``{variant: numpy state dict}``, all in one program."""
    calls = {}
    for variant in states:
        net, kw = constructor(variant)
        fkw = forward_kwargs(variant)
        static = {k: fkw.pop(k) for k in ("query_type", "encoder_win", "win_param", "mix_rate",
                                          "temp_w") if k in fkw}
        calls[variant] = (getattr(jax_heads, net)(**kw), static,
                          {k: _to_jax(v) for k, v in fkw.items()})

    def fwd(variables, m, kwargs):
        out = {}
        for variant, (jmodel, static, _) in calls.items():
            res = jmodel.apply(variables[variant], m, **static, **kwargs[variant])
            out[variant] = {f: getattr(res, f) for f in ("strong", "weak", "at_out")
                            if getattr(res, f) is not None}
        return out

    variables = {v: jax_variables(VARIANTS[v][0], sd) for v, sd in states.items()}
    res = jit0(fwd)(variables, jnp.asarray(mel(2, 3)), {v: c[2] for v, c in calls.items()})
    return jax.tree_util.tree_map(np.asarray, res)


def refusals(clap_sd, learnable_sd):
    """The errors of two calls the JAX package refuses: CLAP_SED given
    ``query_type`` (what its serve passes with every ``--query``), and a
    learnable-query DASM_HTSAT given an external bank (what the
    open-vocabulary trainer's validation passes)."""
    m = jnp.asarray(mel(1, 4))
    clap = jax_heads.CLAP_SED(**constructor("clap_own_bank_pad_mask")[1])
    dasm = jax_heads.DASM_HTSAT(**constructor("dasm_learnable_sigmoid_pad_mask")[1])
    errors = {}
    for what, fn in (
            ("clap_query_type", lambda: clap.apply(
                jax_variables("CLAP_SED", clap_sd), m, query=jnp.asarray(banks()[0]),
                query_type="text")),
            ("learnable_external_query", lambda: jax.eval_shape(
                lambda v: dasm.apply(v, m, query=jnp.zeros((3, 32))),
                jax_variables("DASM_HTSAT", learnable_sd)))):
        try:
            fn()
            errors[what] = None
        except Exception as e:  # noqa: BLE001 - the error is the result
            errors[what] = f"{type(e).__name__}: {e}"
    return errors


GROUPS = ("at_decoder", "decoder", "encoder_high", "encoder_low", "frozen", "head", "query")


def opt_spec(at_decoder=False, query=False):
    """The steps' param groups (both packages' ``ParamGroupConfig``), with
    the AudioSet policy's ``at_decoder`` and ``query`` groups on request."""
    spec = dict(OPT)
    if at_decoder:
        spec["at_decoder"] = dict(lr=3e-4, weight_decay=1e-3)
    if query:
        spec["query"] = dict(lr=5e-4, weight_decay=0.0)
    return spec


def opt_cfg(**extra):
    return jax_optim.ParamGroupConfig(
        **{k: jax_optim.GroupSpec(**v) for k, v in opt_spec(**extra).items()}, clip_grad=0.5)


class _IdentityFrontend:
    def __call__(self, wav, key=None, training=False):
        return wav

    def normalize(self, mel):
        return mel


def step_batch(n_classes, frames, seed=12):
    rng = np.random.RandomState(seed)
    return {"wav": mel(B, seed),
            "labels": (rng.rand(B, n_classes, frames) > 0.7).astype(np.float32)}


def _preprocess_draws(key, max_shift, cfg):
    """The draws of a step's preprocess from its key (``make_clap_step``'s
    and ``make_dasm_step``'s split alike), as numpy: shifts, the mixup
    coefficient, whether it mixes, the permutation, and filt_aug's band
    count, boundary draw for that count and gains."""

    def raw(key):
        _, kshift, kmix, kmixp, ktrans, _ = jax.random.split(key, 6)
        return ((jax.random.normal(kshift, (B,)) * max_shift).astype(jnp.int32),
                jax.random.beta(jax.random.fold_in(kmix, 0), cfg.mixup_alpha, cfg.mixup_beta),
                jax.random.uniform(kmixp) < cfg.mixup_prob,
                jax.random.permutation(jax.random.fold_in(kmix, 1), B),
                jax.random.split(jax.random.fold_in(ktrans, 0), 5)[0])

    shifts, c, do_mix, perm, k0 = jit0(raw)(key)
    out = dict(shifts=np.asarray(shifts).astype(np.int64), c=float(c), do_mix=bool(do_mix),
               perm=np.asarray(perm).astype(np.int64))
    if cfg.transform_choice[0]:
        (lo, hi), (lo_db, hi_db) = cfg.filter_bands, cfg.filter_db_range
        nb, raws, fdb = filt_draws_program(B, MEL_F, lo, hi, cfg.filter_minimum_bandwidth,
                                           cfg.filter_type == "linear")(k0)
        out.update(n_bands=int(nb), band_raw=np.asarray(raws[int(nb) - lo]).astype(np.int64),
                   band_db=(np.asarray(fdb) * (hi_db - lo_db) + lo_db).astype(np.float32))
    return out


def _compile_beside_draws(jitted, args, key, max_shift, cfg):
    """The step traced, then compiled while the preprocess draws compile and
    run in a thread beside it; (compiled step, draws)."""
    lowered = jitted.lower(*args)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        draws = pool.submit(_preprocess_draws, key, max_shift, cfg)
        compiled = lowered.compile(OPT0)
        return compiled, draws.result()


def clap_step(sd):
    """One ``make_clap_step`` step of the tiny CLAP_SED from the port's state
    dict ``sd`` (AslLoss, mixup, shift and filt_aug, common classes 0, 2 and
    3 with their rows of the bank): its metrics, preprocess draws, and the
    end params and batch statistics."""
    variables = jax_variables("CLAP_SED", sd)
    cfg = SupervisedConfig(**LOSS, mixup_prob=1.0, model_kwargs={"temp_w": 1.0})
    tx, _ = jax_optim.build_optimizer(variables["params"], opt_cfg())
    common = np.asarray(CLAP_COMMON)
    step = jax_clap.make_clap_step(
        make_model_apply(jax_heads.CLAP_SED(**CLAP), True), _IdentityFrontend(), tx, cfg,
        np.flatnonzero(common), jnp.asarray(banks(2, 5)[0][common]))
    state = MLMState(params=variables["params"], opt_state=jit0(tx.init)(variables["params"]),
                     step=jnp.zeros((), jnp.int32),
                     model_state={"batch_stats": variables["batch_stats"]})
    batch = {k: jnp.asarray(v) for k, v in step_batch(5, CLAP_FRAMES).items()}
    key = jax.random.PRNGKey(0)
    compiled, draws = _compile_beside_draws(
        jax.jit(step), (state, batch, key), key, min(cfg.max_shift_frame, MEL_T // 2), cfg)
    state, metrics = compiled(state, batch, key)
    return (dict(metrics={k: float(v) for k, v in metrics.items()}, **draws),
            jax.device_get({"params": state.params, **state.model_state}))


DASM_STEP = dict(constructor("dasm_two_modalities_logit_tgt_mask")[1], decoder="no")


def dasm_step(sd):
    """One ``make_dasm_step`` step of the tiny two-modality DASM_HTSAT from
    the port's state dict ``sd`` (the (C+1)-way CE, mixup, bn0 in training
    mode, the AT decoder's dropout, a modality a query), with neither shift
    nor filt_aug, which the JAX step applies to the 4-d mel's last axis, and
    with ``optax.identity`` for the optimizer, so that the params move by
    the gradient itself: its metrics, its draws (the preprocess's, the
    dropout keep masks, the modality pick), the gradient and the batch
    statistics after the step. (The optimizer's groups on DASM_HTSAT are
    held by label; AdamW's step by the CLAP step.)"""
    variables = jax_variables("DASM_HTSAT", sd)
    jmodel = jax_heads.DASM_HTSAT(**DASM_STEP)
    cfg = jax_recipe.DASMTrainConfig(out_type="logit", w_at=0.7, max_shift_frame=0,
                                     mixup_prob=1.0, transform_choice=(0, 0, 0, 0),
                                     model_kwargs={"temp_w": 0.1})

    def model_apply(params, mel, train=False, rngs=None, model_state=None, **kw):
        """``recording_apply``'s draws, with bn0's batch statistics mutable."""
        new = {}

        def apply(variables, m, **k):
            out, new["stats"] = jmodel.apply(
                {**variables, "batch_stats": model_state["batch_stats"]}, m,
                mutable=["batch_stats"], **k)
            return out

        out, draws = recording_apply(type("Stateful", (), {"apply": staticmethod(apply)})())(
            params, mel, train=train, rngs=rngs, **kw)
        return out, {"batch_stats": new["stats"]["batch_stats"], **draws}

    step = jax_recipe.make_dasm_step(model_apply, _IdentityFrontend(), optax.identity(), cfg)
    state = MLMState(params=variables["params"], opt_state=optax.identity().init(None),
                     step=jnp.zeros((), jnp.int32),
                     model_state={"batch_stats": variables["batch_stats"]})
    batch = {k: jnp.asarray(v) for k, v in step_batch(3, DASM_FRAMES).items()}
    key = jax.random.PRNGKey(1)
    extra = {"query": [jnp.asarray(b) for b in banks()]}
    fn = jax.jit(lambda s, b, k: step(s, b, k, extra_kwargs=extra))
    compiled, pre = _compile_beside_draws(fn, (state, batch, key), key, 0, cfg)
    end, metrics = compiled(state, batch, key)
    ms = end.model_state
    grads = jax.tree_util.tree_map(lambda a, b: a - b, end.params, state.params)
    return (dict(metrics={k: float(v) for k, v in metrics.items()},
                 masks=[np.asarray(m) for m in ms["masks"]],
                 pick=np.asarray(ms["picks"][0]).astype(np.int64), **pre),
            jax.device_get({"params": grads, "batch_stats": ms["batch_stats"]}))
