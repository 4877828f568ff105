"""The JAX side of ``tests/test_torch_port_dasm.py``, run in worker processes.

It imports JAX, flax, numpy and the JAX package only (no torch and nothing of
the port), so that a spawned worker starts in about half the time; it takes
the port's seeded weights as a numpy state dict and returns numpy. The tiny
configurations live here, where both sides read them.
"""

import concurrent.futures
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from transformer4sed_tpu.models import dasm as jax_dasm
from transformer4sed_tpu.recipes import dasm_recipe as jax_recipe
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.train.mlm import MLMState
from transformer4sed_tpu.utils.torch_import import convert_cnn, convert_dasm
from tests.torch_port_jax import OPT0, filt_draws_program, jit0

T = 120  # mel frames = the backbone's nominal grid: train=True draws no time offset
MEL_F = 128
B = 4
TINY = dict(class_num=3, decoder_dim=32, num_heads=4, decoder="transformerXL",
            decoder_layer_num=1, decoder_pos_emd_len=T, embed_dim=32, backbone_depth=2,
            backbone_num_heads=4, passt_feature_layer=2, at_decoder_layer=1, f_pool_heads=4,
            out_type="sigmoid", backbone_img_size=(128, T))
TINY_CNN = dict(nb_filters=(4, 8), kernel_size=(3, 3), padding=(1, 1), stride=(1, 1),
                pooling=((2, 8), (2, 16)), activation="cg", conv_dropout=0.0)
QUERY_DIM = (6, 5)  # [text, audio]
VARIANTS = {
    "learnable_sigmoid_pad_mask": dict(),
    "two_modalities_logit_tgt_mask": dict(query_projector=True, query_dim=list(QUERY_DIM),
                                          out_type="logit"),
    "one_bank_audio_no_decoder_no_head": dict(query_projector=True, query_dim=list(QUERY_DIM),
                                              out_type=None, decoder="no"),
    "cnn_branch_windows": dict(cnn_param=TINY_CNN),
}
# the step cases: mixup always, the (C+1)-way CE with two modalities (closed
# set); the sigmoid head on a learnable bank, common classes 0 and 2 (open
# vocabulary); and open_vocab.yaml's network, two projectors with the sigmoid
# head, fed the common rows of the text bank with query_type 'text'
STEP_CASES = {
    "closed": dict(variant="two_modalities_logit_tgt_mask", out_type="logit", groups={},
                   common_mask=None),
    "open_vocab": dict(variant="learnable_sigmoid_pad_mask", out_type="sigmoid",
                       groups=dict(at_decoder=True, query=True),
                       common_mask=(True, False, True)),
    "open_vocab_text": dict(variant="two_modalities_logit_tgt_mask", out_type="sigmoid",
                            model=dict(out_type="sigmoid"), groups={},
                            common_mask=(True, False, True), query_type="text"),
}
AT_KEEP = 0.9  # the JAX AT decoder's dropout keep probability


def banks(seed=1, rows=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(rows, d).astype(np.float32) for d in QUERY_DIM]


def mel(b, seed):
    return (np.random.RandomState(seed).randn(b, MEL_F, T) * 3.0).astype(np.float32)


def forward_kwargs(variant):
    """The forward's kwargs of each variant, numpy."""
    pad = np.zeros((2, T), bool)
    pad[1, 90:] = True
    kw = {"temp_w": 0.1, "pad_mask": pad}
    if variant == "two_modalities_logit_tgt_mask":
        mask = np.zeros((3, 3), bool)
        mask[2, :2] = True
        kw.update(query=banks(), tgt_mask=mask)
    elif variant == "one_bank_audio_no_decoder_no_head":
        kw.update(query=banks()[1], query_type="audio")
    elif variant == "cnn_branch_windows":
        kw.update(encoder_win=True, win_param=(64, 40), mix_rate=0.3)
    return kw


def case_model(case):
    """The DASM constructor kwargs of a step case."""
    c = STEP_CASES[case]
    return {**TINY, **VARIANTS[c["variant"]], **c.get("model", {})}


def case_query(case):
    """The query bank a step case's forwards take: both modalities (closed
    set), none (a learnable bank), or the common rows of the text bank."""
    c = STEP_CASES[case]
    if c["common_mask"] is None:
        return banks()
    if c.get("query_type"):
        return banks()[0][np.asarray(c["common_mask"])]
    return None


def step_config(case):
    """``DASMTrainConfig``'s fields of a step case (both packages' configs)."""
    c = STEP_CASES[case]
    kwargs = {"temp_w": 0.1, **({"query_type": c["query_type"]} if c.get("query_type") else {})}
    return dict(out_type=c["out_type"], w_at=0.7, mixup_prob=1.0, model_kwargs=kwargs,
                common_mask=c["common_mask"],
                query_from_params=c["common_mask"] is not None and case_query(case) is None)


def opt_spec(at_decoder=False, query=False):
    """The param groups of the step tests (both packages' ``ParamGroupConfig``)."""
    spec = dict(encoder=dict(lr=1e-4, weight_decay=1e-4, step_lr=1),
                decoder=dict(lr=2e-4, weight_decay=1e-4), head=dict(lr=4e-4, weight_decay=0.0))
    if at_decoder:
        spec["at_decoder"] = dict(lr=3e-4, weight_decay=1e-3)
    if query:
        spec["query"] = dict(lr=5e-4, weight_decay=0.0)
    return spec


def jax_opt_cfg(**groups):
    return jax_optim.ParamGroupConfig(
        **{k: jax_optim.GroupSpec(**v) for k, v in opt_spec(**groups).items()}, clip_grad=0.5)


def jax_variables(sd):
    """The JAX variables of a seeded port DASM's numpy state dict
    (``convert_dasm``; the CNN branch, which it leaves out, through
    ``convert_cnn``)."""
    tree = convert_dasm(sd, num_heads=4, f_pool_heads=4, backbone_depth=2)
    if "cnn.cnn.conv0.weight" in sd:
        cnn_params, stats = convert_cnn({k[4:]: v for k, v in sd.items() if k.startswith("cnn.")})
        tree["params"].update(cnn=cnn_params, cnn_projector={
            "kernel": sd["cnn_projector.weight"].T, "bias": sd["cnn_projector.bias"]},
            merge_weight=sd["merge_weight"])
        tree["batch_stats"]["cnn"] = stats
    return {k: v for k, v in tree.items() if v}


def _to_jax(kw):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def forward_outputs(states):
    """Each variant's JAX outputs on two clips, from the port's state dicts
    ``{variant: numpy state dict}``, all variants in one program."""
    calls = {}
    for variant in states:
        kw = forward_kwargs(variant)
        static = {k: kw.pop(k) for k in ("query_type", "encoder_win", "win_param", "mix_rate",
                                         "temp_w") if k in kw}
        calls[variant] = (jax_dasm.DASM(**dict(TINY, **VARIANTS[variant])), static, _to_jax(kw))

    def fwd(variables, m, kwargs):
        out = {}
        for variant, (jmodel, static, _) in calls.items():
            res = jmodel.apply(variables[variant], m, **static, **kwargs[variant])
            out[variant] = {f: getattr(res, f) for f in ("strong", "weak", "at_out")
                            if getattr(res, f) is not None}
        return out

    res = jit0(fwd)({v: jax_variables(sd) for v, sd in states.items()}, jnp.asarray(mel(2, 3)),
                    {v: c[2] for v, c in calls.items()})
    return jax.tree_util.tree_map(np.asarray, res)


def recording_apply(model):
    """``model_apply`` for ``make_dasm_step`` that also returns the draws the
    forward makes, in place of a model state: the AT decoder's dropout keep
    masks (each flax ``Dropout`` given the key it would have drawn) and the
    per-query modality pick (``jax.random.randint`` inside the model)."""

    def model_apply(params, mel, train=False, rngs=None, model_state=None, **kw):
        masks, picks = [], []

        def interceptor(next_fun, args, kwargs, context):
            m = context.module
            if isinstance(m, nn.Dropout) and context.method_name == "__call__":
                det = nn.merge_param("deterministic", m.deterministic, kwargs.get("deterministic"))
                if m.rate > 0 and not det:
                    key = m.make_rng(m.rng_collection)
                    masks.append(jax.random.bernoulli(key, 1.0 - m.rate, args[0].shape))
                    return next_fun(*args, **{**kwargs, "rng": key})
            return next_fun(*args, **kwargs)

        randint = jax.random.randint

        def recorded_randint(*a, **k):
            out = randint(*a, **k)
            picks.append(out)
            return out

        with nn.intercept_methods(interceptor), \
                mock.patch.object(jax.random, "randint", recorded_randint):
            out = model.apply({"params": params}, mel, train=train, rngs=rngs, **kw)
        return out, {"masks": masks, "picks": picks}

    return model_apply


class _IdentityFrontend:
    def __call__(self, wav, key=None, training=False):
        return wav

    def normalize(self, mel):
        return mel


def step_batch():
    rng = np.random.RandomState(12)
    return {"wav": mel(B, 12), "labels": (rng.rand(B, 3, T) > 0.7).astype(np.float32)}


def _preprocess_draws(keys, cfg):
    """The draws ``make_dasm_step`` makes from each of ``keys`` before the
    forward, as numpy: shifts, the mixup coefficient, whether it mixes, the
    permutation, and filt_aug's band count, boundary draw for that count and
    gains (two programs)."""

    def raw(key):
        _, kshift, kmix, kmixp, ktrans, _ = jax.random.split(key, 6)
        return ((jax.random.normal(kshift, (B,)) * cfg.max_shift_frame).astype(jnp.int32),
                jax.random.beta(jax.random.fold_in(kmix, 0), cfg.mixup_alpha, cfg.mixup_beta),
                jax.random.uniform(kmixp) < cfg.mixup_prob,
                jax.random.permutation(jax.random.fold_in(kmix, 1), B),
                jax.random.split(jax.random.fold_in(ktrans, 0), 5)[0])

    raw, (lo, hi), (lo_db, hi_db) = jit0(raw), cfg.filter_bands, cfg.filter_db_range
    filt = filt_draws_program(B, MEL_F, lo, hi, cfg.filter_minimum_bandwidth,
                              cfg.filter_type == "linear")
    out = []
    for key in keys:
        shifts, c, do_mix, perm, k0 = raw(key)
        nb, raws, fdb = filt(k0)
        out.append(dict(shifts=np.asarray(shifts).astype(np.int64), c=float(c),
                        do_mix=bool(do_mix), perm=np.asarray(perm).astype(np.int64),
                        n_bands=int(nb), band_raw=np.asarray(raws[int(nb) - lo]).astype(np.int64),
                        band_db=(np.asarray(fdb) * (hi_db - lo_db) + lo_db).astype(np.float32)))
    return out


def trajectory(case, n_steps, sd):
    """``n_steps`` of ``make_dasm_step`` from the port's seeded state dict
    ``sd``: per step its metrics, its preprocess draws and the forward's
    (dropout keep masks, modality pick); the end params tree; the step count."""
    c = STEP_CASES[case]
    jmodel = jax_dasm.DASM(**case_model(case))
    params = jax_variables(sd)["params"]
    cfg = jax_recipe.DASMTrainConfig(**step_config(case))
    tx, _ = jax_optim.build_optimizer(params, jax_opt_cfg(**c["groups"]))
    step = jax_recipe.make_dasm_step(recording_apply(jmodel), _IdentityFrontend(), tx, cfg)
    query = case_query(case)
    extra = {} if query is None else {"query": _to_jax({"q": query})["q"]}
    fn = jax.jit(lambda s, b, k: step(s, b, k, extra_kwargs=extra))
    state = MLMState(params=params, opt_state=jit0(tx.init)(params),
                     step=jnp.zeros((), jnp.int32), model_state=None)
    batch = {k: jnp.asarray(v) for k, v in step_batch().items()}
    keys = [jax.random.PRNGKey(i) for i in range(n_steps)]
    # the tracing records the draws through a process-wide patch of randint;
    # once it is done, the preprocess draws compile in a thread beside the step
    lowered = fn.lower(state, batch, keys[0])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        preprocess = pool.submit(_preprocess_draws, keys, cfg)
        compiled = lowered.compile(OPT0)
        preprocess = preprocess.result()
    steps = []
    for key, pre in zip(keys, preprocess):
        state, metrics = compiled(state, batch, key)
        draws = state.model_state
        steps.append(dict(
            metrics={k: float(v) for k, v in metrics.items()}, **pre,
            masks=[np.asarray(m) for m in draws["masks"]],
            pick=np.asarray(draws["picks"][0]).astype(np.int64) if draws["picks"] else None))
        state = state.replace(model_state=None)
    return steps, jax.device_get(state.params), int(state.step)
