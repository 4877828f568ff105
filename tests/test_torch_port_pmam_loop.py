"""PMAM's tokenizer and post-pretraining in the port, held against the JAX
package on the CPU.

LoRA (each layer, ``merge_lora``, ``lora_params``, the weight bridge, an
upstream ``.pt`` loaded merged and unmerged), the LoRA ViT block, the tiny
``PaSST_CNN(mlm=True)`` forward on the JAX masker's draws, the optimizer's
labels with ``opt.lora_trainable``, the prototype loss and a 3-step
post-pretraining trajectory against ``make_pmam_step(model_state_aware=True)``,
the tap and its downsampling, the GMM, KMeans and PCA, the pseudo-label TSVs,
and the four ``pmam_*`` stages through ``recipes.cli.main --device cpu``. The
JAX model is never initialised: the port model is seeded (``lora_B``
non-zero, so the low-rank path shows) and its state dict goes through the JAX
package's ``convert_torch_checkpoint(..., lora_merged=False)``. The JAX side
is compiled and run in two worker threads from the module's start (the model
programs in one, the layers, losses and clustering in the other), in the
order the tests read it; the keys the JAX masker is called with are recorded by a spy on
``MLMMasker.__call__`` for the module's life. Everything compares in
float32. The JAX CLI is not run here: its stages take minutes on the CPU.
"""

import concurrent.futures
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from transformer4sed_tpu.models import lora as jax_lora
from transformer4sed_tpu.models import mlm as jax_mlm
from transformer4sed_tpu.models import vit as jax_vit
from transformer4sed_tpu.models.passt_cnn import PaSST_CNN as JaxPaSSTCNN
from transformer4sed_tpu.pmam import features as jax_features
from transformer4sed_tpu.pmam import gmm as jax_gmm
from transformer4sed_tpu.pmam import pseudo_labels as jax_pseudo
from transformer4sed_tpu.pmam import train as jax_pmam
from transformer4sed_tpu.recipes.common import make_model_apply
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.train.mlm import MLMState
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.models import lora
from transformer4sed_tpu_torch.models.mlm import MLMDraws
from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
from transformer4sed_tpu_torch.pmam import features, gmm, pseudo_labels
from transformer4sed_tpu_torch.pmam import train as pmam_train
from transformer4sed_tpu_torch.recipes import cli
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import init_weights_, jax_params_to_state_dict
from transformer4sed_tpu_torch.utils.yamlio import safe_dump
from tests.test_torch_port_pmam import FRAMES, TINY
from tests.torch_port_jax import jit0

# the PMAM network of tests/test_torch_port_pmam.py in post-pretraining mode:
# LoRA of rank 2 on every backbone block, block masking of 80 % with the
# config's styles, an MLM head as wide as the transformer_0 tap (the decoder)
POST = dict(TINY, lora_rank=2, lora_alpha=1.0, mlm=True,
            mlm_dict=dict(mask_rate=0.8, mask_style=(0.9, 0.05, 0.05), strategy="block",
                          block_width=10, out_dim=32))
K = 3  # prototypes
# elementwise f32 functions and small sums: a few ulps
ATOL_ELEM = 1e-6
# model outputs after a dozen f32 matmuls, summed in another order
ATOL_MODEL = 5e-5
# trajectory bounds of tests/test_torch_port_pmam.py
ATOL_LOSS = RTOL_LOSS = 2e-5
# params after three AdamW steps at lr 2e-3 (tests/test_torch_port_mlm.py)
ATOL_PARAMS = 5e-6
# GMM posteriors through a Cholesky solve (JAX) and a whitening GEMM (port)
ATOL_PROBA = 1e-5
# one EM iteration, and a 5-iteration fit, relative to each tensor's largest value
RTOL_EM, RTOL_FIT = 1e-5, 1e-4
# post_pretrain.yaml's groups with head and decoder at 2e-3: the encoder frozen
# by lr 0, the LoRA factors at the decoder's rate
OPT_CFG = dict(encoder=dict(lr=0.0, weight_decay=1e-4), decoder=dict(lr=2e-3, weight_decay=1e-4),
               head=dict(lr=2e-3, weight_decay=1e-4))
PMAM_KW = dict(temperature=0.1, w_at=0.1, max_shift_frame=0, transform_choice=(0, 0, 0, 0))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _mel(b, seed):
    return (np.random.RandomState(seed).randn(b, 128, FRAMES) * 0.5).astype(np.float32)


def _as_draws(noise, probs, rand_src) -> MLMDraws:
    return MLMDraws(noise=torch.from_numpy(np.array(noise)),
                    probs=torch.from_numpy(np.array(probs)),
                    rand_src=torch.from_numpy(np.array(rand_src)).long())


def _mask_draws(key, b, t=FRAMES, block_width=10) -> MLMDraws:
    """The draws the JAX block masker makes from ``key``."""
    kmask, kprob, krand = jax.random.split(jnp.asarray(key), 3)
    return _as_draws(jax.random.uniform(kmask, (b, t // block_width)),
                     jax.random.uniform(kprob, (b, t)),
                     jax.random.randint(krand, (b, t), 0, b * t))


class _IdentityFrontend:
    """mel in, mel out: the train step without the STFT."""

    def __call__(self, wav, fminmax=None, key=None, training=False):
        return wav

    def draw_fminmax(self, gen):
        return None

    def normalize(self, mel):
        return mel


def _clusters(n_per=200, d=6, k=K, seed=0):
    """Well-separated Gaussian clusters of different spreads, shuffled."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 6
    x = np.concatenate([centers[i] + rng.randn(n_per, d) * (0.5 + 0.2 * i) for i in range(k)])
    rng.shuffle(x)
    return x.astype(np.float32)


# -- the seeded port models and the JAX side ---------------------------------------------


@pytest.fixture(scope="module")
def post():
    """(seeded post-pretrain port model, its JAX variables, the JAX model)."""
    port = init_weights_(PaSST_CNN(**POST, device="cpu"), seed=0)
    params, model_state = convert_torch_checkpoint(_np_state(port), "PaSST_CNN",
                                                   init_kwargs=POST, lora_merged=False)
    return port, {"params": params, **model_state}, JaxPaSSTCNN(**POST)


def _pmam_step_setup(variables, jmodel):
    params, model_state = variables["params"], {"batch_stats": variables["batch_stats"]}
    jopt = jax_optim.ParamGroupConfig(**{k: jax_optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                      backbone_depth=2, clip_grad=0.05, lora_trainable=True)
    tx, _ = jax_optim.build_optimizer(params, jopt)
    means = np.random.RandomState(3).randn(K, 32).astype(np.float32)
    step = jax_pmam.make_pmam_step(make_model_apply(jmodel, True), _IdentityFrontend(), tx,
                                   means, jax_pmam.PMAMConfig(**PMAM_KW), model_state_aware=True)
    state = MLMState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                     model_state=model_state)
    mel = _mel(3, seed=5)
    labels = np.random.RandomState(6).dirichlet(np.ones(K), (3, FRAMES)).transpose(0, 2, 1)
    labels = labels.astype(np.float32)
    batch = {"wav": jnp.asarray(mel), "labels": jnp.asarray(labels)}
    return jit0(step), state, means, mel, labels, batch


class _Opt0Jax:
    """The ``jax`` module with ``jit`` compiling at OPT0 (``jit0``), for the
    JAX package's own jitted helpers."""

    jit = staticmethod(jit0)

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_side(post, keys):
    """Every JAX-side result of the module, in the order the tests read them;
    ``keys`` collects the masker's keys of each run."""
    _, variables, jmodel = post
    out = {}

    def recorded(fn):
        keys.clear()
        value = fn()
        jax.effects_barrier()
        return value, [np.asarray(k) for k in keys]

    # the MLM forward in training mode, with the new BatchNorm statistics
    mel = _mel(2, seed=1)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("patchout", "dropout", "mlm"))}
    fwd = jit0(lambda v, m: jmodel.apply(v, m, train=True, rngs=rngs, mutable=["batch_stats"]))
    out["forward"] = (mel,) + recorded(lambda: fwd(variables, jnp.asarray(mel)))
    # the same program on an upstream .pt's weights, as convert_torch_checkpoint
    # reads them under each merged-ness policy
    out["pt"] = {}
    for policy in ("merged", "unmerged"):
        sd = {k: v.numpy() for k, v in _pt_state(policy)[1].items()}
        params, model_state = convert_torch_checkpoint(sd, "PaSST_CNN", init_kwargs=POST,
                                                       lora_merged=policy == "merged")
        out["pt"][policy] = recorded(lambda: fwd({"params": params, **model_state},
                                                 jnp.asarray(mel)))
    # the taps: JAX's own extraction, two batches of two clips, its jitted
    # forward compiled at OPT0 like every other program here
    mels = [_mel(2, seed=2), _mel(2, seed=3)]
    jax_features.jax = _Opt0Jax()
    try:
        for layer in ("transformer_0", "after_interpolate"):
            out[layer] = (mels,) + recorded(lambda: jax_features.extract_frame_features(
                jmodel, variables, [jnp.asarray(m) for m in mels], feature_layer=layer,
                downsample_rate=4))
    finally:
        jax_features.jax = jax
    # the post-pretraining trajectory
    step, state, means, mel, labels, batch = _pmam_step_setup(variables, jmodel)
    traj = []
    for i in range(3):
        (state, metrics), ks = recorded(lambda: step(state, batch, jax.random.PRNGKey(i)))
        traj.append(({k: float(v) for k, v in metrics.items()}, ks[-1]))
    out["trajectory"] = (means, mel, labels, traj, state)
    return out


@pytest.fixture(scope="module")
def jax_side(post):
    """:func:`_jax_side` in a worker thread from the module's start (XLA
    compiles without holding the GIL, alongside the port-side tests)."""
    keys = []
    real = jax_mlm.MLMMasker.__call__

    def spy(self, key, token_seq, mask_token):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), key)
        return real(self, key, token_seq, mask_token)

    jax_mlm.MLMMasker.__call__ = spy
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_jax_side, post, keys)
    yield future
    pool.shutdown(wait=True)
    jax_mlm.MLMMasker.__call__ = real


@pytest.fixture(scope="module")
def small(post):
    """The JAX side of the layer, loss, sampling and clustering tests: each
    job's future, computed in a second worker thread from the module's start."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    futures = {name: pool.submit(job) for name, job in _small_jobs(post).items()}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def start_jax_side(jax_side, small):
    """Both workers start with the module."""
    return jax_side, small


# -- LoRA ------------------------------------------------------------------------------


def _factors(layer, seed):
    """Non-zero factors on a port LoRA layer (a fresh lora_B is zero)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in (layer.lora_A, layer.lora_B):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return layer


def _jax_layer(layer):
    """(flax module, its params) of a port LoRA layer, in the JAX layouts."""
    t = {k: v.detach().numpy() for k, v in layer.state_dict().items()}
    if isinstance(layer, lora.LoRAMergedDense):
        r, gs = layer.rank, layer.group_size
        params = {"kernel": t["weight"].T, "bias": t["bias"]}
        j = 0
        for i, on in enumerate(layer.enable_lora):
            if on:
                params[f"lora_A_g{i}"] = t["lora_A"][j * r:(j + 1) * r].T
                params[f"lora_B_g{i}"] = t["lora_B"][j * gs:(j + 1) * gs].T
                j += 1
        return jax_lora.LoRAMergedDense(layer.out_features, enable_lora=layer.enable_lora,
                                        rank=r, alpha=layer.alpha), params
    ab = {"lora_A": t["lora_A"].T, "lora_B": t["lora_B"].T}
    if isinstance(layer, lora.LoRADense):
        return (jax_lora.LoRADense(layer.out_features, rank=layer.rank, alpha=layer.alpha),
                {"kernel": t["weight"].T, "bias": t["bias"], **ab})
    if isinstance(layer, lora.LoRAEmbedding):
        return (jax_lora.LoRAEmbedding(layer.num_embeddings, layer.embedding_dim, rank=layer.rank,
                                       alpha=layer.alpha), {"embedding": t["weight"], **ab})
    return (jax_lora.LoRAConv(layer.out_channels, kernel_size=layer.kernel_size, rank=layer.rank,
                              alpha=layer.alpha),
            {"kernel": t["weight"].transpose(2, 3, 1, 0), "bias": t["bias"], **ab})


LAYERS = {
    "dense": lambda: lora.LoRADense(12, 9, rank=3, alpha=2.0),
    "merged": lambda: lora.LoRAMergedDense(12, 9, enable_lora=(True, False, True), rank=2,
                                           alpha=4.0),
    "embedding": lambda: lora.LoRAEmbedding(11, 7, rank=2, alpha=1.5),
    "conv": lambda: lora.LoRAConv(3, 5, kernel_size=(3, 3), rank=4, alpha=2.0),
}


def _seeded_layer(name):
    return _factors(init_weights_(LAYERS[name](), seed=1), seed=2)


def _layer_input(name):
    rng = np.random.RandomState(len(name))
    if name == "embedding":
        return rng.randint(0, 11, (4, 6))
    if name == "conv":
        return rng.randn(2, 3, 8, 7).astype(np.float32)
    return rng.randn(4, 5, 12).astype(np.float32)


def _jax_layer_out(name):
    module, params = _jax_layer(_seeded_layer(name))
    x = _layer_input(name)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1) if name == "conv" else x)
    want = np.asarray(jit0(lambda p, v: module.apply({"params": p}, v))(params, jx))
    return want.transpose(0, 3, 1, 2) if name == "conv" else want


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_lora_layer_matches_jax(name, small):
    layer = _seeded_layer(name)
    params = _jax_layer(layer)[1]
    x = _layer_input(name)
    want = small[f"layer_{name}"].result()
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_ELEM, rtol=1e-5)
    with torch.no_grad():  # the low-rank path is there: without it the outputs differ
        layer.lora_B.zero_()
        assert np.abs(layer(torch.from_numpy(x)).numpy() - want).max() > 1e-3
    # the weight bridge: flax factors to upstream's layouts (a merged Dense's
    # groups stacked, enabled groups in order)
    sd = jax_params_to_state_dict({"layer": params})
    for key in ("lora_A", "lora_B"):
        np.testing.assert_array_equal(sd[f"layer.{key}"], layer.state_dict()[key].numpy())


def _merge_layers():
    layers = nn.ModuleDict({n: _factors(init_weights_(f(), seed=3), seed=i)
                            for i, (n, f) in enumerate(sorted(LAYERS.items()))})
    for name in ("dense", "conv", "embedding", "merged"):  # one alpha / r for JAX's argument
        layers[name].scale = 0.5
    return layers


def _jax_merge():
    """(merged tree, lora_params tree, lora_label_fn leaves) of the JAX package."""
    tree = {n: _jax_layer(m)[1] for n, m in _merge_layers().items()}
    merged = jax.tree_util.tree_map(np.asarray, jax_lora.merge_lora(tree, alpha_over_rank=0.5))
    return (merged, jax_lora.lora_params(tree),
            jax.tree_util.tree_leaves(jax_lora.lora_label_fn(tree, ("conv/bias",))))


def test_merge_lora_and_lora_params_match_jax(small):
    """``merge_lora`` folds each layer's delta at its own alpha / r into the
    base weight and drops the factors; ``lora_params`` keeps only them."""
    layers = _merge_layers()
    merged, want, jlabels = small["merge"].result()
    got = lora.merge_lora(layers)
    assert sorted(got) == sorted(k for k in layers.state_dict() if "lora" not in k)
    np.testing.assert_allclose(got["dense.weight"].numpy(), merged["dense"]["kernel"].T,
                               atol=ATOL_ELEM)
    np.testing.assert_allclose(got["merged.weight"].numpy(), merged["merged"]["kernel"].T,
                               atol=ATOL_ELEM)
    np.testing.assert_allclose(got["embedding.weight"].numpy(), merged["embedding"]["embedding"],
                               atol=ATOL_ELEM)
    np.testing.assert_allclose(got["conv.weight"].numpy(),
                               merged["conv"]["kernel"].transpose(3, 2, 0, 1), atol=ATOL_ELEM)
    for tree_ in merged.values():
        assert not any(k.startswith("lora") for k in tree_)
    port = lora.lora_params(layers.state_dict())
    assert sorted(port) == sorted(f"{n}.{leaf}" for n in ("dense", "conv", "embedding", "merged")
                                  for leaf in ("lora_A", "lora_B"))
    assert {n: sorted(v) for n, v in want.items()} == {
        "dense": ["lora_A", "lora_B"], "conv": ["lora_A", "lora_B"],
        "embedding": ["lora_A", "lora_B"], "merged": ["lora_A_g0", "lora_A_g2", "lora_B_g0",
                                                      "lora_B_g2"]}
    labels = lora.lora_label_fn(layers.state_dict(), trainable_extra=("conv.bias",))
    assert list(labels.values()).count("frozen") == jlabels.count("frozen") == 6
    assert {k for k, v in labels.items() if v == "lora"} == set(port) | {"conv.bias"}


def _block_input():
    return np.random.RandomState(4).randn(2, 37, 48).astype(np.float32)


def _jax_block(post):
    jblk = jax_vit.Block(num_heads=4, lora_rank=2, lora_alpha=1.0, ln_eps=1e-6)
    return np.asarray(jit0(lambda p, v: jblk.apply({"params": p}, v))(
        post[1]["params"]["backbone"]["blocks_0"], jnp.asarray(_block_input())))


def test_lora_vit_block_matches_jax(post, small):
    """A backbone block with LoRA on qkv, proj, fc1 and fc2: the delta adds to
    the whole qkv output before the heads-in-lanes slices."""
    blk = post[0].backbone.blocks[0]
    assert isinstance(blk.attn.qkv, lora.LoRADense) and isinstance(blk.mlp.fc2, lora.LoRADense)
    assert blk.attn.qkv.lora_A.shape == (2, 48) and blk.attn.qkv.lora_B.shape == (144, 2)
    assert float(blk.attn.qkv.lora_B.detach().abs().min()) > 0  # seeded non-zero
    x = _block_input()
    want = small["block"].result()
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MODEL)


# -- checkpoints ------------------------------------------------------------------------------


SERVE_CONFIG = {
    "model_name": "PaSST_CNN", "PaSST_CNN": {"init_kwargs": POST},
    "feature": {"audio_max_len": 1.2, "sr": 32000, "hopsize": 320, "n_fft": 1024,
                "net_subsample": 1, "pred_len": FRAMES},
    "dataset": {"labels": ["a", "b", "c"]}, "training": {"median_window": 5}}


def _pt_state(policy):
    """(a seeded post-pretrain PaSST_CNN, its upstream-layout state dict with the
    LoRA delta merged into the weights, as published saves are, or not, as
    mid-training saves are)."""
    src = init_weights_(PaSST_CNN(**POST, device="cpu"), seed=7)
    sd = src.state_dict()
    if policy == "merged":
        for name, m in lora.lora_modules(src).items():
            sd[f"{name}.weight"] = (m.weight + lora.delta_weight(m)).detach()
    return src, sd


def test_optimizer_labels_with_lora_trainable_match_jax(post):
    """The LoRA factors take the decoder group inside a backbone that the
    encoder's lr 0 freezes: the port's labels on torch names equal JAX's."""
    port, variables, _ = post
    jcfg = jax_optim.ParamGroupConfig(**{k: jax_optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                      backbone_depth=2, lora_trainable=True)
    pcfg = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                  backbone_depth=2, lora_trainable=True)
    params = variables["params"]
    jlabels = jax_optim.label_params(params, jcfg)
    codes = {n: i for i, n in enumerate(sorted(set(jax.tree_util.tree_leaves(jlabels))))}
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   jlabels, params)
    ours = optim.label_params(dict(port.named_parameters()), pcfg)
    assert ours["backbone.blocks.1.mlp.fc2.lora_B"] == "decoder"
    assert ours["backbone.blocks.1.mlp.fc2.weight"] == "frozen"
    for name, arr in jax_params_to_state_dict(coded).items():
        assert np.all(arr == codes[ours[name]]), name
    off = optim.label_params(dict(port.named_parameters()),
                             optim.ParamGroupConfig(**{k: optim.GroupSpec(**v)
                                                       for k, v in OPT_CFG.items()}))
    assert off["backbone.blocks.1.mlp.fc2.lora_B"] == "frozen"


def test_one_predicate_names_the_lora_factors():
    """``is_lora_factor`` reads the whole last name component, and the
    optimizer's labels and ``lora_params`` go by it."""
    names = {"backbone.blocks.0.attn.qkv.lora_A": True, "qkv.lora_B": True, "lora_A_g2": True,
             "backbone.blocks.0.attn.xlora_A_proj.weight": False,
             "backbone.lora_A.weight": False, "decoder.lora_Bias": False,
             "backbone.blocks.0.mlp.fc1.lora_B_g0": True}
    assert {n: lora.is_lora_factor(n) for n in names} == names
    cfg = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                 backbone_depth=1, lora_trainable=True)
    labels = optim.label_params(names, cfg)
    assert {n for n, lab in labels.items() if lab == "decoder" and n.startswith("backbone.")} == {
        n for n, is_factor in names.items() if is_factor and n.startswith("backbone.")}
    sd = {n: torch.zeros(1) for n in names}
    assert set(lora.lora_params(sd)) == {n for n, is_factor in names.items() if is_factor}


# -- the prototype loss and the post-pretraining step -----------------------------------------


def _proto_inputs():
    """(logit with a zero row, means, targets, masks)."""
    rng = np.random.RandomState(9)
    logit = rng.randn(2, 7, 5).astype(np.float32)
    logit[0, 3] = 0.0  # a zero row: the norm's 1e-12 clamp
    means = (rng.randn(4, 5) * 3).astype(np.float32)
    target = rng.rand(2, 7, 4).astype(np.float32)
    return logit, means, target, (rng.rand(2, 7) > 0.5, np.zeros((2, 7), bool))


def _jax_proto():
    """(JAX's predictions, those with one saturated at 1, JAX's masked BCE of
    the latter under each mask)."""
    logit, means, target, masks = _proto_inputs()
    want = np.asarray(jit0(lambda x, m: jax_pmam.prototype_predictions(x, m, 0.1))(logit, means))
    pred = want.copy()
    pred[1, 2, 0] = 1.0  # a saturated prediction: the NaN-safe log
    bces = jit0(lambda p, t, ms: [jax_pmam.masked_bce(p, t, m) for m in ms])(
        pred, target, [m.astype(np.float32) for m in masks])
    return want, pred, [float(b) for b in bces]


def test_prototype_predictions_and_masked_bce_match_jax(small):
    logit, means, target, masks = _proto_inputs()
    want, pred, bces = small["proto"].result()
    got = pmam_train.prototype_predictions(torch.from_numpy(logit), torch.from_numpy(means), 0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_ELEM)
    for mask, w in zip(masks, bces):
        g = pmam_train.masked_bce(torch.from_numpy(pred), torch.from_numpy(target),
                                  torch.from_numpy(mask))
        np.testing.assert_allclose(float(g), w, rtol=1e-6, atol=ATOL_ELEM)


# -- the tap -------------------------------------------------------------------------------------


def _jax_sample():
    """(JAX's sampled rows, the offsets its key draws) of 103 rows at rate 4."""
    feats = np.random.RandomState(10).randn(103, 5).astype(np.float32)
    want, offsets = jit0(lambda k, f: (jax_features.sample_features(k, f, 4),
                                       jax.random.randint(k, (26,), 0, 4)))(
        jax.random.PRNGKey(11), feats)
    return np.asarray(want), np.array(offsets)


def test_sample_features_matches_jax_on_its_offsets(small):
    feats = np.random.RandomState(10).randn(103, 5).astype(np.float32)
    want, offsets = small["sample"].result()
    got = features.sample_features(torch.from_numpy(feats), 4,
                                   offsets=torch.from_numpy(offsets).long())
    np.testing.assert_array_equal(got.numpy(), want)
    own = features.sample_features(torch.from_numpy(feats), 4, torch.Generator().manual_seed(0))
    assert own.shape == (26, 5)


# -- GMM, KMeans, PCA ----------------------------------------------------------------------------


def _gmm_arrays(g):
    return g.means, g.covariances, g.weights


def _jax_em(cov):
    """JAX's 1-iteration fit and its posteriors."""
    x = _clusters(seed=1)
    one = jax_gmm.GaussianMixture(K, cov, n_iter=1).fit(x)
    return _gmm_arrays(one), one.predict_proba(x)


def _jax_fit(cov):
    """JAX's 5-iteration fit and its labels."""
    x = _clusters(seed=2)
    fit = jax_gmm.GaussianMixture(K, cov, n_iter=5).fit(x)
    return _gmm_arrays(fit), fit.predict(x)


def _pca_data():
    """A rotated Gaussian with well-separated variances (5^2 .. 0.5^2), so each
    component is defined to well within the bound (the clusters' within
    spread is near-isotropic: their third component is not)."""
    rng = np.random.RandomState(5)
    rot, _ = np.linalg.qr(rng.randn(6, 6))
    return ((rng.randn(600, 6) * [5.0, 3.0, 2.0, 1.2, 0.8, 0.5]) @ rot.T + 2.0).astype(np.float32)


def _jax_kmeans_pca():
    x, y = _clusters(seed=3), _pca_data()
    km = jax_gmm.KMeans(K, n_iter=5, seed=4).fit(x)
    pca = jax_gmm.PCA(3).fit(y)
    return km.means, km.predict(x), pca.mean_, pca.components_, pca.transform(y)


@pytest.mark.parametrize("cov", ["full", "diag"])
def test_gmm_predict_proba_and_one_em_iteration_match_jax(cov, small):
    """``predict_proba`` on given parameters; one EM iteration from the
    KMeans start (the same centroids: numpy's generator makes every choice).
    The covariances are held to the same iteration in float64: the JAX
    class's E[x x^T] - mu mu^T in float32 is itself 5.5e-5 (full) and 6.8e-5
    (diag) off it on these clusters (|mu|^2 / sigma^2 near 300), the port's
    moments about the incoming means 2.2e-7 and 1.2e-7; against JAX they get
    the 5-iteration bound."""
    x = _clusters(seed=1)
    one, proba = small[f"em_{cov}"].result()
    ours = gmm.GaussianMixture(K, cov, n_iter=1, device="cpu").fit(x)
    init = ours.initial_state(x)
    f64 = gmm.GaussianMixture(K, cov, device="cpu", dtype=torch.float64).em_step(
        x.astype(np.float64), *(np.asarray(a, np.float64) for a in init))
    for i, name in enumerate(("means", "covariances", "weights")):
        want, exact = one[i], f64[i].numpy()
        np.testing.assert_allclose(getattr(ours, name), exact,
                                   atol=RTOL_EM * float(np.abs(exact).max()), err_msg=name)
        rtol = RTOL_FIT if name == "covariances" else RTOL_EM
        np.testing.assert_allclose(getattr(ours, name), want,
                                   atol=rtol * float(np.abs(want).max()), err_msg=name)
    given = gmm.GaussianMixture(K, cov, device="cpu")
    given.means, given.covariances, given.weights = one
    np.testing.assert_allclose(given.predict_proba(x), proba, atol=ATOL_PROBA)
    assert torch.is_tensor(given.predict_proba(torch.from_numpy(x)))


@pytest.mark.parametrize("cov", ["full", "diag"])
def test_gmm_fit_on_separated_clusters_matches_jax(cov, small):
    x = _clusters(seed=2)
    want, labels = small[f"fit_{cov}"].result()
    got = gmm.GaussianMixture(K, cov, n_iter=5, device="cpu").fit(x)
    for name, w in zip(("means", "covariances", "weights"), want):
        np.testing.assert_allclose(getattr(got, name), w, atol=RTOL_FIT * float(np.abs(w).max()),
                                   err_msg=name)
    ll = np.array(got.log_likelihoods)
    assert len(ll) == 5 and np.all(np.diff(ll) > -1e-4)
    assert np.array_equal(got.predict(x), labels)
    with pytest.raises(ValueError, match="covariance type"):
        gmm.GaussianMixture(K, "tied", device="cpu")


def test_kmeans_and_pca_match_jax(small):
    x, y = _clusters(seed=3), _pca_data()
    km_means, km_labels, pca_mean, pca_components, pca_y = small["kmeans_pca"].result()
    got = gmm.KMeans(K, n_iter=5, seed=4, device="cpu").fit(x)
    np.testing.assert_allclose(got.means, km_means, atol=1e-5)
    np.testing.assert_array_equal(got.predict(x), km_labels)
    pca_g = gmm.PCA(3, device="cpu").fit(y)
    np.testing.assert_allclose(pca_g.mean_, pca_mean, atol=1e-6)
    sign = np.sign((pca_g.components_ * pca_components).sum(1, keepdims=True))
    np.testing.assert_allclose(pca_g.components_ * sign, pca_components, atol=1e-5)
    np.testing.assert_allclose(pca_g.fit_transform(y) * sign.T, pca_y, atol=1e-4)


def test_gmm_keeps_full_float32_whatever_the_global_tf32_setting():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with gmm.full_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _small_jobs(post):
    """The small worker's jobs by name, in the order the tests read them."""
    jobs = {f"layer_{name}": functools.partial(_jax_layer_out, name) for name in sorted(LAYERS)}
    jobs.update(merge=_jax_merge, block=functools.partial(_jax_block, post), proto=_jax_proto,
                sample=_jax_sample)
    for cov in ("full", "diag"):
        jobs[f"em_{cov}"] = functools.partial(_jax_em, cov)
        jobs[f"fit_{cov}"] = functools.partial(_jax_fit, cov)
    jobs["kmeans_pca"] = _jax_kmeans_pca
    return jobs


# -- on the JAX side's compiled model programs: read last, once the worker is done --------


def test_post_pretrain_forward_matches_jax_on_its_draws(post, jax_side):
    """The tiny PaSST_CNN(mlm=True) with LoRA in training mode, fed the JAX
    masker's draws: the MLM prediction, the frames before masking, the mask,
    the AT branch and the new BatchNorm statistics."""
    port, _, _ = post
    mel, (want, new), keys = jax_side.result()["forward"]
    model = PaSST_CNN(**POST, device="cpu").train()
    model.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(mel), train=True, mlm_draws=_mask_draws(keys[-1], 2))
    assert got.strong is None and got.mlm_pred.shape == (2, FRAMES, 32)
    np.testing.assert_array_equal(got.mask_id_seq.numpy(), np.asarray(want.mask_id_seq))
    for name in ("mlm_pred", "frame_before_mask", "at_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL_MODEL, err_msg=name)
    sd = model.state_dict()
    for name, val in jax_params_to_state_dict({"params": {}, **new}, names=sd.keys()).items():
        np.testing.assert_allclose(sd[name].numpy(), val, atol=ATOL_MODEL, err_msg=name)


@pytest.mark.parametrize("layer", ["transformer_0", "after_interpolate"])
def test_extract_frame_features_matches_jax(post, jax_side, layer):
    """JAX's ``extract_frame_features`` (two batches; the forward's 'mlm' key
    and the offsets folded from ``PRNGKey(0)``) against the port's on the same
    draws; the tap stops the forward early and registers no hook."""
    port, _, _ = post
    mels, want, keys = jax_side.result()[layer]
    base = jax.random.PRNGKey(0)
    offsets = [torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(base, i), (2 * FRAMES // 4,), 0, 4))).long() for i in range(2)]
    draws = [_mask_draws(k, 2) for k in keys] if layer == "transformer_0" else None
    model = port.eval()
    got = features.extract_frame_features(model, [torch.from_numpy(m) for m in mels], layer, 4,
                                          mlm_draws=draws, offsets=offsets)
    assert got.shape == (2 * 2 * FRAMES // 4, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_MODEL)
    assert not any(m._forward_hooks for m in model.modules())
    with pytest.raises(RuntimeError, match="unknown feature layer"):
        model.tap(torch.from_numpy(mels[0]), "transformer_x")
    with pytest.raises(ValueError, match="no decoder block"):
        model.tap(torch.from_numpy(mels[0]), "transformer_5", torch.Generator())


def test_post_pretrain_trajectory_matches_jax(post, jax_side):
    """Three steps of ``PMAMTrainer`` against ``make_pmam_step``
    (``model_state_aware``; shift and views off, identity frontend, the JAX
    masker's draws, the post-pretrain groups, an active clip): each step's
    losses; then the LoRA factors against JAX's, and only the LoRA factors,
    the decoder and the heads moved."""
    port, _, _ = post
    means, mel, labels, traj, state = jax_side.result()["trajectory"]
    model = PaSST_CNN(**POST, device="cpu")
    model.load_state_dict(port.state_dict())
    popt = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                  backbone_depth=2, clip_grad=0.05, lora_trainable=True)
    trainer = pmam_train.PMAMTrainer(model, _IdentityFrontend(), means,
                                     pmam_train.PMAMConfig(**PMAM_KW), popt)
    gen = torch.Generator().manual_seed(0)
    names = ("loss_total", "loss_strong", "loss_weak")
    for i, (jm, key) in enumerate(traj):
        pm = trainer.step({"wav": mel, "labels": labels}, gen, mlm_draws=_mask_draws(key, 3))
        np.testing.assert_allclose([float(pm[k]) for k in names], [jm[k] for k in names],
                                   atol=ATOL_LOSS, rtol=RTOL_LOSS, err_msg=f"step {i}")
        assert float(pm["loss_weak"]) > 0 and float(pm["grad_norm"]) > popt.clip_grad
    assert trainer.step_count == int(state.step) == 3
    ours, start = model.state_dict(), port.state_dict()
    want = jax_params_to_state_dict(state.params)
    moved = {k for k in ours if not torch.equal(ours[k], start[k])}
    factors = {k for k in ours if lora.is_lora_factor(k)}
    assert len(factors) == 16 and factors <= moved
    for name in factors:
        np.testing.assert_allclose(ours[name].numpy(), want[name], atol=ATOL_PARAMS, err_msg=name)
    backbone = {k for k in ours if k.startswith("backbone.")} - factors
    assert not backbone & moved
    assert {k for k in ours if k.startswith(("decoder.", "mlm_mlp."))} <= moved
    with pytest.raises(ValueError, match="out_dim"):
        pmam_train.PMAMTrainer(model, _IdentityFrontend(), np.zeros((K, 48), np.float32))


@pytest.mark.parametrize("policy", ["merged", "unmerged"])
def test_upstream_lora_pt_loads_like_convert_torch_checkpoint(policy, jax_side, tmp_path):
    """An upstream-layout ``.pt`` of the post-pretrain PaSST_CNN, its weights
    with the delta merged in or not, loaded by the port's serving path with
    ``--lora_ckpt``: the raw weights again, and the MLM forward against the
    JAX model that ``convert_torch_checkpoint`` builds with the same policy,
    on its draws."""
    src, sd = _pt_state(policy)
    path = str(tmp_path / "upstream.pt")
    torch.save(sd, path)
    served = cli.serving_model(SERVE_CONFIG, path, torch.device("cpu"), lora_ckpt=policy)
    for key, val in src.state_dict().items():
        np.testing.assert_allclose(served.model.state_dict()[key].numpy(), val.numpy(),
                                   atol=ATOL_ELEM, err_msg=key)
    mel = jax_side.result()["forward"][0]
    (want, _), keys = jax_side.result()["pt"][policy]
    with torch.no_grad():
        got = served.model.train()(torch.from_numpy(mel), train=True,
                                   mlm_draws=_mask_draws(keys[-1], 2))
    for name in ("mlm_pred", "frame_before_mask", "at_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL_MODEL, err_msg=name)
    wrong = cli.read_weights(path, served.model, {}, "unmerged" if policy == "merged" else
                             "merged")
    assert any(not torch.equal(wrong[k], src.state_dict()[k]) for k in wrong if "weight" in k)


# -- the four stages ------------------------------------------------------------------------


STAGES = ("pmam_extract", "pmam_gmm", "pmam_pseudo_labels", "pmam_train")


def _yaml_value(v):
    if isinstance(v, dict):
        return {k: _yaml_value(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_yaml_value(x) for x in v]
    return v


@pytest.fixture(scope="module")
def stage_setup(tmp_path_factory):
    """The layout of the JAX package's ``tests/test_cli_pmam.py:pmam_setup``
    with the post-pretrain PaSST_CNN: four 1.2-s unlabeled clips, the tiny
    model, the full covariance and the LoRA groups."""
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("pmam_cli")
    wavs = root / "unlabeled"
    wavs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        wav = (rng.randn(38400) * 0.05 * 32767).astype(np.int16)
        wavfile.write(str(wavs / f"u{i}.wav"), 32000, wav)
    config = {
        "generals": {"num_workers": 0},
        "model_name": "PaSST_CNN",
        "PaSST_CNN": {"init_kwargs": _yaml_value(POST), "train_kwargs": {"temp_w": 1}},
        "feature": {"pred_len": FRAMES, "sr": 32000, "hopsize": 320, "n_fft": 1024,
                    "audio_max_len": 1.2, "net_subsample": 1},
        "dataset": {"labels": ["a", "b"], "unlabeled_folder": str(wavs)},
        "training": {"batch_size": 2, "batch_size_val": 2, "clip_grad": True, "w_AT": 0.1,
                     "scheduler": {"n_epochs": 1, "n_epochs_cut": 1, "exponent": -1,
                                   "lr_warmup_epochs": 0, "lr_warmup_rate": 0.1}},
        "pmam": {"feature_layer": "transformer_0", "downsample_rate": 4, "n_components": K,
                 "covariance_type": "full", "n_iter": 5, "temperature": 0.1},
        "opt": {"lora_trainable": True, "param_groups": {
            "encoder": {"lr": 0, "weight_decay": 1.0e-4},
            "decoder": {"lr": 1.0e-3, "weight_decay": 1.0e-4},
            "head": {"lr": 1.0e-3, "weight_decay": 1.0e-4}}},
        "backbone_depth": 2,
    }
    path = root / "config.yaml"
    path.write_text(safe_dump(config))
    return {"root": root, "config": str(path)}


def test_four_stages_through_the_cli_on_the_cpu(stage_setup, monkeypatch):
    """The JAX stages' files and shapes; the stage's GMM is the port's fit on
    the stage's own features; the post-pretrained student holds its LoRA
    factors unmerged and moved."""
    import sys

    monkeypatch.setitem(sys.modules, "tensorflow", None)  # TensorBoard without TensorFlow
    run = stage_setup["root"] / "run"
    args = ["--config_dir", stage_setup["config"], "--save_folder", str(run), "--random_seed",
            "0", "--device", "cpu"]
    for stage in STAGES:
        assert cli.main([stage] + args) == 0, stage
    feats = np.load(run / "features.npy")
    assert feats.shape == (2 * -(-2 * FRAMES // 4), 32) and feats.dtype == np.float32
    refit = gmm.GaussianMixture(K, "full", n_iter=5, device="cpu").fit(feats)
    for name in ("means", "covariances", "weights"):
        np.testing.assert_array_equal(np.load(run / f"gmm_{name}.npy"), getattr(refit, name))
    assert np.load(run / "gmm_covariances.npy").shape == (K, 32, 32)
    tsvs = sorted(os.listdir(run / "pseudo_labels"))
    assert tsvs == [f"u{i}.tsv" for i in range(4)]
    table = np.loadtxt(run / "pseudo_labels" / "u0.tsv", delimiter="\t", skiprows=1)
    assert table.shape == (FRAMES, 2 + K)
    np.testing.assert_allclose(table[:, 2:].sum(1), 1.0, atol=2e-5)
    best = torch.load(run / "best" / "best_student", weights_only=True)
    start = init_weights_(PaSST_CNN(**POST, device="cpu"), seed=0).state_dict()
    assert all(not torch.equal(best[k], start[k]) for k in best if k.endswith("lora_B"))
    log = (run / "log.txt").read_text()
    assert "extracted (120, 32) features" in log and "fitted GMM: means (3, 32)" in log
    assert "wrote 4 pseudo-label TSVs" in log and "epoch 1: loss_strong=" in log


@pytest.mark.parametrize("stage", STAGES)
def test_each_pmam_stage_runs_on_the_card_unless_asked_for_the_cpu(stage, stage_setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the stage would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([stage, "--config_dir", stage_setup["config"], "--save_folder",
                  str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


# -- pseudo-labels ------------------------------------------------------------------------------


def test_frame_probs_to_tsv_is_byte_equal_to_jax(tmp_path):
    probs = np.random.RandomState(12).dirichlet(np.ones(5), 37).astype(np.float32)
    jax_pseudo.frame_probs_to_tsv(str(tmp_path / "jax.tsv"), probs)
    pseudo_labels.frame_probs_to_tsv(str(tmp_path / "port.tsv"), probs)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


def test_generate_pseudo_labels_writes_the_taps_posteriors(post, tmp_path):
    """Batch by batch: the tap, the GMM's posteriors, one TSV per clip named
    after its file."""
    port = post[0].eval()
    mels = [_mel(2, seed=13), _mel(1, seed=14)]
    names = [["a.wav", "b.wav"], ["c.wav"]]
    draws = [port.masker.draw(torch.Generator().manual_seed(i), len(n), FRAMES)
             for i, n in enumerate(names)]
    taps = [port.tap(torch.from_numpy(m), "transformer_0", mlm_draws=d)
            for m, d in zip(mels, draws)]
    flat = torch.cat([t.reshape(-1, 32) for t in taps]).numpy()
    g = gmm.GaussianMixture(K, "diag", n_iter=3, device="cpu").fit(flat)
    n = pseudo_labels.generate_pseudo_labels(
        port, g, zip([torch.from_numpy(m) for m in mels], names), str(tmp_path), mlm_draws=draws)
    assert n == 3 and sorted(os.listdir(tmp_path)) == ["a.tsv", "b.tsv", "c.tsv"]
    table = np.loadtxt(tmp_path / "c.tsv", delimiter="\t", skiprows=1)
    want = g.predict_proba(taps[1].reshape(-1, 32).numpy())
    assert table.shape == (FRAMES, 2 + K)
    np.testing.assert_allclose(table[:, 2:], want, atol=5e-7)
    np.testing.assert_allclose(table[:, 1] - table[:, 0], 0.01, atol=1e-9)
