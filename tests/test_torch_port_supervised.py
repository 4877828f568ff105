"""The port's supervised AudioSet-strong step, held against the JAX package
on the CPU.

The asymmetric loss and the loss factory, the optimizer's labels on
HTSAT_CNN (the flat Swin naming, the cnn group), the preprocess chain fed
the draws JAX makes from the same key, and a 3-step trajectory of the tiny
HTSAT_CNN of ``tests/test_torch_port_htsat.py`` against
``make_supervised_step``. Everything compares in float32.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_htsat import FRAMES, MEL_F, MEL_T, TINY, _mel, _np_state
from tests.test_torch_port_train import _IdentityFrontend, _jax_filt_draw
from transformer4sed_tpu.core import losses as jax_losses
from transformer4sed_tpu.models.htsat_heads import HTSAT_CNN as JaxHTSATCNN
from transformer4sed_tpu.recipes import audioset_strong as jax_recipe
from transformer4sed_tpu.recipes.common import make_model_apply
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.train.mlm import MLMState
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.core import losses
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models.htsat_heads import HTSAT_CNN
from transformer4sed_tpu_torch.recipes import audioset_strong as recipe
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import init_weights_, jax_params_to_state_dict
from tests.torch_port_jax import OPT0, jit0

# elementwise f32 functions and small sums: a few ulps
ATOL_ELEM = 1e-6
# trajectory bound of tests/test_torch_port_train.py (test_torch_parity.py:2392-2412)
ATOL_LOSS = RTOL_LOSS = 2e-5
# params after three AdamW steps at lr 1e-4 .. 4e-4 (up to 1.2e-3 of movement)
# from gradients that agree to f32 rounding: Adam's g / sqrt(v) magnifies that
# rounding for the smallest gradients (a few entries of linear_pos reach 1.4e-5)
ATOL_PARAMS = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    """(seeded port model, its JAX variables, the JAX model)."""
    port = init_weights_(HTSAT_CNN(**TINY, device="cpu"), seed=0)
    params, model_state = convert_torch_checkpoint(_np_state(port), "HTSAT_CNN")
    return port, {"params": params, **model_state}, JaxHTSATCNN(**TINY)


@pytest.mark.parametrize("name,kwargs", [
    ("AslLoss", dict(rp=0, rn=4, margin=0.05)), ("AslLoss", dict(rp=1, rn=2, margin=0.0)),
    ("BCELoss", None),
])
def test_loss_factory_matches_jax_with_finite_gradients(name, kwargs):
    pred = np.array([[1e-7, 1.0, 0.03, 0.3], [0.999, 0.05, 0.5, 1.0 - 1e-7]], np.float32)
    target = np.array([[0.0, 1.0, 0.5, 1.0], [1.0, 0.0, 0.2, 0.7]], np.float32)
    want, jgrad = jit0(jax.value_and_grad(jax_losses.loss_function_factory(name, kwargs)))(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.loss_function_factory(name, kwargs)(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=ATOL_ELEM)
    assert torch.isfinite(p.grad).all()
    with pytest.raises(KeyError, match="unknown loss"):
        losses.loss_function_factory("FocalLoss")


def test_bce_logits_matches_jax():
    rng = np.random.RandomState(10)
    x, t = (rng.randn(4, 6) * 5).astype(np.float32), rng.rand(4, 6).astype(np.float32)
    np.testing.assert_allclose(losses.bce_logits(torch.from_numpy(x), torch.from_numpy(t)).item(),
                               float(jax_losses.bce_logits(jnp.asarray(x), jnp.asarray(t))),
                               rtol=1e-6)


def _opt_cfgs(cnn=True, freeze=0, clip=20.0):
    spec = dict(encoder=dict(lr=1e-4, weight_decay=1e-4, step_lr=1, freeze_layer=freeze),
                decoder=dict(lr=2e-4, weight_decay=1e-4), head=dict(lr=4e-4, weight_decay=0.0))
    if cnn:
        spec["cnn"] = dict(lr=3e-4, weight_decay=1e-3)
    return (jax_optim.ParamGroupConfig(**{k: jax_optim.GroupSpec(**v) for k, v in spec.items()},
                                       clip_grad=clip),
            optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in spec.items()},
                                   clip_grad=clip))


@pytest.mark.parametrize("cnn,freeze", [(True, 0), (False, 0), (True, 2)])
def test_label_params_match_jax_on_htsat_cnn(tiny, cnn, freeze):
    """Labels on torch names equal JAX's on its param paths (the flat
    ``layers_{i}_blocks_{j}`` Swin naming, the cnn group, freeze_layer and
    step_lr counted over the whole backbone): each JAX leaf is filled with
    its label's code and carried to torch names by the weight bridge."""
    port, variables, _ = tiny
    jcfg, pcfg = _opt_cfgs(cnn, freeze)
    jlabels = jax_optim.label_params(variables["params"], jcfg)
    codes = {name: i for i, name in enumerate(sorted(set(jax.tree_util.tree_leaves(jlabels))))}
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   jlabels, variables["params"])
    named = dict(port.named_parameters())
    ours = optim.label_params(named, pcfg)
    # frozen below block 2 of 3: what is left of the backbone is the top block at 2x
    expect = {"encoder_high", "decoder", "head", "frozen" if freeze else "encoder_low"}
    assert expect | ({"cnn"} if cnn else set()) == set(ours.values())
    assert ours["backbone.layers.1.blocks.0.mlp.fc1.weight"] == "encoder_high"
    assert ours["backbone.layers.0.blocks.1.norm1.weight"] == ("frozen" if freeze else
                                                               "encoder_low")
    for name, arr in jax_params_to_state_dict(coded, names=named.keys()).items():
        assert np.all(arr == codes[ours[name]]), name


def _jax_draws(cfg, b, n_freq, t):
    """The draws ``make_supervised_preprocess`` makes from a step key, as a
    port SupervisedDraw (one jitted function of the key)."""

    @jit0
    def raw(key):
        kpre, _ = jax.random.split(key)
        _, kshift, kmix, kmixp, ktrans = jax.random.split(kpre, 5)
        k0 = jax.random.split(jax.random.fold_in(ktrans, 0), 5)[0]
        return ((jax.random.normal(kshift, (b,)) * min(cfg.max_shift_frame, t // 2)).astype(
                    jnp.int32),
                jax.random.beta(jax.random.fold_in(kmix, 0), cfg.mixup_alpha, cfg.mixup_beta),
                jax.random.uniform(kmixp) < cfg.mixup_prob,
                jax.random.permutation(jax.random.fold_in(kmix, 1), b), k0)

    def draw(key):
        shifts, c, do_mix, perm, k0 = raw(key)
        filt = _jax_filt_draw(k0, b, n_freq, *cfg.filter_bands, cfg.filter_minimum_bandwidth,
                              cfg.filter_type, cfg.filter_db_range)
        return recipe.SupervisedDraw(
            None, torch.from_numpy(np.asarray(shifts).astype(np.int64)), bool(do_mix),
            torch.from_numpy(np.asarray(perm).astype(np.int64)), float(c),
            [augment.ViewDraw(filt=filt)])

    return draw


def test_supervised_preprocess_matches_jax_with_its_draws():
    """Frame shift with labels on a finer grid (net_pooling 100 / 64), the
    whole-batch mixup, one filt_aug view and the [B,1,T,F] <-> [B,F,T]
    adaptor, fed the draws JAX makes from the same key."""
    kw = dict(mixup_prob=1.0, filter_db_range=(-3.0, 3.0), filter_bands=(2, 4),
              filter_minimum_bandwidth=3)
    jcfg, pcfg = jax_recipe.SupervisedConfig(**kw), recipe.SupervisedConfig(**kw)
    rng = np.random.RandomState(11)
    batch = {"wav": _mel(4, seed=11), "labels": (rng.rand(4, 5, FRAMES) > 0.7).astype(np.float32)}
    jpre = jit0(jax_recipe.make_supervised_preprocess(_IdentityFrontend(), jcfg))
    ppre = recipe.make_supervised_preprocess(_IdentityFrontend(), pcfg, "cpu")
    draws = _jax_draws(pcfg, 4, MEL_F, MEL_T)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        kpre, _ = jax.random.split(key)
        want_mel, want_lab = jpre({k: jnp.asarray(v) for k, v in batch.items()}, kpre)
        draw = draws(key)
        assert draw.do_mix and (draw.shifts != 0).any()
        got_mel, got_lab = ppre(batch, None, draw)
        assert got_mel.shape == (4, 1, MEL_T, MEL_F)
        np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel), atol=1e-5)
        np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), atol=ATOL_ELEM)
    gen = torch.Generator().manual_seed(0)
    a, _ = ppre(batch, gen)
    b, _ = ppre(batch, gen)
    assert not torch.equal(a, b)  # the generator's own draws differ from call to call


def _has_a_gradient(name, shape):
    """Mask of the entries whose gradient is not zero in exact arithmetic.
    A conv bias ahead of BatchNorm and the key third of an attention's qkv
    bias (a constant added to every score of a row) get rounding noise for
    a gradient, Adam turns its sign into a full-size step, and the two
    packages' noise differs; the running mean absorbs that conv bias."""
    keep = np.ones(shape, bool)
    leaf = name.rsplit(".", 2)
    if name.startswith("cnn.cnn.") and (
            (leaf[-2].startswith("conv") and leaf[-1] == "bias") or leaf[-1] == "running_mean"):
        keep[:] = False
    elif name.endswith(("attn.qkv.bias", "attn.in_proj.bias")):
        keep[shape[0] // 3:2 * shape[0] // 3] = False
    return keep


def _trajectory_setup(tiny):
    """The JAX side of the trajectory test (AslLoss, shift + mixup + filt_aug
    from JAX's draws, dropout off, a cnn group and an active step-LR): the
    compiled step, its first state, the port's configs and the batch."""
    _, variables, jmodel = tiny
    kw = dict(loss_name="AslLoss", loss_kwargs=dict(rp=0, rn=4, margin=0.05),
              model_kwargs=dict(temp_w=1.0))
    jcfg, pcfg = jax_recipe.SupervisedConfig(**kw), recipe.SupervisedConfig(**kw)
    jopt, popt = _opt_cfgs(cnn=True, clip=0.5)
    tx, _ = jax_optim.build_optimizer(variables["params"], jopt)
    step_fn = jax.jit(jax_recipe.make_supervised_step(
        make_model_apply(jmodel, True), _IdentityFrontend(), tx, jcfg))
    state = MLMState(params=variables["params"], opt_state=jit0(tx.init)(variables["params"]),
                     step=jnp.zeros((), jnp.int32),
                     model_state={"batch_stats": variables["batch_stats"]})
    rng = np.random.RandomState(12)
    batch = {"wav": _mel(4, seed=12), "labels": (rng.rand(4, 5, FRAMES) > 0.7).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = step_fn.lower(state, jbatch, jax.random.PRNGKey(0)).compile(OPT0)
    return compiled, state, pcfg, popt, batch, jbatch


# XLA's lowest backend optimization level: the steps compile in about half
# the time on the CPU, and the trajectory bounds hold


@pytest.fixture(scope="module", autouse=True)
def trajectory_setup(tiny):
    """:func:`_trajectory_setup` in a worker thread from the module's start:
    XLA compiles the step without holding the GIL, alongside the other tests."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_trajectory_setup, tiny)
    yield future
    pool.shutdown(wait=True)


def test_supervised_trajectory_matches_jax(tiny, trajectory_setup):
    """Three steps of ``SupervisedStep`` against ``make_supervised_step``
    (AslLoss, shift + mixup + filt_aug from JAX's draws, dropout off, same
    weights and optimizer policy with a cnn group and an active step-LR):
    each step's loss, then the end parameters and running statistics."""
    port = tiny[0]
    step_fn, state, pcfg, popt, batch, jbatch = trajectory_setup.result()
    model = HTSAT_CNN(**TINY, device="cpu")
    model.load_state_dict(port.state_dict())
    stepper = recipe.SupervisedStep(model, _IdentityFrontend(), pcfg, popt)
    draws = _jax_draws(pcfg, 4, MEL_F, MEL_T)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        state, jm = step_fn(state, jbatch, key)
        pm = stepper.step(batch, None, draws(key))
        np.testing.assert_allclose(float(pm["loss_class_strong"]), float(jm["loss_class_strong"]),
                                   atol=ATOL_LOSS, rtol=RTOL_LOSS, err_msg=f"step {i}")
        assert float(pm["grad_norm"]) > popt.clip_grad  # the clip is active
    assert stepper.step_count == int(state.step) == 3
    end = jax_params_to_state_dict({"params": state.params, **state.model_state},
                                   names=model.state_dict().keys())
    ours, start = model.state_dict(), port.state_dict()
    compared = 0
    for name, want in end.items():
        got = ours[name].numpy()
        keep = _has_a_gradient(name, got.shape)
        compared += int(keep.sum())
        np.testing.assert_allclose(got[keep], want[keep], atol=ATOL_PARAMS, err_msg=name)
    assert compared > 0.97 * sum(v.size for v in end.values())
    # every param and running statistic moved, but the tscam head, which
    # HTSAT_CNN does not read: no gradient, and a weight decay below f32's step
    still = {n for n in end if torch.equal(ours[n], start[n])}
    assert still <= {"backbone.tscam_conv.weight", "backbone.tscam_conv.bias"}
