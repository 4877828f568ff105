"""The port's MLM pretraining slice, held against the JAX package on the CPU.

The masker's apply step fed the draws the JAX masker makes from the same
key, patchout fed the JAX backbone's permutations, dropout and DropPath fed
flax's masks, ``mlm_loss``, the MLM forward of a tiny PaSST_SED, and a
3-step trajectory against ``make_mlm_step`` with the pretrain recipe's frozen
encoder group and an active clip. The JAX model is never initialised: the
port model is seeded and its state dict goes through the JAX package's
``convert_torch_checkpoint``. Everything compares in float32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.models import mlm as jax_mlm
from transformer4sed_tpu.models import vit as jax_vit
from transformer4sed_tpu.models.passt import PaSST as JaxPaSST
from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxSED
from transformer4sed_tpu.train import mlm as jax_train_mlm
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.models import vit
from transformer4sed_tpu_torch.models.mlm import MLMDraws, MLMMasker
from transformer4sed_tpu_torch.models.passt import PaSST, PatchoutDraws
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.train import mlm as train_mlm
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import (
    init_weights_,
    jax_params_to_state_dict,
    load_jax_params,
)
from tests.torch_port_jax import jit0

# the tiny config of tests/test_torch_port_train.py in MLM mode (the pretrain
# recipe's: no AT adapter, block masking of 75 % of the 10-frame segments)
TINY = dict(
    class_num=2, embed_dim=32, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
    decoder_num_heads=4, passt_feature_layer=2, decoder_layer_num=1,
    decoder_pos_emd_len=120, at_adapter=False, backbone_img_size=(128, 120), mlm=True,
    mlm_dict=dict(mask_rate=0.75, mask_style=(0.8, 0.1, 0.1), strategy="block", block_width=10,
                  out_dim=32),
)
FRAMES = 120
# elementwise f32 functions and small sums: a few ulps
ATOL_ELEM = 1e-6
# model outputs after a dozen f32 matmuls, summed in another order
ATOL_MODEL = 5e-5
# trajectory bounds of tests/test_torch_parity.py:2537 and tests/test_torch_port_train.py
ATOL_LOSS = RTOL_LOSS = 2e-5
# params after three AdamW steps at lr 2e-3: Adam normalises each gradient, so an
# f32 rounding difference in a small one moves its step by ~1e-3 of the lr
ATOL_PARAMS = 5e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _mask_draw_arrays(key, masker, b, t):
    """The draws ``MLMMasker.__call__`` of the JAX package makes from ``key``,
    as JAX arrays (noise, probs, rand_src)."""
    kmask, kprob, krand = jax.random.split(key, 3)
    n = t if masker.strategy == "random" else t // masker.block_width
    return (jax.random.uniform(kmask, (b, n)), jax.random.uniform(kprob, (b, t)),
            jax.random.randint(krand, (b, t), 0, b * t))


def _as_draws(noise, probs, rand_src) -> MLMDraws:
    return MLMDraws(noise=torch.from_numpy(np.array(noise)),
                    probs=torch.from_numpy(np.array(probs)),
                    rand_src=torch.from_numpy(np.array(rand_src)).long())


def _jax_mask_draws(key, masker, b, t) -> MLMDraws:
    """The draws ``MLMMasker.__call__`` of the JAX package makes from ``key``."""
    return _as_draws(*_mask_draw_arrays(key, masker, b, t))


# -- the masker ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy,t,style", [
    ("block", 120, (0.8, 0.1, 0.1)), ("block", 105, (0.5, 0.3, 0.2)),
    ("block", 17, (0.8, 0.1, 0.1)),
    ("random", 120, (0.8, 0.1, 0.1)), ("random", 50, (0.2, 0.6, 0.2)),
])
def test_masker_apply_matches_jax_on_its_draws(strategy, t, style):
    """Mask ids, the three styles (mask token, random frame of the flattened
    batch, kept) and the random-token gather, on the JAX masker's own draws."""
    b, c = 3, 5
    kw = dict(mask_rate=0.6, mask_style=style, strategy=strategy, block_width=10)
    jmasker, masker = jax_mlm.MLMMasker(**kw), MLMMasker(**kw)
    rng = np.random.RandomState(t)
    tokens = rng.randn(b, t, c).astype(np.float32)
    token = rng.randn(1, 1, c).astype(np.float32)
    key = jax.random.PRNGKey(t)
    # the masker and its draws from the same key, in one compiled program
    (want, want_ids), draws = jit0(lambda k, x, tok: (
        jmasker(k, x, tok), _mask_draw_arrays(k, masker, b, t)))(
            key, jnp.asarray(tokens), jnp.asarray(token))
    got, got_ids = masker.apply(torch.from_numpy(tokens), torch.from_numpy(token),
                                _as_draws(*draws))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = got_ids.numpy()
    as_token = (got.numpy() == token).all(-1) & ids
    kept = (got.numpy() == tokens).all(-1) & ids
    assert not (got.numpy()[~ids] != tokens[~ids]).any()  # unmasked frames stay
    if t >= 50:
        assert as_token.any() and kept.any() and (ids & ~as_token & ~kept).any()


def test_masker_draws_mask_the_exact_block_share_and_really_mask():
    masker = MLMMasker(mask_rate=0.75, strategy="block", block_width=10)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randn(4, 125, 6, generator=gen)
    draws = masker.draw(gen, 4, 125)
    assert draws.noise.shape == (4, 12) and draws.probs.shape == draws.rand_src.shape == (4, 125)
    out, ids = masker.apply(tokens, torch.zeros(1, 1, 6), draws)
    assert ids.sum(1).tolist() == [100] * 4  # (int(12 * 0.75) + 1) segments of 10
    assert not ids[:, 120:].any()  # the tail beyond the last whole segment is never masked
    assert (out != tokens).any(-1).sum() > 0.7 * ids.sum()  # masking really masks
    other = masker.draw(gen, 4, 125)
    assert not torch.equal(other.noise, draws.noise)
    random = MLMMasker(mask_rate=0.3, strategy="random")
    share = random.mask_ids(random.draw(gen, 8, 1000).noise, 1000).float().mean()
    assert abs(float(share) - 0.3) < 0.03
    with pytest.raises(ValueError, match="unknown mask strategy"):
        MLMMasker(strategy="span")


def test_mlm_loss_matches_jax():
    rng = np.random.RandomState(1)
    pred, target = (rng.randn(3, 20, 7).astype(np.float32) for _ in range(2))
    for mask in (rng.rand(3, 20) > 0.4, np.zeros((3, 20), bool)):
        want = jax_train_mlm.mlm_loss(jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(mask, jnp.float32))
        got = train_mlm.mlm_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                 torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL_ELEM)


# -- patchout, dropout, DropPath ----------------------------------------------------------


def test_patchout_matches_jax_on_its_permutations(monkeypatch):
    """Structured (time columns, frequency rows) and unstructured patchout of
    the backbone in training, fed the subsets the JAX backbone draws."""
    cfg = dict(embed_dim=32, depth=2, num_heads=4, img_size=(128, 120))
    patchout = dict(s_patchout_t=3, s_patchout_f=2, u_patchout=17)
    port = PaSST(tap_layer=2, **cfg, **patchout)
    shell = init_weights_(PaSST_SED(**dict(TINY, mlm=False), device="cpu"), seed=1)
    port.load_state_dict(shell.backbone.state_dict())
    params, _ = convert_torch_checkpoint(_np_state(shell), "PaSST_SED",
                                         init_kwargs=dict(TINY, mlm=False))
    traced = []
    real = jax.random.permutation

    def recording(key, n, *a, **kw):
        out = real(key, n, *a, **kw)
        traced.append(out)
        return out

    monkeypatch.setattr(jax.random, "permutation", recording)
    mel = (np.random.RandomState(2).randn(2, 1, 128, 120) * 0.5).astype(np.float32)
    jmodel = JaxPaSST(tap_layers=(2,), **cfg, **patchout)

    def apply(m):  # one compiled program; the draws come out beside the outputs
        out = jmodel.apply({"params": params["backbone"]}, m, train=True,
                           rngs={"patchout": jax.random.PRNGKey(3)})
        return out, list(traced)

    want, draws = jit0(apply)(jnp.asarray(mel))
    seen = [np.asarray(p) for p in draws]
    assert [len(p) for p in seen] == [11, 12, 10 * 8]  # t, f, then the f-major tokens
    keep = [torch.from_numpy(np.sort(p[:len(p) - drop]).astype(np.int64))
            for p, drop in zip(seen, (3, 2, 17))]
    with torch.no_grad():
        got = port(torch.from_numpy(mel), train=True,
                   patchout_draws=PatchoutDraws(0, keep[0], keep[1], keep[2]))
        own = port(torch.from_numpy(mel), train=True, generator=torch.Generator().manual_seed(0))
        plain = port(torch.from_numpy(mel))
    assert (got["f_dim"], got["t_dim"]) == (want["f_dim"], want["t_dim"]) == (10, 8)
    assert got["frame"].shape == (2, 2 + 10 * 8 - 17, 32) == own["frame"].shape
    assert plain["frame"].shape == (2, 2 + 12 * 11, 32)  # eval keeps every patch
    for name in ("layer2_out", "frame"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=ATOL_MODEL,
                                   err_msg=name)
    with pytest.raises(ValueError, match="Generator"):
        port(torch.from_numpy(mel), train=True)


@pytest.mark.parametrize("kind", ["dropout", "drop_path"])
def test_dropout_and_drop_path_apply_match_flax_on_its_masks(kind):
    """The apply step on the keep mask flax drew (read back from its output),
    and the draw step's shapes, scaling and eval identity."""
    rate = 0.3
    x = (np.random.RandomState(4).rand(6, 5, 8) + 0.5).astype(np.float32)  # no zeros
    module = fnn.Dropout(rate) if kind == "dropout" else jax_vit.DropPath(rate)
    want = np.asarray(jit0(lambda v: module.apply({}, v, deterministic=False,
                                                  rngs={"dropout": jax.random.PRNGKey(5)}))(
        jnp.asarray(x)))
    kept = want != 0
    if kind == "drop_path":
        kept = kept.all((1, 2), keepdims=True)
    mask = torch.from_numpy(kept.astype(np.float32) / (1.0 - rate))
    got = vit.apply_dropout(torch.from_numpy(x), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(x)
    ours = vit.dropout(t, rate, True, gen, per_sample=kind == "drop_path")
    scaled = (ours / t).round(decimals=4)
    assert all(v == 0.0 or abs(v - 1 / (1 - rate)) < 2e-4 for v in scaled.unique().tolist())
    if kind == "drop_path":
        assert all(len(row.unique()) == 1 for row in scaled.reshape(6, -1))
    assert vit.dropout(t, rate, False, None) is t and vit.dropout(t, 0.0, True, None) is t
    with pytest.raises(ValueError, match="Generator"):
        vit.dropout(t, rate, True, None)


def test_block_with_dropout_and_drop_path_draws_in_training_only():
    blk = init_weights_(vit.Block(32, 4, drop=0.2, drop_path=0.5), seed=6)
    x = torch.randn(8, 10, 32, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        base = blk(x)
        a = blk(x, True, torch.Generator().manual_seed(1))
        b = blk(x, True, torch.Generator().manual_seed(1))
        c = blk(x, True, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, base)
    # DropPath at 0.5: some samples lose both residual branches and come back unchanged
    assert any(torch.equal(a[i], x[i]) for i in range(8)) or any(
        torch.equal(c[i], x[i]) for i in range(8))


# -- the MLM model and step ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(seeded port model in MLM mode, its JAX params, the JAX model)."""
    port = init_weights_(PaSST_SED(**TINY, device="cpu"), seed=0)
    params, _ = convert_torch_checkpoint(_np_state(port), "PaSST_SED", init_kwargs=TINY)
    return port, params, JaxSED(**TINY)


@pytest.fixture()
def mask_keys(monkeypatch):
    """Keys the JAX masker is called with, in order (the model derives them
    from its 'mlm' rng stream inside flax)."""
    keys = []
    real = jax_mlm.MLMMasker.__call__

    def spy(self, key, token_seq, mask_token):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), key)
        return real(self, key, token_seq, mask_token)

    monkeypatch.setattr(jax_mlm.MLMMasker, "__call__", spy)
    return keys


def test_mlm_weights_round_trip_with_upstream_names(tiny):
    port, params, _ = tiny
    assert {"mask_token", "mlm_mlp.0.weight", "mlm_mlp.2.bias"} <= set(port.state_dict())
    assert {"mask_token", "mlm_fc1", "mlm_fc2"} <= set(params)
    reloaded = load_jax_params(PaSST_SED(**TINY, device="cpu"), params)
    for key, val in port.state_dict().items():
        assert torch.equal(val, reloaded.state_dict()[key]), key


def test_tiny_mlm_forward_matches_jax_on_its_draws(tiny, mask_keys):
    port, params, jmodel = tiny
    mel = (np.random.RandomState(8).randn(3, 128, FRAMES) * 0.5).astype(np.float32)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("patchout", "dropout", "mlm"))}
    want = jit0(lambda p, m: jmodel.apply({"params": p}, m, train=True, rngs=rngs))(
        params, jnp.asarray(mel))
    jax.effects_barrier()
    draws = _jax_mask_draws(jnp.asarray(mask_keys[-1]), port.masker, 3, FRAMES)
    with torch.no_grad():
        got = port(torch.from_numpy(mel), train=True, mlm_draws=draws)
    assert got.strong is None and got.weak is None and got.mlm_pred.shape == (3, FRAMES, 32)
    np.testing.assert_array_equal(got.mask_id_seq.numpy(), np.asarray(want.mask_id_seq))
    assert int(got.mask_id_seq.sum()) == 3 * 100
    for name in ("mlm_pred", "frame_before_mask"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL_MODEL, err_msg=name)
    with pytest.raises(ValueError, match="Generator"):
        port(torch.from_numpy(mel), train=True)


class _IdentityFrontend:
    """mel in, mel out: the train step without the STFT."""

    def __call__(self, wav, fminmax=None, key=None, training=False):
        return wav

    def draw_fminmax(self, gen):
        return None

    def normalize(self, mel):
        return mel


# config/mat-sed/pretrain.yaml opt.param_groups: the encoder frozen by lr 0
OPT_CFG = dict(
    encoder=dict(lr=0.0, weight_decay=1e-4, freeze_layer=0, step_lr=0),
    decoder=dict(lr=2e-3, weight_decay=1e-4),
    head=dict(lr=2e-3, weight_decay=1e-4),
)


def test_mlm_trajectory_matches_jax_with_a_frozen_encoder(tiny, mask_keys):
    """Three steps of ``MLMTrainer`` against ``make_mlm_step`` (shift and
    views off, identity frontend, the JAX masker's draws, the frozen encoder
    group, an active clip): each step's loss and gradient norm (which counts
    the frozen encoder's gradient, as the target is not detached), then the
    end parameters."""
    port, params, jmodel = tiny
    jopt = jax_optim.ParamGroupConfig(
        **{k: jax_optim.GroupSpec(**v) for k, v in OPT_CFG.items()}, backbone_depth=2,
        clip_grad=0.05)
    popt = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                  backbone_depth=2, clip_grad=0.05)
    off = dict(max_shift_frame=0, transform_choice=(0, 0, 0, 0))
    tx, _ = jax_optim.build_optimizer(params, jopt)

    def apply(p, m, train=False, rngs=None, **kw):
        return jmodel.apply({"params": p}, m, train=train, rngs=rngs, **kw)

    step_fn = jit0(jax_train_mlm.make_mlm_step(apply, _IdentityFrontend(), tx,
                                                  jax_train_mlm.MLMConfig(**off)))
    state = jax_train_mlm.create_mlm_state(params, tx)
    mel = (np.random.RandomState(9).randn(3, 128, FRAMES) * 0.5).astype(np.float32)
    model = PaSST_SED(**TINY, device="cpu")
    model.load_state_dict(port.state_dict())
    trainer = train_mlm.MLMTrainer(model, _IdentityFrontend(), train_mlm.MLMConfig(**off), popt)
    assert set(trainer.labels.values()) == {"frozen", "decoder", "head"}
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        state, jm = step_fn(state, {"wav": jnp.asarray(mel)}, jax.random.PRNGKey(i))
        jax.effects_barrier()
        draws = _jax_mask_draws(jnp.asarray(mask_keys[-1]), model.masker, 3, FRAMES)
        pm = trainer.step({"wav": mel}, gen, mlm_draws=draws)
        np.testing.assert_allclose(float(pm["loss_mlm"]), float(jm["loss_mlm"]), atol=ATOL_LOSS,
                                   rtol=RTOL_LOSS, err_msg=f"step {i}")
        assert float(pm["loss_mlm"]) > 0 and float(pm["masked_share"]) == pytest.approx(100 / 120)
        assert float(pm["grad_norm"]) > popt.clip_grad  # the clip is active
    assert trainer.step_count == int(state.step) == 3
    ours, start = model.state_dict(), port.state_dict()
    frozen = moved = 0
    for name, want in jax_params_to_state_dict(state.params).items():
        got = ours[name].numpy()
        keep = np.ones(got.shape, bool)
        if name.endswith("attn.in_proj.bias"):
            # the key third of the qkv bias adds a constant to every score of a
            # row: rounding noise for a gradient, which Adam turns into steps
            keep[got.shape[0] // 3:2 * got.shape[0] // 3] = False
        np.testing.assert_allclose(got[keep], want[keep], atol=ATOL_PARAMS, err_msg=name)
        if name.startswith("backbone."):
            assert torch.equal(ours[name], start[name]), name  # lr 0: no update, no decay
            frozen += 1
        else:
            moved += not torch.equal(ours[name], start[name])
    assert frozen > 20 and moved >= 12
    # the frozen encoder did get a gradient: the target branch is not detached
    assert model.backbone.blocks[0].attn.qkv.weight.grad.abs().max() > 0


def test_mlm_trainer_step_with_augmentation_runs_on_its_own_draws(tiny):
    """Frame shift, one filt_aug view and the model's own mask draws from one
    generator: finite loss, the same seed gives the same step."""
    port = tiny[0]
    mel = (np.random.RandomState(10).randn(2, 128, FRAMES) * 0.5).astype(np.float32)
    cfg = train_mlm.MLMConfig(max_shift_frame=9, filter_db_range=(-26, 26), filter_bands=(2, 5),
                              filter_minimum_bandwidth=4)
    losses = []
    for seed in (1, 1, 2):
        model = PaSST_SED(**TINY, device="cpu")
        model.load_state_dict(port.state_dict())
        trainer = train_mlm.MLMTrainer(model, _IdentityFrontend(), cfg)
        losses.append(float(trainer.step({"wav": mel}, torch.Generator().manual_seed(seed))
                            ["loss_mlm"]))
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
