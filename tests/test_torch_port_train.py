"""The port's training slice, held against the JAX package on the CPU.

Losses, ramps, schedules, EMA, the frontend's fmin/fmax draw, the
augmentations (the port's apply steps fed the draws the JAX functions
make from the same key), the optimizer's param groups, clipping and
AdamW, and a 4-step mean-teacher trajectory of the tiny PaSST_SED against
``make_mean_teacher_step``. The JAX model is never initialised: the port
model is seeded and its state dict goes through the JAX package's
``convert_torch_checkpoint``. Everything compares in float32.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer4sed_tpu.core import ema as jax_ema
from transformer4sed_tpu.core import losses as jax_losses
from transformer4sed_tpu.core import ramps as jax_ramps
from transformer4sed_tpu.core import schedules as jax_schedules
from transformer4sed_tpu.frontend import augment as jax_aug
from transformer4sed_tpu.frontend.mel import PasstFrontend as JaxFrontend
from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxSED
from transformer4sed_tpu.train import mean_teacher as jax_mt
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.core import ema, losses, ramps, schedules
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.train import mean_teacher as mt
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import init_weights_, jax_params_to_state_dict
from tests.torch_port_jax import OPT0, filt_draws_program, jit0

# the tiny config of tests/test_torch_port_slice.py, with the backbone's
# nominal time grid equal to the 120-frame input's, so that train=True
# draws no time-embedding offset on either side
TINY = dict(
    class_num=2, embed_dim=32, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
    decoder_num_heads=4, passt_feature_layer=2, decoder_layer_num=1,
    decoder_pos_emd_len=120, at_adapter=True, at_adapter_heads=4, backbone_img_size=(128, 120),
)
# elementwise f32 functions summed in another order: a few ulps
ATOL_ELEM = 1e-6
# normalised log-mel (tests/test_torch_port_slice.py): pocketfft vs a DFT matmul
ATOL_MEL = 1e-4
# trajectory bounds of tests/test_torch_parity.py:2392-2412
ATOL_LOSS = RTOL_LOSS = 2e-5
ATOL_FORWARD = 2e-4
# params after two AdamW steps: lr-sized updates of f32 params
ATOL_PARAMS = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.array(x, dtype=np.float32)


# -- losses, ramps, schedules, EMA -------------------------------------------------


def test_bce_and_mse_match_jax_with_finite_gradients_at_saturation():
    pred = np.array([[0.0, 1.0, 1e-40, 0.3], [0.999, 1e-38, 0.5, 1.0 - 1e-8]], np.float32)
    target = np.array([[0.0, 1.0, 0.5, 1.0], [1.0, 0.0, 0.2, 0.7]], np.float32)
    for name in ("bce", "mse"):
        jf = getattr(jax_losses, name)
        want, jgrad = jit0(jax.value_and_grad(jf))(jnp.asarray(pred), jnp.asarray(target))
        p = torch.from_numpy(pred).requires_grad_()
        got = getattr(losses, name)(p, torch.from_numpy(target))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=ATOL_ELEM,
                                   err_msg=name)
        assert torch.isfinite(p.grad).all()


def test_ramps_and_schedules_match_jax():
    steps = [0, 1, 3, 7, 10, 25, 60, 99, 150]
    pairs = [
        (ramps.sigmoid_rampup, jax_ramps.sigmoid_rampup, (40,)),
        (ramps.linear_rampup, jax_ramps.linear_rampup, (40,)),
        (ramps.cosine_rampdown, jax_ramps.cosine_rampdown, (200,)),
        (ramps.sigmoid_rampdown, jax_ramps.sigmoid_rampdown, (40,)),
        (schedules.exponential_warmup(30), jax_schedules.exponential_warmup(30), ()),
        (schedules.exponential_down(50, 120, warmup_iter=8), jax_schedules.exponential_down(
            50, 120, warmup_iter=8), ()),
        (schedules.cosine_down(20, 100), jax_schedules.cosine_down(20, 100), ()),
    ]
    for ours, ref, args in pairs:
        got = [ours(s, *args) for s in steps]
        # every step in one compiled call of the JAX function
        want = jit0(jax.vmap(lambda s, ref=ref, args=args: ref(s, *args)))(
            jnp.asarray(steps, jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=repr(ours))


def test_ema_consistency_weight_and_pooled_labels_match_jax():
    rng = np.random.RandomState(0)
    stu = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    tch = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    jax_ema_update = jit0(lambda s, t, step: jax_ema.ema_update(s, t, step, 0.999))
    for step in (1, 2, 7, 5000):
        want = jax_ema_update(stu, tch, np.float32(step))
        got = [torch.from_numpy(t.copy()) for t in tch]
        ema.ema_update([torch.from_numpy(s) for s in stu], got, step, 0.999)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_ELEM)
    for sched in ("Sigmoid", "Linear"):
        cfg = jax_mt.MeanTeacherConfig(self_loss_warmup_steps=10, cons_scheduler=sched,
                                       w_cons_min=0.5)
        pcfg = mt.MeanTeacherConfig(self_loss_warmup_steps=10, cons_scheduler=sched,
                                    w_cons_min=0.5)
        steps = (0, 1, 5, 9, 10, 30)
        want = jit0(jax.vmap(lambda s, cfg=cfg: jax_mt.consistency_weight(s, cfg)))(
            jnp.asarray(steps, jnp.float32))
        for step, w in zip(steps, np.asarray(want)):
            np.testing.assert_allclose(mt.consistency_weight(step, pcfg), float(w), rtol=1e-6)
    labels = (rng.rand(3, 2, 12) > 0.6).astype(np.float32)
    np.testing.assert_allclose(mt.pool_strong_labels(torch.from_numpy(labels)).numpy(),
                               np.asarray(jit0(jax_mt.pool_strong_labels)(jnp.asarray(labels))),
                               atol=ATOL_ELEM)


# -- frontend and augmentation ---------------------------------------------------------


def test_mel_training_path_matches_jax_draw():
    """The fmin/fmax pair JAX draws from a key, fed to the port's frontend."""
    rng = np.random.RandomState(1)
    wav = (0.1 * rng.randn(2, 9600)).astype(np.float32)
    jfe = JaxFrontend()

    @jit0
    def ref(w, key):
        kmin, kmax = jax.random.split(key)
        draws = (jax.random.randint(kmin, (), 0, jfe.fmin_aug_range),
                 jax.random.randint(kmax, (), 0, jfe.fmax_aug_range))
        return jfe.normalize(jfe(w, key=key, training=True)), draws

    want, (lo, hi) = ref(jnp.asarray(wav), jax.random.PRNGKey(3))
    fmin = float(lo)
    fmax = float(jfe.effective_fmax + jfe.fmax_aug_range // 2 - int(hi))
    fe = PasstFrontend(device="cpu")
    got = fe.normalize(fe(torch.from_numpy(wav), (fmin, fmax)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MEL)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        lo, hi = fe.draw_fminmax(gen)
        assert 0 <= lo < fe.fmin_aug_range
        assert fe.effective_fmax - 1000 < hi <= fe.effective_fmax + 1000


@pytest.mark.parametrize("net_pooling", [1, 2])
def test_frame_shift_matches_jax(net_pooling):
    rng = np.random.RandomState(2)
    b, t = 5, 40
    mel = rng.randn(b, 6, t).astype(np.float32)
    lab = rng.rand(b, 3, t // net_pooling).astype(np.float32)
    @jit0
    def ref(m, lb, key):
        return (jax_aug.frame_shift(key, m, lb, net_pooling=net_pooling, max_shift_frame=9),
                (jax.random.normal(key, (b,)) * 9).astype(jnp.int32))

    (wm, wl), shifts = ref(jnp.asarray(mel), jnp.asarray(lab), jax.random.PRNGKey(net_pooling))
    shifts = np.asarray(shifts)
    assert (shifts < 0).any() and (net_pooling == 1 or (shifts % net_pooling != 0).any())
    gm, gl = augment.frame_shift(torch.from_numpy(mel), torch.from_numpy(shifts.astype(np.int64)),
                                 torch.from_numpy(lab), net_pooling=net_pooling)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_mixup_matches_jax():
    rng = np.random.RandomState(3)
    mel, lab = rng.randn(6, 4, 10).astype(np.float32), rng.rand(6, 2, 10).astype(np.float32)
    kinds = ("soft", "hard")

    @jit0
    def ref(m, lb, key):
        kperm, kc = jax.random.split(key)
        return ([jax_aug.mixup(key, m, lb, 0.2, 0.2, kind) for kind in kinds],
                jax.random.permutation(kperm, 6), jax.random.beta(kc, 0.2, 0.2))

    wants, perm, c = ref(jnp.asarray(mel), jnp.asarray(lab), jax.random.PRNGKey(4))
    perm, c = torch.from_numpy(np.asarray(perm).astype(np.int64)), float(c)
    for kind, (wm, wl) in zip(kinds, wants):
        gm, gl = augment.mixup(torch.from_numpy(mel), perm, c, torch.from_numpy(lab), kind)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=ATOL_ELEM)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL_ELEM)


def test_beta_draws_follow_the_distribution():
    gen = torch.Generator().manual_seed(5)
    draws = np.array([augment.draw_beta(gen, 10.0, 0.5) for _ in range(2000)])
    assert ((draws > 0) & (draws < 1)).all()
    # Beta(10, 0.5): mean 10 / 10.5; the mean of 2000 draws is within 5 sigma
    assert abs(draws.mean() - 10 / 10.5) < 5 * np.sqrt(10 * 0.5 / (10.5 ** 2 * 11.5) / 2000)


def _jax_filt_draw(key, b, n_freq, lo=3, hi=6, min_bw=6, filter_type="step",
                   db_range=(-0.5, 0.5)):
    """The draws jax filt_aug makes from ``key``, as a FiltAugDraw: the
    band count, the boundary draw for that count (made, as JAX makes it,
    for every possible count from the same key) and the gains."""
    nb, raws, fdb = _filt_draws(key, b, n_freq, lo, hi, min_bw, filter_type == "linear")
    nb = int(nb)
    fdb = np.array(fdb) * (db_range[1] - db_range[0]) + db_range[0]
    return augment.FiltAugDraw(nb, torch.from_numpy(np.array(raws[nb - lo]).astype(np.int64)),
                               torch.from_numpy(fdb.astype(np.float32)))


def _filt_draws(key, b, n_freq, lo, hi, min_bw, linear):
    return filt_draws_program(b, n_freq, lo, hi, min_bw, linear)(key)


@pytest.mark.parametrize("filter_type", ["step", "linear"])
def test_filt_aug_matches_jax(filter_type):
    mel = np.random.RandomState(6).randn(3, 40, 8).astype(np.float32)
    ref = jit0(lambda m, k: jax_aug.filt_aug(k, m, min_bw=6, filter_type=filter_type))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = ref(jnp.asarray(mel), key)
        draw = _jax_filt_draw(key, 3, 40, filter_type=filter_type)
        got = augment.filt_aug(torch.from_numpy(mel), draw, min_bw=6, filter_type=filter_type)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_ELEM)


def test_feature_transformation_matches_jax():
    """One view with every transform on (freq_nonlinear, filt_aug,
    freq_mask, add_noise), in the reference's order, from the view key JAX
    folds in: each apply step fed JAX's draws."""
    mel = np.random.RandomState(9).randn(2, 32, 10).astype(np.float32)
    key = jax.random.PRNGKey(10)
    kw = dict(filter_db_range=(-0.5, 0.5), filter_bands=(3, 6), filter_minimum_bandwidth=6,
              filter_type="step", freq_mask_ratio=6, noise_snrs=(15, 30))

    @jit0
    def ref(m, key):
        k0, k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(key, 0), 5)
        kmw, kms = jax.random.split(k1)
        widths = jax.random.uniform(kmw, (2,)) * 6
        ksnr, kn = jax.random.split(k2)
        draws = (k0, jax.random.uniform(k3, ()), 0.03 * jax.random.uniform(k4, ()), widths,
                 jax.random.uniform(kms, (2,)) * (32 - widths),
                 (15 - 30) * jax.random.uniform(ksnr, (2, 1, 1)) + 30,
                 jax.random.normal(kn, m.shape))
        return jax_aug.feature_transformation(key, m, 1, (1, 1, 1, 1), norm_std=5.0, **kw), draws

    want, (k0, phase, bias, widths, starts, snr_db, noise) = ref(jnp.asarray(mel), key)
    view = augment.ViewDraw(
        warp=(float(phase), float(bias)), filt=_jax_filt_draw(k0, 2, 32),
        mask=(torch.from_numpy(_np(widths)), torch.from_numpy(_np(starts))),
        noise=(torch.from_numpy(_np(snr_db)), torch.from_numpy(_np(noise))))
    got = augment.feature_transformation(torch.from_numpy(mel), [view])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    drawn = augment.draw_feature_transformation(gen, mel.shape, 2, (1, 1, 1, 1), **kw)
    views = augment.feature_transformation(torch.from_numpy(mel), drawn)
    assert len(views) == 2 and not torch.equal(views[0], views[1])


# -- model, optimizer and the train step --------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(seeded port model, its JAX params, the JAX model)."""
    port = init_weights_(PaSST_SED(**TINY, device="cpu"), seed=0)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, _ = convert_torch_checkpoint(sd, "PaSST_SED", init_kwargs=TINY)
    return port, params, JaxSED(**TINY)


OPT_CFG = dict(
    encoder=dict(lr=5e-4, weight_decay=1e-4, step_lr=1, freeze_layer=1),
    decoder=dict(lr=0.0, weight_decay=1e-2),
    head=dict(lr=2e-3, weight_decay=0.0),
)


def _opt_cfgs(clip, frozen=True, **overrides):
    spec = {k: dict(v) for k, v in OPT_CFG.items()}
    if not frozen:
        spec["encoder"]["freeze_layer"] = 0
        spec["decoder"]["lr"] = 1e-3
    spec.update(overrides)
    jcfg = jax_optim.ParamGroupConfig(**{k: jax_optim.GroupSpec(**v) for k, v in spec.items()},
                                      backbone_depth=2, clip_grad=clip)
    pcfg = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in spec.items()},
                                  backbone_depth=2, clip_grad=clip)
    return jcfg, pcfg


def _as_torch_names(tree):
    return {k: np.asarray(v) for k, v in jax_params_to_state_dict(tree).items()}


def test_label_params_match_jax(tiny):
    """The port's labels on torch names equal JAX's on its param paths: each
    JAX leaf is filled with its label's code and carried to torch names by
    the weight bridge (which merges and transposes as for the weights)."""
    port, params, _ = tiny
    jcfg, pcfg = _opt_cfgs(20.0)
    jlabels = jax_optim.label_params(params, jcfg)
    codes = {name: i for i, name in enumerate(sorted(set(jax.tree_util.tree_leaves(jlabels))))}
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   jlabels, params)
    ours = optim.label_params(dict(port.named_parameters()), pcfg)
    assert {"frozen", "encoder_high", "head"} <= set(ours.values())
    for name, arr in _as_torch_names(coded).items():
        assert np.all(arr == codes[ours[name]]), name


def test_build_optimizer_matches_jax_two_steps(tiny):
    """Two optimizer steps on the same gradients with a frozen group, step-LR
    and an active clip, against JAX's build_optimizer (optax)."""
    port, params, _ = tiny
    jcfg, pcfg = _opt_cfgs(clip=0.5)
    jsched, psched = jax_schedules.exponential_warmup(3), schedules.exponential_warmup(3)
    tx, _ = jax_optim.build_optimizer(params, jcfg, schedule=jsched)
    model = PaSST_SED(**TINY, device="cpu")
    model.load_state_dict(port.state_dict())
    opt, sched, _ = optim.build_optimizer(model, pcfg, schedule=psched)
    state = jit0(tx.init)(params)
    update = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *tx.update(g, st, p)))
    jparams = params
    named = dict(model.named_parameters())
    for step in range(2):
        rng = np.random.RandomState(20 + step)
        grads = jax.tree_util.tree_map(lambda p: rng.randn(*np.shape(p)).astype(np.float32),
                                       params)
        jparams, state = update(grads, state, jparams)
        # copies: on the CPU the dispatched update may still read these numpy
        # buffers (zero-copy, asynchronous), and the clip below scales the
        # port's gradients in place
        for name, g in _as_torch_names(grads).items():
            named[name].grad = torch.tensor(g)
        norm = optim.clip_by_global_norm(optim.live_params(opt), pcfg.clip_grad)
        assert float(norm) > pcfg.clip_grad  # the clip is active
        opt.step()
        sched.step()
    moved = 0
    for name, want in _as_torch_names(jparams).items():
        got = named[name].detach().numpy()
        np.testing.assert_allclose(got, want, atol=ATOL_PARAMS, err_msg=name)
        moved += not np.array_equal(got, port.state_dict()[name].numpy())
    assert 0 < moved < len(named)  # frozen params kept, live ones moved


class _IdentityFrontend:
    """mel in, mel out: the train step without the STFT (as
    tests/test_torch_parity.py:2365-2383 does on the JAX side)."""

    def __call__(self, wav, fminmax=None, key=None, training=False):
        return wav

    def draw_fminmax(self, gen):
        return None

    def normalize(self, mel):
        return mel


def _mt_cfgs(**kw):
    common = dict(strong_num=2, weak_num=1, unlabel_num=1, self_loss_warmup_steps=3,
                  w_cons_max=2.0, mixup_prob=0.0, max_shift_frame=0, n_transform=0,
                  stu_kwargs=dict(temp_w=0.5), tch_kwargs=dict(temp_w=0.5), **kw)
    return jax_mt.MeanTeacherConfig(**common), mt.MeanTeacherConfig(**common)


def _trajectory_setup(tiny):
    """The JAX side of the trajectory test (augmentation off, identity
    frontend): the compiled step and eval forward, the first state, the
    port's configs and the batch."""
    _, params, jmodel = tiny
    jcfg, pcfg = _mt_cfgs()
    jopt, popt = _opt_cfgs(clip=20.0, frozen=False)
    tx, _ = jax_optim.build_optimizer(params, jopt)
    rng = np.random.RandomState(11)
    mel = (rng.randn(4, 128, 120) * 0.5).astype(np.float32)
    labels = (rng.rand(4, 2, 120) > 0.7).astype(np.float32)

    def apply(p, m, train=False, rngs=None, **kw):
        return jmodel.apply({"params": p}, m, train=train, rngs=rngs, **kw)

    step_fn = jax.jit(jax_mt.make_mean_teacher_step(apply, _IdentityFrontend(), tx, jcfg))
    state = jit0(lambda p: jax_mt.create_mean_teacher_state(p, tx))(params)
    batch = {"wav": jnp.asarray(mel), "labels": jnp.asarray(labels)}
    compiled = step_fn.lower(state, batch, jax.random.PRNGKey(0)).compile(OPT0)
    fwd = jax.jit(lambda p, m: jmodel.apply({"params": p}, m, temp_w=0.5))
    fwd = fwd.lower(state.params, batch["wav"]).compile(OPT0)
    return compiled, fwd, state, pcfg, popt, mel, labels, batch


# XLA's lowest backend optimization level: the steps compile in about half
# the time on the CPU, and the trajectory bounds hold


@pytest.fixture(scope="module", autouse=True)
def trajectory_setup(tiny):
    """:func:`_trajectory_setup` in a worker thread from the module's start:
    XLA compiles without holding the GIL, alongside the other tests."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_trajectory_setup, tiny)
    yield future
    pool.shutdown(wait=True)


def test_mean_teacher_trajectory_matches_jax(tiny, trajectory_setup):
    """Four steps of the port's trainer against ``make_mean_teacher_step``
    (augmentation off, identity frontend, same weights, same optimizer
    policy): every step's losses, then the final student and teacher
    forwards."""
    port = tiny[0]
    step_fn, fwd, state, pcfg, popt, mel, labels, batch = trajectory_setup.result()
    model = PaSST_SED(**TINY, device="cpu")
    model.load_state_dict(port.state_dict())
    trainer = mt.MeanTeacherTrainer(model, _IdentityFrontend(), pcfg, popt)
    gen = torch.Generator().manual_seed(0)
    names = ("loss_total", "loss_class_strong", "loss_class_weak", "loss_class_at_specific",
             "loss_cons_strong", "loss_cons_weak", "loss_cons_at_specific")
    for i in range(4):
        state, jm = step_fn(state, batch, jax.random.PRNGKey(i))
        pm = trainer.step({"wav": mel, "labels": labels}, gen)
        np.testing.assert_allclose([float(pm[k]) for k in names], [float(jm[k]) for k in names],
                                   atol=ATOL_LOSS, rtol=RTOL_LOSS, err_msg=f"step {i}")
        np.testing.assert_allclose(pm["w_cons"], float(jm["w_cons"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for ours, jparams in ((trainer.student, state.params), (trainer.teacher, state.teacher_params)):
        want = fwd(jparams, jnp.asarray(mel))
        with torch.no_grad():
            got = ours(torch.from_numpy(mel), temp_w=0.5)
        for key in ("strong", "weak", "at_out"):
            np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                       atol=ATOL_FORWARD, err_msg=key)


def test_trainer_step_with_augmentation_moves_student_and_teacher(tiny):
    """The default augmentation (fmin/fmax draw, frame shift, mixup, two
    filt_aug views) through a real frontend on the CPU: finite losses, the
    student moves, the teacher follows by EMA, and the same generator seed
    gives the same step."""
    port = tiny[0]
    cfg = mt.MeanTeacherConfig(strong_num=2, weak_num=2, unlabel_num=1, mixup_prob=1.0,
                               max_shift_frame=9, stu_kwargs=dict(temp_w=0.5))
    rng = np.random.RandomState(12)
    batch = {"wav": (0.1 * rng.randn(5, 38400)).astype(np.float32),
             "labels": (rng.rand(5, 2, 120) > 0.7).astype(np.float32)}
    runs = []
    for _ in range(2):
        model = PaSST_SED(**TINY, device="cpu")
        model.load_state_dict(port.state_dict())
        trainer = mt.MeanTeacherTrainer(model, PasstFrontend(device="cpu"), cfg)
        metrics = trainer.step(batch, torch.Generator().manual_seed(1))
        runs.append((float(metrics["loss_total"]), trainer))
    assert np.isfinite(runs[0][0]) and runs[0][0] == runs[1][0]
    trainer = runs[0][1]
    w0 = port.state_dict()["classifier.weight"]
    ws, wt = trainer.student.classifier.weight.detach(), trainer.teacher.classifier.weight
    # first EMA step: alpha = min(1 - 1/2, 0.999) = 0.5
    torch.testing.assert_close(wt, 0.5 * w0 + 0.5 * ws)
    assert not torch.equal(ws, w0)


def test_train_forward_draws_the_time_embedding_offset():
    """A clip shorter than the nominal grid takes its time embedding from a
    drawn offset in training only; training needs a generator."""
    model = init_weights_(PaSST_SED(**dict(TINY, backbone_img_size=(128, 998)), device="cpu"),
                          seed=1)
    mel = torch.from_numpy(np.random.RandomState(13).randn(1, 128, 120).astype(np.float32))
    with torch.no_grad():
        base = model(mel).strong
        with pytest.raises(ValueError, match="Generator"):
            model(mel, train=True)
        outs = [model(mel, train=True, generator=torch.Generator().manual_seed(s)).strong
                for s in range(3)]
    assert any(not torch.equal(o, base) for o in outs)


def test_unported_training_options_raise_with_their_roadmap_item():
    """The MLM mode and patchout are ported (tests/test_torch_port_mlm.py),
    and so are local attention, nearest interpolation and the sliding window
    (tests/test_torch_port_options.py); the other decoders and the
    frequency-wise pooling still raise."""
    for kw in (dict(decoder="gru"), dict(f_pool="frequency_wise_tranformer_encoder")):
        with pytest.raises(NotImplementedError, match="queue 1, item 12"):
            PaSST_SED(**TINY, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown interpolation mode"):
        PaSST_SED(**TINY, device="cpu", interpolate_mode="cubic")
    model = PaSST_SED(**TINY, device="cpu", decoder_win_len=[9, 17, 33, 60],
                      interpolate_mode="nearest")
    assert model.decoder.band_widths == (9, 17, 33, 60) and model.interpolate_mode == "nearest"
    model = PaSST_SED(**TINY, device="cpu", mlm=True, s_patchout_t=1)
    assert model.masker is not None and model.backbone.s_patchout_t == 1
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        model(torch.zeros(1, 128, 120), encoder_win=True, win_param=(64, 20))
