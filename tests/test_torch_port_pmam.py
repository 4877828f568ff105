"""The port's PMAM network (PaSST_CNN), held against the JAX package on the CPU.

A tiny PaSST_CNN of the PMAM shape (attention f-pool, a decoder narrower
than the backbone with small heads, the BatchNorm CNN branch, the AT
adapter) in eval and in training mode with the new running statistics, the
weight bridge, the optimizer's labels, the serving engine, and a 3-step
BatchNorm-aware mean-teacher trajectory against
``make_mean_teacher_step(model_state_aware=True)``. The JAX model is never
initialised: the port model is seeded and its state dict goes through the
JAX package's ``convert_torch_checkpoint``. Inputs come from numpy with a
seed; everything compares in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.core.filters import apply_class_filter as jax_class_filter
from transformer4sed_tpu.models.passt_cnn import PaSST_CNN as JaxPaSSTCNN
from transformer4sed_tpu.recipes.common import make_model_apply
from transformer4sed_tpu.train import mean_teacher as jax_mt
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.kernels import xl_attention as port_xl
from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.recipes.serve import InferenceEngine
from transformer4sed_tpu_torch.train import mean_teacher as mt
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import (
    init_weights_,
    jax_params_to_state_dict,
    load_jax_params,
)

# PMAM's shape in small (config/pmam/finetune1.yaml): a backbone 48 wide
# (divisible by the f-pool's 6 heads) tapped at its last layer, a decoder 32
# wide with 4 heads of 8, a two-layer context-gating BatchNorm CNN that pools
# the 128 mel bins to 1 and the 120 frames to 30 (resized back onto 120)
TINY_CNN = dict(nb_filters=(4, 8), kernel_size=(3, 3), padding=(1, 1), stride=(1, 1),
                pooling=((2, 8), (2, 16)), activation="cg", conv_dropout=0.0)
TINY = dict(
    class_num=3, embed_dim=48, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
    decoder_num_heads=4, passt_feature_layer=2, decoder_layer_num=1, decoder_pos_emd_len=120,
    f_pool="attention", at_adapter=True, at_adapter_heads=4, backbone_img_size=(128, 120),
    cnn_name="base", cnn_param=TINY_CNN,
)
FRAMES = 120
# model outputs after a dozen f32 matmuls, summed in another order
# (tests/test_torch_port_slice.py, tests/test_torch_parity.py)
ATOL_MODEL = 5e-5
# trajectory bounds of tests/test_torch_parity.py:2392-2412 and
# tests/test_torch_port_train.py
ATOL_LOSS = RTOL_LOSS = 2e-5
ATOL_FORWARD = 2e-4
# running variances after three momentum-0.99 updates of f32 batch moments
ATOL_STATS = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _mel(b, seed):
    return (np.random.RandomState(seed).randn(b, 128, FRAMES) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """(seeded port model, its JAX variables, the JAX model)."""
    port = init_weights_(PaSST_CNN(**TINY, device="cpu"), seed=0)
    params, model_state = convert_torch_checkpoint(_np_state(port), "PaSST_CNN",
                                                   init_kwargs=TINY)
    return port, {"params": params, **model_state}, JaxPaSSTCNN(**TINY)


@pytest.fixture(scope="module")
def jax_eval(tiny):
    _, _, jmodel = tiny
    return jax.jit(lambda v, mel, pm: jmodel.apply(v, mel, pad_mask=pm, temp_w=0.5))


def test_passt_cnn_weights_round_trip_and_key_checks(tiny):
    port, variables, _ = tiny
    reloaded = load_jax_params(PaSST_CNN(**TINY, device="cpu"), variables)
    for key, val in port.state_dict().items():
        assert torch.equal(val, reloaded.state_dict()[key]), key
    assert {"cnn.cnn.batchnorm1.running_var", "cnn.cnn.cg0.linear.weight", "merge_weight",
            "transformer_projector.weight", "cnn_projector.bias", "f_pool_module.f_att_token",
            "f_pool_module.frequency_att.in_proj_weight", "at_adpater.1.weight",
            "decoder.encoder_blocks.0.attn.pos_bias_u"} <= set(jax_params_to_state_dict(variables))
    assert port.decoder.encoder_blocks[0].attn.pos_bias_u.shape == (4, 8)
    assert port.decoder.encoder_blocks[0].attn.linear_pos.weight.shape == (32, 32)
    short = {"params": {k: v for k, v in variables["params"].items() if k != "cnn_projector"},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="cnn_projector"):
        load_jax_params(PaSST_CNN(**TINY, device="cpu"), short)
    with pytest.raises(KeyError, match="running_mean"):
        load_jax_params(PaSST_CNN(**TINY, device="cpu"), {"params": variables["params"]})


def test_tiny_passt_cnn_eval_matches_jax(tiny, jax_eval):
    port, variables, _ = tiny
    mel = _mel(2, seed=1)
    pm = np.zeros((2, FRAMES), bool)
    pm[1, 70:] = True
    want = jax_eval(variables, jnp.asarray(mel), jnp.asarray(pm))
    launches = port_xl.flash_xl_attention.launches
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(mel), temp_w=0.5, pad_mask=torch.from_numpy(pm))
    assert got.strong.shape == (2, 3, FRAMES) and got.weak.shape == got.at_out.shape == (2, 3)
    assert float(got.strong[1, :, 70:].abs().max()) == 0.0
    assert port_xl.flash_xl_attention.launches == launches  # the CPU takes the plain version
    for name in ("strong", "weak", "at_out", "frame_before_mask"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL_MODEL, err_msg=name)
    with pytest.raises(ValueError, match="eval mode"):
        port(torch.from_numpy(mel), train=True)


def test_tiny_passt_cnn_train_mode_matches_jax_with_new_statistics(tiny):
    """Training mode: batch statistics in the CNN branch, and the running
    statistics after the call, against flax's mutable ``batch_stats``."""
    port, variables, jmodel = tiny
    model = PaSST_CNN(**TINY, device="cpu").train()
    model.load_state_dict(port.state_dict())
    mel = _mel(3, seed=2)
    want, new = jax.jit(lambda v, m: jmodel.apply(
        v, m, train=True, temp_w=1.0, mutable=["batch_stats"],
        rngs={"patchout": jax.random.PRNGKey(0)}))(variables, jnp.asarray(mel))
    got = model(torch.from_numpy(mel), temp_w=1.0, train=True,
                generator=torch.Generator().manual_seed(0))
    for name in ("strong", "weak", "at_out"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), atol=ATOL_MODEL, err_msg=name)
    ours = model.state_dict()
    stats = jax_params_to_state_dict({"params": {}, "batch_stats": new["batch_stats"]},
                                     names=ours.keys())
    assert len(stats) == 4  # two CNN layers, mean and var
    for name, val in stats.items():
        np.testing.assert_allclose(ours[name].numpy(), val, atol=ATOL_MODEL, err_msg=name)
        assert not torch.equal(ours[name], port.state_dict()[name]), name


def test_passt_sed_attention_f_pool_matches_jax():
    """``f_pool='attention'`` on PaSST_SED itself (no CNN branch, decoder at
    the backbone's width), against the JAX PaSST_SED."""
    from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxSED

    cfg = {k: v for k, v in TINY.items() if k not in ("cnn_name", "cnn_param")}
    cfg["decoder_dim"] = cfg["embed_dim"]
    port = init_weights_(PaSST_SED(**cfg, device="cpu"), seed=3).eval()
    params, _ = convert_torch_checkpoint(_np_state(port), "PaSST_SED", init_kwargs=cfg)
    mel = _mel(2, seed=3)
    want = jax.jit(lambda p, m: JaxSED(**cfg).apply({"params": p}, m, temp_w=0.5))(
        params, jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), temp_w=0.5)
    for name in ("strong", "weak", "at_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL_MODEL, err_msg=name)


def test_passt_cnn_without_a_cnn_branch_projects_onto_the_decoder_width():
    cfg = dict(TINY, cnn_param=None)
    port = init_weights_(PaSST_CNN(**cfg, device="cpu"), seed=4).eval()
    assert port.cnn is None and "merge_weight" not in port.state_dict()
    params, model_state = convert_torch_checkpoint(_np_state(port), "PaSST_CNN", init_kwargs=cfg)
    mel = _mel(2, seed=4)
    want = jax.jit(lambda v, m: JaxPaSSTCNN(**cfg).apply(v, m, temp_w=0.5))(
        {"params": params, **model_state}, jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), temp_w=0.5, train=False)
    np.testing.assert_allclose(got.strong.numpy(), np.asarray(want.strong), atol=ATOL_MODEL)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(cnn_name="FDY-CNN"), NotImplementedError, "queue 1, item 10"),
    (dict(cnn_name="resnet"), NotImplementedError, "queue 1, item 10"),
    (dict(cnn_name="tdnn"), NotImplementedError, "unknown cnn encoder"),
    (dict(mlm=True), NotImplementedError, "queue 1, item 12"),
    (dict(f_pool="frequency_wise_tranformer_encoder"), NotImplementedError, "queue 1, item 2"),
    (dict(decoder="conformer"), NotImplementedError, "queue 1, item 2"),
])
def test_unported_passt_cnn_options_raise_with_their_roadmap_item(kw, exc, match):
    with pytest.raises(exc, match=match):
        PaSST_CNN(**dict(TINY, **kw), device="cpu")


def test_passt_cnn_forward_options_that_raise_and_the_card_default(tiny):
    port = tiny[0]
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        port.eval()(torch.zeros(1, 128, FRAMES), encoder_win=True)
    with pytest.raises(ValueError, match="decoder_dim must equal embed_dim"):
        PaSST_SED(**{k: v for k, v in TINY.items() if k not in ("cnn_name", "cnn_param")},
                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PaSST_CNN(**TINY)


# PMAM's groups (config/pmam/finetune1.yaml opt.param_groups) on the two-block
# backbone: block 0 frozen, block 1 and the final norm at the encoder rate
OPT_CFG = dict(
    encoder=dict(lr=5e-4, weight_decay=1e-4, freeze_layer=1, step_lr=0),
    decoder=dict(lr=1.5e-3, weight_decay=1e-4),
    head=dict(lr=2e-3, weight_decay=1e-4),
)


def _opt_cfgs(clip):
    jcfg = jax_optim.ParamGroupConfig(
        **{k: jax_optim.GroupSpec(**v) for k, v in OPT_CFG.items()}, backbone_depth=2,
        clip_grad=clip)
    pcfg = optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in OPT_CFG.items()},
                                  backbone_depth=2, clip_grad=clip)
    return jcfg, pcfg


def test_label_params_of_passt_cnn_match_jax(tiny):
    """The projectors, the merge weight and the f-pool fall to the decoder
    group, the CNN branch and the heads to 'head', the backbone to frozen and
    encoder groups: the port's labels on torch names equal JAX's on its paths."""
    port, variables, _ = tiny
    jcfg, pcfg = _opt_cfgs(20.0)
    params = variables["params"]
    jlabels = jax_optim.label_params(params, jcfg)
    codes = {name: i for i, name in enumerate(sorted(set(jax.tree_util.tree_leaves(jlabels))))}
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   jlabels, params)
    ours = optim.label_params(dict(port.named_parameters()), pcfg)
    assert set(ours.values()) == {"frozen", "encoder_low", "decoder", "head"}
    for name in ("transformer_projector.weight", "cnn_projector.bias", "merge_weight",
                 "f_pool_module.f_att_token", "decoder.encoder_blocks.0.attn.pos_bias_v"):
        assert ours[name] == "decoder", name
    assert ours["cnn.cnn.conv0.weight"] == ours["at_adpater.1.bias"] == "head"
    assert ours["backbone.blocks.0.attn.qkv.weight"] == "frozen"
    for name, arr in jax_params_to_state_dict(coded).items():
        assert np.all(np.asarray(arr) == codes[ours[name]]), name


class _IdentityFrontend:
    """mel in, mel out: the train step without the STFT."""

    def __call__(self, wav, fminmax=None, key=None, training=False):
        return wav

    def draw_fminmax(self, gen):
        return None

    def normalize(self, mel):
        return mel


def test_batchnorm_aware_mean_teacher_trajectory_matches_jax(tiny):
    """Three steps of the port's trainer against
    ``make_mean_teacher_step(model_state_aware=True)`` with PMAM's loss
    weights and param groups (augmentation and dropout off, identity
    frontend, same weights): every step's losses and gradient norm, then
    both sets of running statistics and the student's and the teacher's
    parameters through a training-mode forward. The teacher's statistics move with the
    teacher's own training-mode forward and are not EMA-averaged."""
    port, variables, jmodel = tiny
    common = dict(strong_num=2, weak_num=1, unlabel_num=1, self_loss_warmup_steps=3,
                  cons_scheduler="Linear", w_weak=0.5, w_weak_cons=0.5, w_at=2.0, w_cons_max=2.0,
                  mixup_prob=0.0, max_shift_frame=0, n_transform=0,
                  stu_kwargs=dict(temp_w=1), tch_kwargs=dict(temp_w=1))
    jcfg, pcfg = jax_mt.MeanTeacherConfig(**common), mt.MeanTeacherConfig(**common)
    jopt, popt = _opt_cfgs(clip=0.05)
    params = variables["params"]
    model_state = {"batch_stats": variables["batch_stats"]}
    tx, _ = jax_optim.build_optimizer(params, jopt)
    step_fn = jax.jit(jax_mt.make_mean_teacher_step(
        make_model_apply(jmodel, True), _IdentityFrontend(), tx, jcfg, model_state_aware=True))
    state = jax_mt.create_mean_teacher_state(params, tx, model_state)
    rng = np.random.RandomState(5)
    mel = _mel(4, seed=5)
    labels = (rng.rand(4, 3, FRAMES) > 0.7).astype(np.float32)
    labels[2, :, 1:] = 0.0  # the weak row holds its tags in frame 0 (data/datasets.py:89)
    batch = {"wav": jnp.asarray(mel), "labels": jnp.asarray(labels)}
    model = PaSST_CNN(**TINY, device="cpu")
    model.load_state_dict(port.state_dict())
    trainer = mt.MeanTeacherTrainer(model, _IdentityFrontend(), pcfg, popt)
    gen = torch.Generator().manual_seed(0)
    names = ("loss_total", "loss_class_strong", "loss_class_weak", "loss_class_at_specific",
             "loss_cons_strong", "loss_cons_weak", "loss_cons_at_specific")
    for i in range(3):
        state, jm = step_fn(state, batch, jax.random.PRNGKey(i))
        pm = trainer.step({"wav": mel, "labels": labels}, gen)
        np.testing.assert_allclose([float(pm[k]) for k in names], [float(jm[k]) for k in names],
                                   atol=ATOL_LOSS, rtol=RTOL_LOSS, err_msg=f"step {i}")
        np.testing.assert_allclose(pm["w_cons"], float(jm["w_cons"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(pm["grad_norm"]) > popt.clip_grad  # the clip is active
    sides = ((trainer.student, state.params, state.model_state),
             (trainer.teacher, state.teacher_params, state.teacher_model_state))
    start = port.state_dict()
    # the end parameters are compared through a training-mode forward: batch
    # statistics cancel the conv biases' noise, which an eval forward would show
    fwd = jax.jit(lambda v, m: jmodel.apply(v, m, train=True, temp_w=0.5, mutable=["batch_stats"],
                                            rngs={"patchout": jax.random.PRNGKey(9)})[0])
    stats = []
    for ours, jparams, jstate in sides:
        sd = ours.state_dict()
        want_stats = jax_params_to_state_dict({"params": {}, **jstate}, names=sd.keys())
        assert len(want_stats) == 4
        for name, val in want_stats.items():
            # a conv bias ahead of BatchNorm has rounding noise for a gradient;
            # Adam turns its sign into a full step (head lr 2e-3, 3 steps), the
            # two packages' noise differs, and the running mean absorbs that bias
            atol = 3 * OPT_CFG["head"]["lr"] if name.endswith("running_mean") else ATOL_STATS
            np.testing.assert_allclose(sd[name].numpy(), val, atol=atol, err_msg=name)
            assert not torch.equal(sd[name], start[name]), name
        stats.append({k: sd[k] for k in want_stats})
        want = fwd({"params": jparams, **jstate}, jnp.asarray(mel))
        with torch.no_grad():
            got = ours(torch.from_numpy(mel), temp_w=0.5, train=True, generator=gen)
        for key in ("strong", "weak", "at_out"):
            np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                       atol=ATOL_FORWARD, err_msg=key)
    # a frozen backbone block kept its weights, a live one moved; the teacher's
    # statistics are its own, not the student's and not an average of them
    assert torch.equal(trainer.student.backbone.blocks[0].attn.qkv.weight,
                       start["backbone.blocks.0.attn.qkv.weight"])
    assert not torch.equal(trainer.student.backbone.blocks[1].attn.qkv.weight,
                           start["backbone.blocks.1.attn.qkv.weight"])
    assert any(not torch.equal(stats[0][k], stats[1][k]) for k in stats[0])


def test_inference_engine_serves_passt_cnn_like_the_jax_pipeline(tiny, jax_eval):
    """The serving engine over PaSST_CNN with the config's test_kwargs
    (temp_w 0.5): eval forward, per-class median filter, ragged last batch."""
    port, variables, _ = tiny
    codec = LabelCodec(tuple("abc"), audio_len=1.2, frame_len=1024, frame_hop=320, net_pooling=1,
                       sr=32000)
    mels = _mel(3, seed=6)
    pms = np.zeros((3, FRAMES), bool)
    pms[2, 90:] = True
    batches = [{"wav": mels[i:i + 2], "pad_mask": pms[i:i + 2],
                "filename": [f"clip{j}.wav" for j in range(i, min(i + 2, 3))]} for i in (0, 2)]

    class _Frontend(_IdentityFrontend):
        device = torch.device("cpu")

    widths = [3, 7, 5]
    engine = InferenceEngine(port, _Frontend(), codec, median_filter=widths, batch_size=2,
                             model_kwargs={"temp_w": 0.5}, device="cpu")
    served = list(engine.score_batches(batches))
    assert not port.training and [len(n) for n, _, _ in served] == [2, 1]
    for (names, scores, weak), batch in zip(served, batches):
        n = len(names)
        mel, pm = batch["wav"], batch["pad_mask"]
        if n < 2:
            mel = np.concatenate([mel, np.zeros_like(mel)])
            pm = np.concatenate([pm, np.ones_like(pm)])
        out = jax_eval(variables, jnp.asarray(mel), jnp.asarray(pm))
        ref = np.asarray(jax_class_filter(out.strong.transpose(0, 2, 1), widths))[:n]
        np.testing.assert_allclose(scores, ref, atol=ATOL_MODEL)
        np.testing.assert_allclose(weak, np.asarray(out.weak)[:n], atol=ATOL_MODEL)
