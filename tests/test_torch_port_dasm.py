"""The port's DASM slice, held against the JAX package on the CPU.

The DASM forward (learnable queries, two projector modalities at eval, one
bank through the projector of ``query_type``, ``tgt_mask``, ``out_type``
'logit', 'sigmoid' and None, ``decoder='no'``, ``cnn_param``, ``encoder_win``,
``pad_mask``) with the seeded port state dict carried into JAX by
``convert_dasm`` and back by ``load_jax_params``; the label transforms and
the recipe helpers, exactly; the optimizer groups that DASM adds (its
losses are in ``tests/test_torch_port_options.py``); a 3-step closed-set ``DASMStep`` trajectory (two query modalities, the
(C+1)-way CE) and two open-vocabulary steps, one with learnable queries and
one on ``config/dasm/open_vocab.yaml``'s projector network through
``OVDASMTrainer``'s step, all fed the draws JAX makes (the preprocess's, the per-query modality pick and the AT
decoder's dropout masks, read out of the JAX step itself); validation and
``openset_evaluate`` on fixed scores against JAX's PSDS; the reference's
faults under ``config/dasm/open_vocab.yaml``; and the port CLI's four
AudioSet stages and serving with ``--query`` on a tiny config (port only).
Everything is float32.

The JAX programs compile once each at OPT0 in four worker processes started
with the module (``tests/torch_port_dasm_jax.py``, which imports no torch),
while the port-only tests, which come first, run.
"""

import concurrent.futures
import json
import multiprocessing
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transformer4sed_tpu.eval.decode import batched_decode_preds as jax_decode
from transformer4sed_tpu.eval.psds import compute_psds_from_scores as jax_psds
from transformer4sed_tpu.models import dasm as jax_dasm
from transformer4sed_tpu.recipes import audioset_strong as jax_as
from transformer4sed_tpu.recipes import dasm_recipe as jax_recipe
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.train.mlm import MLMState
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.data.tsv import write_tsv
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models import dasm
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.recipes import audioset_strong, cli, dasm_recipe, infer, serve
from transformer4sed_tpu_torch.recipes import common as port_common
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
from transformer4sed_tpu_torch.utils.weights import (
    init_weights_,
    jax_params_to_state_dict,
    load_jax_params,
)
from transformer4sed_tpu_torch.utils.yamlio import safe_dump
from tests import torch_port_dasm_jax as dasm_jax
from tests.test_torch_port_train import _IdentityFrontend
from tests.torch_port_dasm_jax import (
    AT_KEEP,
    MEL_F,
    QUERY_DIM,
    STEP_CASES,
    T,
    TINY,
    VARIANTS,
    banks,
    case_model,
    case_query,
    forward_kwargs,
    jax_opt_cfg,
    jax_variables,
    mel,
    opt_spec,
    step_batch,
    step_config,
)

ROOT = Path(__file__).resolve().parents[1]
# the forward's outputs after a few dozen f32 matmuls summed in another order
# (tests/test_torch_parity.py); the f32 sigmoid of logits / 0.1 magnifies them 10x
ATOL_FORWARD = 2e-5
# trajectory bounds of tests/test_torch_port_train.py (test_torch_parity.py:2392-2412)
ATOL_LOSS = RTOL_LOSS = 2e-5
# params after three AdamW steps at lr 1e-4 .. 4e-4 from gradients that agree to
# f32 rounding (tests/test_torch_port_supervised.py)
ATOL_PARAMS = 5e-5
# PSDS of the same scores, a few f32 ulps apart (the sweep's thresholds are
# the scores themselves; tests/test_torch_port_recipes.py)
PSDS_ATOL = 1e-6
SR, CLIP_S = 32000, 1.2
FEATURE = {"pred_len": T, "n_mels": MEL_F, "n_fft": 1024, "hopsize": 320, "win_length": 800,
           "audio_max_len": CLIP_S, "sr": SR, "net_subsample": 1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def no_tensorflow():
    """The TensorBoard writer without TensorFlow (its import costs seconds),
    module-wide: the stage fixtures are module-scoped."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        yield


def _np_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _port(variant, seed=0):
    return init_weights_(dasm.DASM(**dict(TINY, **VARIANTS[variant]), device="cpu"), seed=seed)


def _case_port(case):
    return init_weights_(dasm.DASM(**case_model(case), device="cpu"), seed=0)


def _jax_variables(port):
    return jax_variables(_np_state(port))


def _opt_cfgs(**groups):
    return jax_opt_cfg(**groups), optim.ParamGroupConfig(
        **{k: optim.GroupSpec(**v) for k, v in opt_spec(**groups).items()}, clip_grad=0.5)




@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """The JAX side, in four worker processes started with the module (their
    tracing would hold this process's GIL), each importing only
    ``tests/torch_port_dasm_jax.py``: the forwards, the closed-set
    trajectory, the two open-vocabulary steps."""
    states = {v: _np_state(_port(v)) for v in VARIANTS}
    pool = concurrent.futures.ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
        "spawn"))
    futures = {"forward": pool.submit(dasm_jax.forward_outputs, states)}
    for case, n in (("closed", 3), ("open_vocab", 1), ("open_vocab_text", 1)):
        futures[case] = pool.submit(dasm_jax.trajectory, case, n, _np_state(_case_port(case)))
    yield futures
    pool.shutdown(wait=True)


# -- the model ----------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [VARIANTS["two_modalities_logit_tgt_mask"],
                                    VARIANTS["cnn_branch_windows"],
                                    dict(query_projector=True, query_dim=QUERY_DIM[0])])
def test_jax_variables_round_trip_through_the_weight_bridge(kwargs):
    """``load_jax_params`` of ``convert_dasm``'s tree gives back the seeded
    state dict: the flax MHA kernels, the per-modality projectors (and the
    single one), the AT decoder's nesting and the MLPs map one to one; the
    JAX-style paths of the warm-start patterns name the JAX leaves."""
    port = init_weights_(dasm.DASM(**dict(TINY, **kwargs), device="cpu"), seed=0)
    variables = _jax_variables(port)
    back = load_jax_params(dasm.DASM(**dict(TINY, **kwargs), device="cpu"), variables)
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    from transformer4sed_tpu_torch.utils.weights import jax_style_path

    assert jax_style_path("at_decoder.decoder.layers.0.linear1.weight") == (
        "at_decoder/layers_0/linear1/kernel")
    assert jax_style_path("query_projector.1.0.weight") == "query_projector_1/kernel"
    assert jax_style_path("query_projector.0.bias") == "query_projector/bias"
    assert jax_style_path("mask_embedding_layer.layers.2.bias") == (
        "mask_embedding_layer/layers_2/bias")


def test_one_bank_with_two_projectors_needs_query_type_in_both_packages():
    """The reference's fault under open_vocab.yaml (one bank, two projectors,
    no query_type): both packages raise the same error; a query_type picks
    the projector."""
    variant = "two_modalities_logit_tgt_mask"
    port = _port(variant).eval()
    clip, bank = torch.from_numpy(mel(1, 4)), banks()[0]
    jmodel = jax_dasm.DASM(**dict(TINY, **VARIANTS[variant]))
    with pytest.raises(RuntimeError, match="query_type must be 'text' or 'audio'"):
        jax.eval_shape(lambda v: jmodel.apply(v, jnp.asarray(clip.numpy()),
                                              query=jnp.asarray(bank)), _jax_variables(port))
    with pytest.raises(RuntimeError, match="query_type must be 'text' or 'audio'"):
        port(clip, query=bank)
    with torch.no_grad():
        text = port(clip, query=bank, query_type="text")
        listed = port(clip, query=banks())  # eval: the first modality
    assert torch.equal(text.strong, listed.strong)
    with pytest.raises(ValueError, match="needs external query tensors"):
        port(clip)


def test_unported_options_raise_naming_their_queue_item():
    for kw, item in ((dict(decoder="gru"), "item 12"), (dict(decoder="conformer"), "item 12"),
                     (dict(mlm_dict={"mask_rate": 0.75}), "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            dasm.DASM(**dict(TINY, **kw), device="cpu")


def test_label_transforms_and_recipe_helpers_match_jax_exactly():
    rng = np.random.RandomState(5)
    weak = (rng.rand(3, 5) > 0.5).astype(np.float32)
    mc = dasm.multi_label_to_multi_class(torch.from_numpy(weak))
    np.testing.assert_array_equal(mc.numpy(), np.asarray(
        jax_dasm.multi_label_to_multi_class(jnp.asarray(weak))))
    np.testing.assert_array_equal(dasm.multi_class_to_multi_label(mc).numpy(), weak)
    common = np.array([True, False, True, True, False, False, True])
    np.testing.assert_array_equal(dasm_recipe.common_first_order(common),
                                  jax_recipe.common_first_order(common))
    np.testing.assert_array_equal(dasm_recipe.open_vocab_att_mask(common),
                                  jax_recipe.open_vocab_att_mask(common))
    pred = rng.rand(2, 7, 4).astype(np.float32)
    np.testing.assert_array_equal(
        dasm_recipe.reorder_pred(torch.from_numpy(pred), common).numpy(),
        np.asarray(jax_recipe.reorder_pred(jnp.asarray(pred), common)))
    scores, targets = rng.rand(20, 6), (rng.rand(20, 6) > 0.6).astype(np.float32)
    targets[:, 3] = 0  # a class without positives is left out
    assert dasm_recipe.macro_average_precision(scores, targets) == (
        jax_recipe.macro_average_precision(scores, targets))
    single = {"a": 0.5, "b": 0.25, "c": 0.125, "d": 0.0625}
    types = {"a": "common", "b": "rare", "c": "common"}
    assert dasm_recipe.split_psds_by_type(single, types) == (
        jax_recipe.split_psds_by_type(single, types))
    gt = {"x": [(0.0, 1.0, "a"), (2.0, 3.0, "c")], "y": []}
    assert audioset_strong.drop_absent_classes(single, gt, list(single)) == (
        jax_as.drop_absent_classes(single, gt, list(single)))
    logits = rng.randn(3, 5, 6).astype(np.float32)
    np.testing.assert_allclose(
        float(dasm_recipe.ce_multiclass(torch.from_numpy(logits), torch.from_numpy(weak))),
        float(jax_recipe._ce_multiclass(jnp.asarray(logits), jnp.asarray(weak))), rtol=1e-6)


@pytest.mark.parametrize("groups", [dict(), dict(at_decoder=True, query=True)])
def test_label_params_match_jax_on_dasm(groups):
    """The AudioSet policy's groups on DASM: at_decoder before the generic
    'decoder' keyword, the learnable bank as 'query'; without them the AT
    decoder falls to 'decoder' and the bank to 'head', as in JAX."""
    port = _port("learnable_sigmoid_pad_mask")
    params = _jax_variables(port)["params"]
    jcfg, pcfg = _opt_cfgs(**groups)
    jlabels = jax_optim.label_params(params, jcfg)
    codes = {n: i for i, n in enumerate(sorted(set(jax.tree_util.tree_leaves(jlabels))))}
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   jlabels, params)
    named = dict(port.named_parameters())
    ours = optim.label_params(named, pcfg)
    assert ours["at_query"] == ("query" if groups else "head")
    assert ours["at_decoder.decoder.layers.0.self_attn.in_proj_weight"] == (
        "at_decoder" if groups else "decoder")
    for name, arr in jax_params_to_state_dict(coded, names=named.keys()).items():
        assert np.all(arr == codes[ours[name]]), name
    cfg = {"opt": {"param_groups": {"encoder": {"lr": 1e-5}, "decoder": {"lr": 2e-4},
                                    "head": {"lr": 2e-4}, "at_decoder": {"lr": 3e-4},
                                    "query": {"lr": 5e-4, "weight_decay": 0.0}}},
           "training": {"scheduler": {"n_epochs": 2, "n_epochs_cut": 1}}}
    pg, _, _ = port_common.optimizer_from_config(cfg, 4)
    assert pg.at_decoder.lr == 3e-4 and pg.query == optim.GroupSpec(lr=5e-4, weight_decay=0.0)


# -- the train steps --------------------------------------------------------------------


def _run_steps(jax_side, case, n_steps):
    """The port's ``DASMStep`` replaying the JAX trajectory with its draws."""
    c = STEP_CASES[case]
    pcfg, (_, popt) = dasm_recipe.DASMTrainConfig(**step_config(case)), _opt_cfgs(**c["groups"])
    batch = step_batch()
    port = _case_port(case)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    if c.get("query_type"):
        # the step dasm_ov builds: OVDASMTrainer's config and its slice of the bank
        trainer = object.__new__(dasm_recipe.OVDASMTrainer)
        trainer.config = {"training": {"w_AT": pcfg.w_at},
                          "DASM": {"train_kwargs": pcfg.model_kwargs}}
        trainer.model_name, trainer.model, trainer.frontend = "DASM", port, _IdentityFrontend()
        trainer.device, trainer.common_mask = torch.device("cpu"), np.asarray(c["common_mask"])
        trainer.query_bank = torch.from_numpy(banks()[0])
        stepper = trainer.make_step(popt, None, 1)
        assert not stepper.cfg.query_from_params and stepper.cfg.model_kwargs == pcfg.model_kwargs
    else:
        query = [torch.from_numpy(b) for b in banks()] if c["common_mask"] is None else None
        stepper = dasm_recipe.DASMStep(port, _IdentityFrontend(), pcfg, popt, query=query)
    steps, end, jax_count = jax_side[case].result()
    assert len(steps) == n_steps
    for i, st in enumerate(steps):
        filt = augment.FiltAugDraw(st["n_bands"], torch.from_numpy(st["band_raw"]),
                                   torch.from_numpy(st["band_db"]))
        draw = audioset_strong.SupervisedDraw(
            None, torch.from_numpy(st["shifts"]), st["do_mix"], torch.from_numpy(st["perm"]),
            st["c"], [augment.ViewDraw(filt=filt)])
        masks = [torch.from_numpy(m).float() / AT_KEEP for m in st["masks"]]
        pick = None if st["pick"] is None else torch.from_numpy(st["pick"])
        assert len(masks) == 4 and draw.do_mix
        pm = stepper.step(batch, None, draw, masks, query_pick=pick)
        for k in ("loss_total", "loss_class_strong", "loss_class_at_specific"):
            np.testing.assert_allclose(float(pm[k]), st["metrics"][k], atol=ATOL_LOSS,
                                       rtol=RTOL_LOSS, err_msg=f"step {i} {k}")
        assert float(pm["grad_norm"]) > popt.clip_grad  # the clip is active
    assert stepper.step_count == jax_count == n_steps
    end = jax_params_to_state_dict(end, names=port.state_dict().keys())
    for name, want in end.items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), want, atol=ATOL_PARAMS,
                                   err_msg=name)
    return port, start


def test_open_vocab_yaml_learnable_flag_departs_from_the_jax_trainer():
    """The JAX trainer takes ``query_from_params`` from the config's
    ``at_param.query_projector``; ``config/dasm/open_vocab.yaml`` sets none,
    so its projector model is sliced by an ``at_query`` it lacks (KeyError in
    the JAX step). The port reads the model: a projector model takes its bank."""
    config = load_yaml_with_include(str(ROOT / "config/dasm/open_vocab.yaml"))
    fake = type("T", (), {"config": config, "model_name": "DASM"})()
    assert jax_recipe.DASMTrainer._dasm_config(fake, (True, False)).query_from_params
    variant = "two_modalities_logit_tgt_mask"
    params = _jax_variables(_port(variant))["params"]
    cfg = jax_recipe.DASMTrainConfig(common_mask=(True, False, True), query_from_params=True)
    step = jax_recipe.make_dasm_step(lambda *a, **k: None, _IdentityFrontend(), None, cfg)
    batch = {"wav": jnp.zeros((1, MEL_F, T)), "labels": jnp.zeros((1, 3, T))}
    with pytest.raises(KeyError, match="at_query"):
        jax.eval_shape(lambda p: step(MLMState(params=p, opt_state=None, step=0,
                                               model_state=None), batch,
                                      jax.random.PRNGKey(0)), params)
    trainer = object.__new__(dasm_recipe.DASMTrainer)
    trainer.config, trainer.model_name, trainer.model = config, "DASM", _port(variant)
    assert not trainer.dasm_config(common_mask=(True, False, True)).query_from_params


# -- validation and open-set evaluation on fixed scores -----------------------------------

LABELS = ["Bark", "Speech", "Siren", "Doorbell"]
NOVEL = ["Audio logo", "Cart"]


class _ScoreModel(torch.nn.Module):
    """Fixed scores: clip b's class q at frame t is sigmoid(s_q * wav[b, t]),
    s_q the query's sum (learnable-query bank [4, 6] by default)."""

    query_projector = None

    def __init__(self):
        super().__init__()
        self.at_query = torch.nn.Parameter(torch.from_numpy(banks(7, 4)[0]))

    def forward(self, mel, pad_mask=None, query=None, tgt_mask=None, temp_w=0.1, **kw):
        q = self.at_query if query is None else query
        strong = torch.sigmoid(q.sum(-1)[None, :, None] * mel[:, None, :T] / temp_w)
        return SEDOutput(strong=strong, weak=strong.mean(-1), at_out=strong.amax(-1))


def _jax_scores(query, wav, temp_w=0.1):
    return jax.nn.sigmoid(jnp.asarray(query).sum(-1)[None, :, None]
                          * jnp.asarray(wav)[:, None, :T] / temp_w)


def _fixed_batches():
    rng = np.random.RandomState(9)
    wav = rng.randn(5, T).astype(np.float32)
    names = [f"v{i}.wav" for i in range(5)]
    batches = [{"wav": wav[i:i + 2], "pad_mask": np.zeros((len(wav[i:i + 2]), T), bool),
                "filename": names[i:i + 2],
                "label": (rng.rand(len(wav[i:i + 2]), 4, T) > 0.8).astype(np.float32)}
               for i in (0, 2, 4)]
    gt = {"v0": [(0.1, 0.5, "Bark")], "v1": [(0.2, 0.9, "Siren"), (0.0, 0.3, "Bark")],
          "v2": [(0.4, 1.1, "Cart")], "v3": [], "v4": [(0.6, 1.0, "Siren")]}
    return wav, names, batches, gt, {n[:-4]: CLIP_S for n in names}


def _codec(labels):
    return LabelCodec(labels=tuple(labels), audio_len=CLIP_S, frame_len=1024, frame_hop=320,
                      net_pooling=1, sr=SR)


def _jax_psds(strong, names, codec, gt, dur, median):
    _, post = jax_decode(strong, names, codec, filter=median)
    return jax_psds(post, gt, dur, dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0.0,
                    alpha_st=0.0)


def _trainer(cls, batches, **kw):
    config = {"model_name": "DASM", "training": {"scheduler": {"n_epochs": 1, "n_epochs_cut": 1}},
              "opt": {"param_groups": {"encoder": {"lr": 1e-5}, "decoder": {"lr": 1e-4},
                                       "head": {"lr": 1e-4}}},
              "DASM": {"val_kwargs": {"temp_w": 0.1}}}
    logger = type("L", (), {"scalars": lambda *a: None, "info": lambda *a: None})()
    return cls(_ScoreModel(), _IdentityFrontend(), config, _codec(LABELS), batches, batches,
               logger, **kw)


def test_validation_and_open_vocab_validation_match_jax_psds():
    """``SupervisedTrainer.validation`` and ``OVDASMTrainer.validation`` on
    fixed scores: PSDS at alpha 0 over JAX's decode and sweep, the per-type
    means over the classes present, and the open-vocabulary pass (queries in
    common-first order, predictions reordered back, the AT macro mAP)."""
    wav, names, batches, gt, dur = _fixed_batches()
    gt = {k: [e for e in v if e[2] in LABELS] for k, v in gt.items()}
    types = {"Bark": "common", "Speech": "rare", "Siren": "common", "Doorbell": "rare"}
    trainer = _trainer(audioset_strong.SupervisedTrainer, batches, type_map=types)
    got = trainer.validation(0, gt, dur, median_filter=3)
    bank = trainer.model.at_query.detach().numpy()
    want, single = _jax_psds(_jax_scores(bank, wav), names, _codec(LABELS), gt, dur, 3)
    assert got["psds"] == pytest.approx(want, abs=PSDS_ATOL)
    want_types = jax_recipe.split_psds_by_type(
        jax_as.drop_absent_classes(single, gt, LABELS), types)
    assert set(got) == {"psds", "psds_common"} and set(want_types) == {"psds_common"}
    assert got["psds_common"] == pytest.approx(want_types["psds_common"], abs=PSDS_ATOL)

    common = np.array([types[c] == "common" for c in LABELS])
    ov = _trainer(dasm_recipe.OVDASMTrainer, batches, type_map=types, common_mask=common)
    got = ov.validation(0, gt, dur, median_filter=3)
    order = jax_recipe.common_first_order(common)
    strong = jax_recipe.reorder_pred(_jax_scores(bank[order], wav), common)
    want, _ = _jax_psds(strong, names, _codec(LABELS), gt, dur, 3)
    assert got["psds"] == pytest.approx(want, abs=PSDS_ATOL)
    at = np.concatenate([b["label"] for b in batches]).sum(-1) >= 1
    assert got["at_mAP"] == pytest.approx(jax_recipe.macro_average_precision(
        np.asarray(strong).max(-1), at.astype(np.float32)), abs=PSDS_ATOL)


def test_openset_evaluate_matches_jax():
    """The novel queries after the bank, the extended vocabulary scored and
    swept as the JAX function does; the count is checked against the codec."""
    wav, names, batches, gt, dur = _fixed_batches()
    codec = _codec(LABELS + NOVEL)
    extra = banks(8, 2)[0]
    model = _ScoreModel()
    psds, single, top10 = dasm_recipe.openset_evaluate(
        model, _IdentityFrontend(), codec, batches, extra, gt, dur, median_filter=3,
        model_kwargs={"temp_w": 0.1})

    class JaxStub:
        def apply(self, variables, mel, train=False, pad_mask=None, query=None, temp_w=0.1):
            return SEDOutput(strong=_jax_scores(query, mel, temp_w))

    want = jax_recipe.openset_evaluate(
        JaxStub(), _IdentityFrontend(), {"at_query": model.at_query.detach().numpy()}, codec,
        batches, extra, gt, dur, median_filter=3, model_kwargs={"temp_w": 0.1})
    assert psds == pytest.approx(want[0], abs=PSDS_ATOL)
    assert single.keys() == want[1].keys() and list(top10) == list(want[2])
    with pytest.raises(ValueError, match="extended query count"):
        dasm_recipe.openset_evaluate(model, _IdentityFrontend(), _codec(LABELS), batches, extra,
                                     gt, dur)


def test_label_tables_and_weighted_sampler_match_jax():
    """The vendored AudioSet-strong tables as both packages read them: the
    447 classes in index order, the type map, and the weighted sampler of
    ``train/weight.tsv`` (read by the port's TSV reader, not pandas) drawing
    the same clips epoch by epoch."""
    meta = ROOT / "meta" / "audioset_strong"
    labels = audioset_strong.load_label_dict(str(meta / "labeldict_audioset_strong.json"))
    assert labels == jax_as.load_label_dict(str(meta / "labeldict_audioset_strong.json"))
    assert len(labels) == 447
    assert audioset_strong.load_type_map(str(meta / "state.json")) == jax_as.load_type_map(
        str(meta / "state.json"))
    ours = audioset_strong.get_weighted_sampler(str(meta / "train" / "weight.tsv"), 64, seed=3)
    theirs = jax_as.get_weighted_sampler(str(meta / "train" / "weight.tsv"), 64, seed=3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)


# -- the stages and serving through the port CLI, tiny, on the CPU ------------------------


@pytest.fixture(scope="module")
def mini_audioset(tmp_path_factory):
    """Four classes of the vendored label tables (two common, two rare), two
    novel ones, eight train and five val 1.2-s clips with tone events, the
    text [4, 6] and audio [4, 5] query banks and the novel text queries."""
    root = tmp_path_factory.mktemp("mini_as")
    rng = np.random.RandomState(0)
    tone = (0.3 * np.sin(2 * np.pi * 880 * np.arange(int(0.4 * SR)) / SR)).astype(np.float32)
    events = ["filename", "onset", "offset", "event_label"]
    for split, n, labels in (("train", 8, LABELS), ("val", 5, LABELS + NOVEL)):
        (root / split).mkdir()
        rows, durs = [], []
        for i in range(n):
            wav = rng.randn(int(SR * CLIP_S)).astype(np.float32) * 0.02
            on = 0.1 + 0.1 * (i % 5)
            wav[int(on * SR):int(on * SR) + len(tone)] += tone
            wavfile.write(root / split / f"{split[0]}{i}.wav", SR, (wav * 32767).astype(np.int16))
            rows.append((f"{split[0]}{i}.wav", on, on + 0.4, labels[i % len(labels)]))
            durs.append((f"{split[0]}{i}.wav", CLIP_S))
        write_tsv(str(root / f"{split}.tsv"), events, rows)
        write_tsv(str(root / f"{split}_dur.tsv"), ["filename", "duration"], durs)
    (root / "labels.json").write_text(json.dumps({c: i for i, c in enumerate(LABELS)}))
    (root / "state.json").write_text(json.dumps(
        {"Bark": "common", "Speech": "rare", "Siren": "common", "Doorbell": "rare"}))
    (root / "novel.json").write_text(json.dumps(NOVEL))
    text, audio = banks(2, 4)
    np.save(root / "text.npy", text)
    np.save(root / "audio.npy", audio)
    np.save(root / "novel_text.npy", banks(3, 2)[0])
    return root


def _stage_config(root, shipped, n_epochs=1, **dasm_kwargs):
    """A shipped AudioSet config with the dataset paths, epochs, batch and
    widths made tiny."""
    config = load_yaml_with_include(str(ROOT / "config" / shipped))
    r = str(root)
    config["generals"]["num_workers"] = 0
    config["feature"] = dict(FEATURE)
    config["dataset"].update(
        label_dict=f"{r}/labels.json", type_map=f"{r}/state.json", text_query=f"{r}/text.npy",
        audio_query=f"{r}/audio.npy", train_folder=f"{r}/train", train_tsv=f"{r}/train.tsv",
        val_folder=f"{r}/val", val_tsv=f"{r}/val_base.tsv", val_dur=f"{r}/val_dur.tsv")
    config["dataset"].pop("weight_tsv", None)
    base = [ln for ln in (root / "val.tsv").read_text().splitlines()
            if not any(n in ln for n in NOVEL)]
    (root / "val_base.tsv").write_text("\n".join(base) + "\n")
    tr = config["training"]
    tr.update(batch_size=[4], batch_size_val=3, median_window=3)
    tr.pop("samples_per_epoch", None)
    tr["scheduler"].update(n_epochs=n_epochs, n_epochs_cut=1, lr_warmup_epochs=0)
    name = config["model_name"]
    section = config[name]
    if name == "DASM":
        section["init_kwargs"].update(
            {k: v for k, v in TINY.items() if k not in ("out_type", "backbone_img_size",
                                                        "class_num")},
            class_num=4, query_dim=list(QUERY_DIM), **dasm_kwargs)
    else:
        from tests.test_torch_port_pmam import TINY as PMAM_TINY

        section["init_kwargs"] = json.loads(json.dumps(dict(
            PMAM_TINY, class_num=4, at_adapter=False, f_pool="mean_pool")))  # tuples -> lists
    return config


def _write(config, path):
    path.write_text(safe_dump(config))
    return str(path)


def _run(stage, cfg, folder, *extra):
    return cli.main([stage, "--config_dir", cfg, "--save_folder", str(folder), "--device", "cpu",
                     "--random_seed", "3", *extra])


@pytest.fixture(scope="module")
def closed_run(mini_audioset, tmp_path_factory):
    """dasm_train on the shipped closed_set.yaml, made tiny: one epoch."""
    tmp = tmp_path_factory.mktemp("dasm_closed")
    cfg = _write(_stage_config(mini_audioset, "dasm/closed_set.yaml"), tmp / "closed.yaml")
    assert _run("dasm_train", cfg, tmp / "closed") == 0
    return tmp, cfg


def test_dasm_train_stage_writes_best_and_resumes(closed_run):
    tmp, cfg = closed_run
    folder = tmp / "closed"
    log = (folder / "log.txt").read_text()
    assert "epoch 1: train {" in log and "'psds':" in log and "psds_common" in log
    for name in ("best_student", "best_metric.json", "last_state"):
        assert (folder / "best" / name).exists(), name
    config = load_yaml_with_include(cfg)
    config["training"]["scheduler"]["n_epochs"] = 2
    cfg2 = _write(config, tmp / "closed2.yaml")
    assert _run("dasm_train", cfg2, folder, "--resume_ckpt", "auto") == 0
    log = (folder / "log.txt").read_text()
    assert "resumed from" in log and "(epoch 1)" in log and "epoch 2: train" in log


def test_dasm_ov_then_openset_eval_stages(closed_run, mini_audioset):
    """dasm_ov on the shipped open_vocab.yaml from the closed-set
    best_student, with ``query_type: text`` (the reference's fault), then
    openset_eval with the novel labels and queries."""
    tmp, _ = closed_run
    config = _stage_config(mini_audioset, "dasm/open_vocab.yaml")
    for key in ("train_kwargs", "val_kwargs", "test_kwargs"):
        config["DASM"][key] = {"temp_w": 0.1, "query_type": "text"}
    r = str(mini_audioset)
    config["dataset"].update(openset_label=f"{r}/novel.json",
                             openset_embedding=f"{r}/novel_text.npy", query_bank=f"{r}/text.npy",
                             openset_tsv=f"{r}/val.tsv", openset_dur=f"{r}/val_dur.tsv",
                             openset_folder=f"{r}/val")
    cfg = _write(config, tmp / "ov.yaml")
    best = str(tmp / "closed" / "best" / "best_student")
    assert _run("dasm_ov", cfg, tmp / "ov", "--pretrained_ckpt", best) == 0
    log = (tmp / "ov" / "log.txt").read_text()
    assert "at_mAP" in log and "psds_rare" in log and "warm start" in log
    assert _run("openset_eval", cfg, tmp / "open", "--pretrained_ckpt",
                str(tmp / "ov" / "best" / "best_student")) == 0
    single = json.loads((tmp / "open" / "single_psds.json").read_text())
    assert set(single) <= set(LABELS + NOVEL) and "openset psds=" in (
        tmp / "open" / "log.txt").read_text()


def test_audioset_supervised_stage(mini_audioset, tmp_path):
    cfg = _write(_stage_config(mini_audioset, "audioset_strong/passt_cnn.yaml"),
                 tmp_path / "sup.yaml")
    assert _run("audioset_supervised", cfg, tmp_path / "sup") == 0
    assert "psds_common" in (tmp_path / "sup" / "log.txt").read_text()
    assert (tmp_path / "sup" / "best" / "last_state").exists()


def test_serve_and_infer_with_queries(closed_run, mini_audioset, tmp_path, capsys):
    """``recipes.serve`` with ``--query`` (a text bank, ``--query_names``)
    equals the engine's scores with the same query; ``recipes.infer`` takes
    ``--query``; the row count and the exported path are checked first."""
    tmp, cfg = closed_run
    ckpt = str(tmp / "closed" / "best" / "best_student")
    r = mini_audioset
    (r / "names.txt").write_text("\n".join(["a", "b", "c", "d"]) + "\n")
    common = ["--config_dir", cfg, "--ckpt", ckpt, "--device", "cpu", "--batch_size", "3"]
    assert serve.main(common + ["--wav_dir", str(r / "val"), "--out_dir", str(tmp_path / "s"),
                                "--query", str(r / "text.npy"), "--query_names",
                                str(r / "names.txt")]) == 0
    engine = cli.serving_engine(load_yaml_with_include(cfg), ckpt, torch.device("cpu"), 3,
                                labels=["a", "b", "c", "d"],
                                model_kwargs={"query": np.load(r / "text.npy"),
                                              "query_type": "text"})
    (tmp_path / "e").mkdir()
    lines = serve.score_directory(engine, str(r / "val"), str(tmp_path / "e"), 3, 0)
    assert (tmp_path / "s" / "events.jsonl").read_text() == "".join(ln + "\n" for ln in lines)
    for tsv in (tmp_path / "e").glob("*.tsv"):
        assert (tmp_path / "s" / tsv.name).read_text() == tsv.read_text()
    assert (tmp_path / "s" / "v0.tsv").read_text().startswith("onset\toffset\ta\tb\tc\td")
    capsys.readouterr()
    with pytest.raises(SystemExit):
        serve.main(common + ["--wav_dir", str(r / "val"), "--out_dir", str(tmp_path / "x"),
                             "--query", str(r / "novel_text.npy")])
    assert "--query has 2 rows but the class list has 4" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--exported", "m.pt2", "--query", "q.npy", "--wav_dir", ".", "--out_dir",
                    ".", "--device", "cpu"])
    assert "--exported artifacts have their query baked in" in capsys.readouterr().err
    assert infer.main(["--config_dir", cfg, "--ckpt", ckpt, "--device", "cpu", "--wav",
                       str(r / "val" / "v0.wav"), "--query", str(r / "audio.npy"),
                       "--query_type", "audio"]) == 0
    assert len(json.loads(capsys.readouterr().out)["weak"]) == 4


# -- against the JAX programs of the worker threads ---------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dasm_forward_matches_jax(jax_side, variant):
    port = _port(variant).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(mel(2, 3)), **{
            k: (torch.from_numpy(v) if k == "pad_mask" else v)
            for k, v in forward_kwargs(variant).items()})
    want = jax_side["forward"].result()[variant]
    assert set(want) == {f for f in ("strong", "weak", "at_out") if getattr(got, f) is not None}
    for f, w in want.items():
        np.testing.assert_allclose(getattr(got, f).numpy(), w, atol=ATOL_FORWARD, err_msg=f)
    assert (got.strong[1, :, 90:] == 1e-7).all()  # the padded frames, clamped


def test_closed_set_trajectory_matches_jax(jax_side):
    """Three ``DASMStep`` steps against ``make_dasm_step``: two query
    modalities drawn per query, the (C+1)-way CE, mixup, shift and filt_aug,
    the AT decoder's dropout: each step's losses, then the end parameters."""
    port, start = _run_steps(jax_side, "closed", 3)
    assert not torch.equal(port.query_projector[1][0].weight, start["query_projector.1.0.weight"])


def test_open_vocab_step_with_learnable_queries_matches_jax(jax_side):
    """One open-vocabulary step: the labels of the common classes, the
    common slice of ``at_query`` taken inside the loss (its rows move, the
    rare row keeps its value but for the decay of AdamW), the 'query' and
    'at_decoder' groups."""
    port, start = _run_steps(jax_side, "open_vocab", 1)
    moved = (port.at_query.detach() - start["at_query"]).abs().amax(1)
    assert moved[0] > 0 and moved[2] > 0 and moved[1] == 0  # no decay in the query group


def test_open_vocab_step_with_a_projector_model_matches_jax(jax_side):
    """One open-vocabulary step on ``config/dasm/open_vocab.yaml``'s network
    (text and audio projectors, the sigmoid head) as ``dasm_ov`` runs it with
    ``query_type: text``: ``OVDASMTrainer``'s step fed the common rows of
    the one text bank, against ``make_dasm_step`` with
    ``query_from_params=False`` and the same rows; the text projector takes
    the gradient, the audio one none."""
    port, start = _run_steps(jax_side, "open_vocab_text", 1)
    np.testing.assert_array_equal(case_query("open_vocab_text"), banks()[0][[0, 2]])
    assert not torch.equal(port.query_projector[0][0].weight, start["query_projector.0.0.weight"])
    assert port.query_projector[1][0].weight.grad is None or not port.query_projector[1][
        0].weight.grad.any()
