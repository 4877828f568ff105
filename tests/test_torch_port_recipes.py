"""The port's MAT-SED recipes (``recipes/common.py``, ``recipes/matsed.py``,
``recipes/cli.py``, ``utils/checkpoint.py``, ``utils/logging.py`` and
gradient accumulation) held against the JAX package on the CPU.

Config mappings on the shipped YAMLs, optimizer groups and schedule values,
accumulation against ``optax.MultiSteps``, warm-start drop lists,
checkpoint round trips, best-model decisions, the test stage on weights
carried from JAX, and the stage chain (pretrain -> finetune -> test) on a
mini DESED of 1.2-s clips with a tiny PaSST_SED; a resumed run equals the
uninterrupted one bitwise. Everything is float32.
"""

import concurrent.futures
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from transformer4sed_tpu.frontend import PasstFrontend as JaxFrontend
from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxPaSST_SED
from transformer4sed_tpu.recipes import common as jax_common
from transformer4sed_tpu.recipes import matsed as jax_matsed
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu.utils import checkpoint as jax_checkpoint
from transformer4sed_tpu.utils import logging as jax_logging
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.data import audio_io, datasets
from transformer4sed_tpu_torch.data.loader import DataLoader, collate
from transformer4sed_tpu_torch.data.tsv import write_tsv
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.recipes import cli, common, matsed
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils import checkpoint, logging as port_logging
from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
from transformer4sed_tpu_torch.utils.weights import (
    init_weights_,
    jax_params_to_state_dict,
    load_jax_params,
)
from transformer4sed_tpu_torch.utils.yamlio import safe_dump
from tests.torch_port_jax import jit0

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "config").glob("*/*.yaml"))
SR = 32000
CLIP_SECONDS = 1.2
N_SAMPLES = int(SR * CLIP_SECONDS)
CLASSES = ["beep", "noise"]
TINY = dict(class_num=2, embed_dim=32, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
            decoder_num_heads=4, at_adapter_heads=4, passt_feature_layer=2,
            decoder="transformerXL", decoder_layer_num=1, decoder_pos_emd_len=120)
MLM_DICT = {"mask_rate": 0.75, "mask_style": [0.8, 0.1, 0.1], "strategy": "block",
            "block_width": 4, "out_dim": 32}
# optax's and torch's AdamW on the same f32 gradients: the same formulas in
# another order (bias corrections, eps), a few f32 ulps of the O(1) params
# apart after two applied steps
ACCUM_RTOL, ACCUM_ATOL = 1e-6, 1e-6
# PSDS of the same clips scored by the JAX and the port f32 forwards (scores
# a few ulps apart; the PSDS sweep's thresholds are the scores themselves)
PSDS_ATOL = 1e-6


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    """The TensorBoard writer without TensorFlow (its import costs seconds
    here and the writer does not need it)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def tone(n=N_SAMPLES, amp=0.3):
    return (amp * np.sin(2 * np.pi * 880 * np.arange(n) / SR)).astype(np.float32)


@pytest.fixture(scope="module")
def mini_desed(tmp_path_factory):
    """Synthetic DESED layout: 'beep' = 880 Hz tone events on a noise floor
    (the pattern of tests/test_recipes_e2e.py::mini_desed)."""
    root = tmp_path_factory.mktemp("mini_desed")
    rng = np.random.RandomState(0)

    def write(folder, name, wav):
        (root / folder).mkdir(exist_ok=True)
        wavfile.write(root / folder / name, SR, (wav * 32767).astype(np.int16))

    def noise(scale=0.02):
        return rng.randn(N_SAMPLES).astype(np.float32) * scale

    events = ["filename", "onset", "offset", "event_label"]
    rows = []
    for i in range(4):
        wav = noise()
        wav[int(0.3 * SR):int(0.9 * SR)] += tone(int(0.6 * SR))
        write("strong", f"s{i}.wav", wav)
        rows.append((f"s{i}.wav", 0.3, 0.9, "beep"))
    write_tsv(str(root / "strong.tsv"), events, rows)
    rows = []
    for i in range(2):
        wav = noise()
        wav[:N_SAMPLES // 2] += tone(N_SAMPLES // 2)
        write("synth", f"y{i}.wav", wav)
        rows.append((f"y{i}.wav", 0.0, CLIP_SECONDS / 2, "beep"))
    write_tsv(str(root / "synth.tsv"), events, rows)
    rows = []
    for i in range(4):
        write("weak", f"w{i}.wav", noise() + tone() * (i % 2))
        rows.append((f"w{i}.wav", "beep" if i % 2 else "noise"))
    write_tsv(str(root / "weak.tsv"), ["filename", "event_labels"], rows)
    for i in range(4):
        write("unlabeled", f"u{i}.wav", noise(0.05))
    rows, durations = [], []
    for i in range(4):
        wav = noise()
        on = 0.1 + 0.2 * i
        wav[int(on * SR):int((on + 0.4) * SR)] += tone(int(0.4 * SR))
        write("val", f"v{i}.wav", wav)
        rows.append((f"v{i}.wav", on, on + 0.4, "beep"))
        durations.append((f"v{i}.wav", CLIP_SECONDS))
    write_tsv(str(root / "val.tsv"), events, rows)
    write_tsv(str(root / "val_dur.tsv"), ["filename", "duration"], durations)
    return root


def finetune_config(root, n_epochs=2):
    r = str(root)
    return {
        "generals": {"val_interval": 1, "num_workers": 2,
                     "warm_start_drop": ["classifier", "at_head", "at_pool"]},
        "model_name": "PaSST_SED",
        "feature": {"pred_len": 120, "sr": SR, "hopsize": 320, "n_fft": 1024,
                    "audio_max_len": CLIP_SECONDS, "net_subsample": 1},
        "dataset": {"labels": CLASSES, "strong_folder": f"{r}/strong",
                    "strong_tsv": f"{r}/strong.tsv", "weak_folder": f"{r}/weak",
                    "weak_tsv": f"{r}/weak.tsv", "unlabeled_folder": f"{r}/unlabeled",
                    "val_folder": f"{r}/val", "val_tsv": f"{r}/val.tsv",
                    "val_dur": f"{r}/val_dur.tsv"},
        "synth_dataset": {"synth_train_folder": f"{r}/synth",
                          "synth_train_tsv": f"{r}/synth.tsv"},
        "training": {
            "batch_size": [1, 1, 2, 2], "batch_size_val": 3, "clip_grad": True,
            "scheduler": {"n_epochs": n_epochs, "n_epochs_cut": 1, "exponent": -1,
                          "lr_warmup_epochs": 0, "lr_warmup_rate": 0.1},
            "self_loss_warmup": 1, "cons_scheduler_name": "Linear", "ema_factor": 0.999,
            "w_weak": 0.5, "w_cons_max": 2, "w_cons_min": 0, "w_weak_cons": 0.5, "w_AT": 2,
            "filter_type": "median", "median_window": [5, 5], "weak_mask": True,
            "transform": {"n_transform": 2, "choice": [1, 0, 0, 0], "filter_db_range": [-6, 6],
                          "filter_bands": [2, 5], "filter_minimum_bandwidth": 4,
                          "filter_type": "step"},
        },
        "PaSST_SED": {"init_kwargs": {**TINY, "at_adapter": True},
                      "train_stu_kwargs": {"temp_w": 1}, "train_tch_kwargs": {"temp_w": 1},
                      "val_kwargs": {"temp_w": 0.5}, "test_kwargs": {"temp_w": 0.5}},
        "opt": {"param_groups": {
            "encoder": {"lr": 1.0e-4, "weight_decay": 1.0e-4, "freeze_layer": 0, "step_lr": 1},
            "decoder": {"lr": 1.0e-3, "weight_decay": 1.0e-4},
            "head": {"lr": 1.0e-3, "weight_decay": 1.0e-4}}},
        "backbone_depth": 2,
    }


def pretrain_config(root):
    cfg = finetune_config(root, n_epochs=1)
    cfg["training"]["batch_size"] = [1, 1, 2]
    cfg["training"]["transform"]["n_transform"] = 1
    cfg["PaSST_SED"] = {"init_kwargs": {**TINY, "mlm": True, "mlm_dict": MLM_DICT},
                        "train_kwargs": {}}
    cfg["opt"]["param_groups"]["encoder"]["lr"] = 0
    return cfg


def write_config(path, cfg):
    path.write_text(safe_dump(cfg))
    return str(path)


def run_stage(stage, cfg_path, folder, *extra):
    return cli.main([stage, "--config_dir", cfg_path, "--save_folder", str(folder),
                     "--device", "cpu", *extra])


def logged_test_results(folder):
    """The last ``test (...)`` line of a stage's log.txt as a dict."""
    lines = [ln for ln in (Path(folder) / "log.txt").read_text().splitlines()
             if "INFO test (" in ln]
    return {k: float(v) for k, v in re.findall(r"'(\w+)': ([-0-9.e]+)", lines[-1])}


# -- config mappings ------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_config_mappings_match_jax_on_shipped_configs(path):
    """``model_init_kwargs``, ``lora_ckpt_merged``, ``codec_from_config`` and
    ``median_filter_from_config`` equal the JAX ones (or raise the same
    error) on every shipped config."""
    cfg = load_yaml_with_include(str(path))
    assert common.model_init_kwargs(cfg) == jax_common.model_init_kwargs(cfg)
    for choice in (None, "merged", "unmerged"):
        assert common.lora_ckpt_merged(cfg, choice) == jax_common.lora_ckpt_merged(cfg, choice)
    labels = cfg.get("dataset", {}).get("labels") or ["a", "b", "c"]
    codec = common.codec_from_config(cfg, labels)
    jcodec = jax_common.codec_from_config(cfg, labels)
    assert (codec.labels, codec.audio_len, codec.frame_len, codec.frame_hop, codec.net_pooling,
            codec.sr, codec.n_frames) == (jcodec.labels, jcodec.audio_len, jcodec.frame_len,
                                          jcodec.frame_hop, jcodec.net_pooling, jcodec.sr,
                                          jcodec.n_frames)
    outcome = []
    for fn, c in ((common.median_filter_from_config, codec),
                  (jax_common.median_filter_from_config, jcodec)):
        try:
            outcome.append(fn(cfg, c))
        except KeyError as e:
            outcome.append(f"KeyError {e}")
    assert outcome[0] == outcome[1]


class _Loader(list):
    """A stand-in train loader: its length and one batch of its sampler."""

    def __init__(self, n, batch):
        super().__init__(range(n))
        self.batch_sampler = [list(range(batch))]


@pytest.mark.parametrize("name", ["finetune1", "finetune2", "pretrain"])
def test_trainer_configs_match_jax(name, monkeypatch):
    """``MATSEDTrainer.mt_cfg`` and the MLM trainer's ``MLMConfig`` on the
    shipped MAT-SED configs, the JAX trainers built from given init params
    (no model, no step compiled, no validation table read)."""
    cfg = load_yaml_with_include(str(ROOT / "config" / "mat-sed" / f"{name}.yaml"))
    for table in ("load_ground_truth", "load_durations"):  # read by the constructor, not mapped
        monkeypatch.setattr(jax_common, table, lambda path: {})
    codec = jax_common.codec_from_config(cfg)
    steps = 7
    params = {"classifier": {"kernel": jnp.zeros((2, 2)), "bias": jnp.zeros(2)}}
    if name == "pretrain":
        seen = {}
        real = jax_matsed.make_mlm_step

        def capture(model_apply, frontend, optimizer, mlm_cfg, **kw):
            seen["cfg"] = mlm_cfg
            return real(model_apply, frontend, optimizer, mlm_cfg, **kw)

        monkeypatch.setattr(jax_matsed, "make_mlm_step", capture)

        class MLMModel:
            mlm = True

        jax_matsed.MLMTrainer(MLMModel(), None, cfg, _Loader(steps, 24), None,
                              jax_logging.Logger(), init_params=params, init_model_state={})
        want = {k: getattr(seen["cfg"], k) for k in vars(seen["cfg"])}
        got = matsed.mlm_config(cfg)
        assert {k: getattr(got, k) for k in want} == want
        return
    jt = jax_matsed.MATSEDTrainer(None, None, cfg, codec, _Loader(steps, 12), None, None,
                                  jax_logging.Logger(), init_params=params, init_model_state={})
    got = matsed.mean_teacher_config(cfg, common.codec_from_config(cfg), steps)
    want = {k: getattr(jt.mt_cfg, k) for k in vars(jt.mt_cfg)}
    assert {k: getattr(got, k) for k in want} == want


# -- optimizer, schedule, accumulation ------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_groups_and_schedule_match_jax(accum, monkeypatch):
    """Every param's group label and the schedule's values at the warm-up,
    the plateau and the decay equal JAX's ``optimizer_from_config`` on a
    tiny PaSST_SED, at ``accum_steps`` 1 and 2 (the horizon in applied
    steps)."""
    cfg = load_yaml_with_include(str(ROOT / "config" / "mat-sed" / "finetune1.yaml"))
    cfg["training"]["accum_steps"] = accum
    cfg["training"]["scheduler"]["lr_warmup_epochs"] = 1
    for group in ("encoder", "decoder"):  # live encoder (step_lr 4) and decoder groups too
        cfg["opt"]["param_groups"][group]["lr"] = 1e-4
    cfg["backbone_depth"] = 2
    model = PaSST_SED(**TINY, at_adapter=True, device="cpu")
    tree, _ = convert_torch_checkpoint({k: v.numpy() for k, v in model.state_dict().items()},
                                       "PaSST_SED", init_kwargs={**TINY, "at_adapter": True})
    schedules = []
    real = jax_common.schedules.exponential_down

    def capture(*a, **k):
        schedules.append(real(*a, **k))
        return schedules[-1]

    monkeypatch.setattr(jax_common.schedules, "exponential_down", capture)
    tx, jax_labels = jax_common.optimizer_from_config(tree, cfg, steps_per_epoch=6)
    assert isinstance(tx, optax.MultiSteps) == (accum > 1)
    pg, schedule, k = common.optimizer_from_config(cfg, steps_per_epoch=6)
    _, _, labels = optim.build_optimizer(model, pg, schedule)
    assert k == accum
    # each JAX leaf filled with its label's code, carried to port names by
    # the weights mapping (an attention's four parts concatenate: one code)
    codes = sorted(set(jax.tree_util.tree_leaves(jax_labels)))
    coded = jax.tree_util.tree_map(lambda lab, x: np.full(np.shape(x), codes.index(lab),
                                                          np.float32), jax_labels, tree)
    want = {}
    for name, arr in jax_params_to_state_dict(coded).items():
        assert np.unique(arr).size == 1, name
        want[name] = codes[int(arr.flat[0])]
    assert want == labels
    assert set(labels.values()) >= {"encoder_low", "encoder_high", "decoder", "head"}
    for step in (0, 1, 2, 3, 5, 6, 10, 20, 29, 40):
        assert schedule(step) == pytest.approx(float(schedules[0](step)), rel=1e-6), step


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for name, v in values.items():
            self.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))


def test_accumulation_matches_optax_multisteps():
    """k = 2 over four micro-batches with clipping active (the averaged
    gradient's norm above the limit) and a schedule that moves every applied
    step: the params after each micro-step equal ``optax.MultiSteps`` over
    the JAX package's AdamW chain on the same gradients."""
    rng = np.random.RandomState(0)
    values = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in values.items()}
             for _ in range(4)]
    spec = optim.GroupSpec(lr=1e-2, weight_decay=1e-4)
    schedule = common.schedules.exponential_down(start_iter=0, total_iter=2, exponent=-1.0)
    pg = optim.ParamGroupConfig(encoder=spec, decoder=spec, head=spec, clip_grad=1.0)
    module = _Params(values)
    opt, sched, labels = optim.build_optimizer(module, pg, schedule)
    assert set(labels.values()) == {"head"}
    acc = optim.GradientAccumulator(2)
    jspec = jax_optim.GroupSpec(lr=1e-2, weight_decay=1e-4)
    jtx, _ = jax_optim.build_optimizer(
        values, jax_optim.ParamGroupConfig(encoder=jspec, decoder=jspec, head=jspec,
                                           clip_grad=1.0),
        schedule=jax_common.schedules.exponential_down(start_iter=0, total_iter=2,
                                                       exponent=-1.0))
    jtx = optax.MultiSteps(jtx, every_k_schedule=2)
    jparams = {k: jnp.asarray(v) for k, v in values.items()}
    state = jit0(jtx.init)(jparams)
    update = jit0(jtx.update)
    applied = []
    for g in grads:
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        applied.append(optim.apply_gradients(opt, sched, pg.clip_grad, acc))
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[name]),
                                       rtol=ACCUM_RTOL, atol=ACCUM_ATOL, err_msg=name)
    assert applied == [False, True, False, True]
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in values}
    assert np.sqrt(sum(np.sum(v ** 2) for v in mean.values())) > pg.clip_grad  # clipping ran
    assert sched.last_epoch == 2


def test_accumulated_trainer_gates_ema_and_step_count():
    """A mean-teacher trainer at ``accum_steps`` 2: the teacher, the step
    count and the schedule move only on the second step; at 1 the step is
    today's (every call applies)."""
    from transformer4sed_tpu_torch.parallel import dryrun

    from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherTrainer

    setup = dryrun.mean_teacher_setup(1)
    trainer = MeanTeacherTrainer(dryrun.mean_teacher_model(), setup["frontend"], setup["cfg"],
                                 setup["pg"], setup["schedule"], accum_steps=2)
    teacher0 = [p.detach().clone() for p in trainer.teacher.parameters()]
    student0 = [p.detach().clone() for p in trainer.student.parameters()]
    trainer.step(setup["batch"], dryrun.step_generator(1, 0))
    assert trainer.step_count == 0 and trainer.scheduler.last_epoch == 0
    assert all(torch.equal(a, b) for a, b in zip(teacher0, trainer.teacher.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(student0, trainer.student.parameters()))
    trainer.step(setup["batch"], dryrun.step_generator(1, 1))
    assert trainer.step_count == 1 and trainer.scheduler.last_epoch == 1
    assert not all(torch.equal(a, b) for a, b in zip(teacher0, trainer.teacher.parameters()))


# -- warm starts, checkpoints, best models --------------------------------------------


@pytest.mark.parametrize("config", ["mat-sed/finetune1", "pmam/finetune1"])
def test_load_partial_drops_what_jax_drops(config):
    """The shipped drop list (JAX paths) drops the same leaves from a tiny
    PaSST_SED with the MLM head and the AT adapter in both packages; every
    other leaf is copied."""
    drop = load_yaml_with_include(str(ROOT / "config" / f"{config}.yaml"))["generals"][
        "warm_start_drop"]
    kwargs = {**TINY, "at_adapter": True, "mlm": True, "mlm_dict": MLM_DICT}
    model = init_weights_(PaSST_SED(**kwargs, device="cpu"), seed=1)
    own = model.state_dict()
    restored = {k: v + 1.0 for k, v in own.items()}
    merged = checkpoint.load_partial(own, restored, drop)
    kept = {k for k in own if torch.equal(merged[k], own[k])}
    assert all(torch.equal(merged[k], restored[k]) for k in own if k not in kept)
    assert sorted(kept) == checkpoint.dropped_keys(own, restored, drop)

    tree, _ = convert_torch_checkpoint({k: v.numpy() for k, v in own.items()}, "PaSST_SED",
                                       init_kwargs=kwargs)
    jax_restored = jax.tree_util.tree_map(lambda x: x + 1.0, tree)
    jmerged = jax_checkpoint.load_partial(tree, jax_restored, drop)
    same = jax.tree_util.tree_map(  # 1 where JAX kept the leaf, carried to port names
        lambda a, b: np.full(np.shape(a), float(np.array_equal(a, b)), np.float32), tree, jmerged)
    jkept = {k for k, v in jax_params_to_state_dict(same).items() if v.min() == 1.0}
    assert kept == jkept and kept


def test_checkpoint_round_trip_is_bitwise_with_backup_and_resume(tmp_path):
    """A mean-teacher train state with accumulation buffers half full: saved,
    saved again (the first becomes ``.prev``), restored into a fresh trainer
    bitwise; ``resolve_resume('auto')`` takes ``last_state``, then the
    backup when it is gone, then nothing."""
    from transformer4sed_tpu_torch.parallel import dryrun
    from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherTrainer

    setup = dryrun.mean_teacher_setup(1)

    def fresh():
        return MeanTeacherTrainer(dryrun.mean_teacher_model(), setup["frontend"], setup["cfg"],
                                  setup["pg"], setup["schedule"], accum_steps=2)

    trainer = fresh()
    for s in range(3):
        trainer.step(setup["batch"], dryrun.step_generator(1, s))
    paths = {"best_paths": str(tmp_path)}
    args = type("Args", (), {"resume_ckpt": "auto"})()
    logger = port_logging.Logger()
    assert common.resolve_resume(args, paths, logger) is None
    checkpoint.save_checkpoint(f"{tmp_path}/last_state", {"marker": torch.zeros(1)})
    checkpoint.save_checkpoint(f"{tmp_path}/last_state", trainer.state_dict())
    assert torch.load(f"{tmp_path}/last_state.prev")["marker"].shape == (1,)
    assert common.resolve_resume(args, paths, logger) == f"{tmp_path}/last_state"
    other = checkpoint.restore_checkpoint(common.resolve_resume(args, paths, logger), fresh())
    saved = torch.load(f"{tmp_path}/last_state")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}/{i}").items()}
        return {prefix: tree}

    got, want = flat(other.state_dict()), flat(saved)
    assert got.keys() == want.keys() and len(want) > 50
    for k, v in want.items():
        assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v), k
    assert other.accumulator.mini_step == 1 and other.step_count == 1
    (tmp_path / "last_state").unlink()
    assert common.resolve_resume(args, paths, logger) == f"{tmp_path}/last_state.prev"
    args.resume_ckpt = "/explicit"
    assert common.resolve_resume(args, paths, logger) == "/explicit"


def test_best_models_decide_and_record_as_jax(tmp_path, monkeypatch):
    """One metric sequence through both trackers: the same improvement
    decisions and best epoch at every update, the same ``best_metric.json``
    after the flush, the best epoch's weights on disk, and resumed trackers
    that keep the earlier best. (The JAX tracker's orbax writes are recorded,
    not made: the first costs seconds here.)"""
    saved = []
    monkeypatch.setattr(jax_checkpoint, "save_params", lambda path, tree: saved.append(
        (Path(path).name, np.asarray(tree["w"]).tolist())))
    metrics = [0.1, 0.3, 0.2, 0.3, 0.5, 0.4]
    ours = port_logging.BestModels(str(tmp_path / "port"), flush_every=len(metrics))
    theirs = jax_logging.BestModels(str(tmp_path / "jax"), flush_every=len(metrics))
    for epoch, m in enumerate(metrics):
        sd = {"w": torch.full((2,), float(epoch))}
        assert ours.update(epoch, m, sd, sd) == theirs.update(epoch, m, {"w": np.full(2, epoch)})
        assert (ours.best_metric, ours.best_epoch) == (theirs.best_metric, theirs.best_epoch)
    for name in ("port", "jax"):  # the sixth update flushed
        assert json.loads((tmp_path / name / "best_metric.json").read_text()) == {
            "metric": 0.5, "epoch": 4}
    assert saved == [("best_student", [4, 4])]
    ours.flush()
    assert checkpoint.restore_params(str(tmp_path / "port" / "best_teacher"))["w"].tolist() == [
        4.0, 4.0]
    again = port_logging.BestModels(str(tmp_path / "port"))
    jagain = jax_logging.BestModels(str(tmp_path / "jax"))
    assert (again.best_metric, again.best_epoch) == (jagain.best_metric, jagain.best_epoch)
    assert again.update(6, 0.45, {"w": torch.zeros(2)}) is jagain.update(6, 0.45, {"w": 0}) is False


def test_batch_decode_loader_equals_the_per_file_loader(mini_desed):
    """The loader (one ``load_wav_batch`` call a batch) gives the batches
    that the datasets' items decoded file by file give, over a concatenation
    of datasets."""
    codec = common.codec_from_config(finetune_config(mini_desed))
    sources = [datasets.UnlabeledDataset(str(mini_desed / d), True, codec)
               for d in ("weak", "unlabeled")]
    items = [(ds, i) for ds in sources for i in range(len(ds))]
    per_file = [collate([ds[i] for ds, i in items[j:j + 3]]) for j in range(0, len(items), 3)]
    before = audio_io.BATCHES["native"] + audio_io.BATCHES["python"]
    loaded = list(DataLoader(sources, batch_size=3, drop_last=False, num_workers=2))
    assert audio_io.BATCHES["native"] + audio_io.BATCHES["python"] - before == len(per_file)
    assert len(loaded) == len(per_file)
    for a, b in zip(per_file, loaded):
        assert a.keys() == b.keys() and a["filename"] == b["filename"]
        for k in ("wav", "label", "pad_mask", "idx"):
            np.testing.assert_array_equal(a[k], b[k])


# -- the stages ------------------------------------------------------------------------


class _JitFrontend:
    """The JAX frontend's two calls, each compiled once (tests/torch_port_jax.py)."""

    def __init__(self, frontend):
        self.call, self.normalize = jit0(frontend.__call__), jit0(frontend.normalize)

    def __call__(self, wav):
        return self.call(wav)


def _jax_test_stage(root, folder):
    """The JAX side of the shared-weights test: a JAX param tree (carried from
    a seeded port init by the JAX package's importer), the config and the
    port checkpoint made from the tree by ``load_jax_params``, and the JAX
    ``MATSEDTrainer``'s ``validation(0)`` and ``test()`` on those weights."""
    cfg = finetune_config(root)
    cfg["generals"]["warm_start_drop"] = []
    cfg["training"]["batch_size_val"] = 4  # one batch: one JAX compile of each program
    cfg_path = write_config(folder / "ft.yaml", cfg)
    init = init_weights_(PaSST_SED(**TINY, at_adapter=True, device="cpu"), seed=3)
    params, _ = convert_torch_checkpoint({k: v.numpy() for k, v in init.state_dict().items()},
                                         "PaSST_SED", init_kwargs={**TINY, "at_adapter": True})
    model = load_jax_params(PaSST_SED(**TINY, at_adapter=True, device="cpu"), params)
    ckpt = checkpoint.save_params(str(folder / "jax_weights"), model.state_dict())

    jcodec = jax_common.codec_from_config(cfg)
    loaders = jax_common.desed_dataset_setting(cfg, jcodec, 42)
    jmodel = JaxPaSST_SED(**TINY, at_adapter=True)
    jt = jax_matsed.MATSEDTrainer(jmodel, _JitFrontend(JaxFrontend()), cfg, jcodec, *loaders,
                                  jax_logging.Logger(), init_params=params, init_model_state={})
    kwargs = cfg["PaSST_SED"]["val_kwargs"]
    assert cfg["PaSST_SED"]["test_kwargs"] == kwargs
    jt._eval_fns["val_kwargs"] = jt._eval_fns["test_kwargs"] = jit0(
        lambda p, ms, m, pm: jt.model_apply(p, m, train=False, pad_mask=pm, **kwargs))
    return cfg_path, ckpt, jt.validation(0), jt.test()


@pytest.fixture(scope="module")
def jax_test_stage(mini_desed, tmp_path_factory):
    """:func:`_jax_test_stage` on a worker thread, started with the stage
    fixtures: JAX compiles and scores alongside the port's stages."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_jax_test_stage, mini_desed, tmp_path_factory.mktemp("jax_weights"))
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def pretrained(mini_desed, tmp_path_factory, jax_test_stage):
    """One ``matsed_pretrain`` run: its save folder."""
    folder = tmp_path_factory.mktemp("pretrain")
    cfg = write_config(folder / "pretrain.yaml", pretrain_config(mini_desed))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        assert run_stage("matsed_pretrain", cfg, folder / "run") == 0
    return folder / "run"


@pytest.fixture(scope="module")
def two_epochs(mini_desed, pretrained, tmp_path_factory):
    """``matsed_finetune`` for 2 epochs in one run, warm-started from the
    pretrain's best student: its save folder."""
    folder = tmp_path_factory.mktemp("finetune")
    cfg = write_config(folder / "finetune.yaml", finetune_config(mini_desed))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        assert run_stage("matsed_finetune", cfg, folder / "run", "--pretrained_ckpt",
                         str(pretrained / "best" / "best_student")) == 0
    return folder / "run"


def test_pretrain_stage_writes_its_best_student(pretrained):
    best = checkpoint.restore_params(str(pretrained / "best" / "best_student"))
    assert "mask_token" in best and "mlm_mlp.0.weight" in best
    assert all(torch.isfinite(v).all() for v in best.values())
    log = (pretrained / "log.txt").read_text()
    assert re.search(r"epoch 1: train [0-9.]+ val [0-9.]+", log)
    assert (pretrained / "config.yaml").exists()


def test_finetune_stage_warm_starts_validates_and_checkpoints(two_epochs, pretrained):
    """The files the JAX stage writes, the warm start's drops, one validation
    line an epoch with finite PSDS and F1s for student and teacher, and a
    test line."""
    best = two_epochs / "best"
    for name in ("best_student", "best_teacher", "best_metric.json", "last_state",
                 "last_state.prev"):
        assert (best / name).exists(), name
    assert (two_epochs / "tensorboard").is_dir() and (two_epochs / "config.yaml").exists()
    log = (two_epochs / "log.txt").read_text()
    assert "warm-started from" in log and "dropped ['classifier.bias', 'classifier.weight']" in log
    vals = re.findall(r"val epoch (\d): (.*)", log)
    assert [e for e, _ in vals] == ["1", "2"]
    for _, line in vals:
        got = dict(re.findall(r"(\S+)=([-0-9.na]+)", line))
        assert set(got) == {f"{m}/{t}" for m in ("psds1", "psds2", "event_f1", "weak_f1")
                            for t in "st"}
        assert all(np.isfinite(float(v)) for v in got.values())
    assert set(logged_test_results(two_epochs)) == {"psds1", "psds2"}
    state = torch.load(best / "last_state")
    assert state["step"] == 4 and state["accum"] is None
    assert torch.load(best / "last_state.prev")["step"] == 2
    keys = set(PaSST_SED(**TINY, at_adapter=True, device="cpu").state_dict())
    for name in ("best_student", "best_teacher"):
        assert set(checkpoint.restore_params(str(best / name))) == keys


def test_resumed_run_equals_the_uninterrupted_one_bitwise(mini_desed, pretrained, two_epochs,
                                                          tmp_path):
    """1 epoch, then ``--resume_ckpt auto`` to 2 epochs: the final train state
    equals the 2-epoch run's bitwise (the schedule's plateau covers epoch 1,
    each step's generator comes from (seed, step) alone)."""
    one = write_config(tmp_path / "one.yaml", finetune_config(mini_desed, n_epochs=1))
    two = write_config(tmp_path / "two.yaml", finetune_config(mini_desed, n_epochs=2))
    warm = ["--pretrained_ckpt", str(pretrained / "best" / "best_student")]
    assert run_stage("matsed_finetune", one, tmp_path / "run", *warm) == 0
    assert run_stage("matsed_finetune", two, tmp_path / "run", *warm, "--resume_ckpt",
                     "auto") == 0
    assert "at step 2 (epoch 1)" in (tmp_path / "run" / "log.txt").read_text()
    got = torch.load(tmp_path / "run" / "best" / "last_state")
    want = torch.load(two_epochs / "best" / "last_state")
    for part in ("student", "teacher"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for pid, st in want["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["optimizer"]["state"][pid][k], st[k])
    assert got["scheduler"] == want["scheduler"] and got["step"] == want["step"] == 4


def test_test_stage_on_the_finetuned_state(two_epochs):
    """``matsed_test --resume_ckpt auto`` on the finetune's folder: the
    teacher of ``last_state`` on the test split, as the last validation's
    teacher scored it (the same clips, filter and forward kwargs)."""
    cfg = str(two_epochs.parent / "finetune.yaml")
    assert run_stage("matsed_test", cfg, two_epochs, "--resume_ckpt", "auto") == 0
    log = (two_epochs / "log.txt").read_text()
    last_val = dict(re.findall(r"(\S+)=([-0-9.]+)", re.findall(r"val epoch 2: (.*)", log)[-1]))
    test = logged_test_results(two_epochs)
    assert test["psds1"] == pytest.approx(float(last_val["psds1/t"]), abs=1e-4)
    assert test["psds2"] == pytest.approx(float(last_val["psds2/t"]), abs=1e-4)


def test_stages_run_on_the_card_unless_asked_for_the_cpu(mini_desed, tmp_path):
    """Without ``--device cpu`` on a host without a card the stage raises
    before it writes anything; an orbax directory is refused by name; the
    JAX package's model that is not ported yet raises naming its queue item."""
    cfg = write_config(tmp_path / "ft.yaml", finetune_config(mini_desed))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["matsed_test", "--config_dir", cfg, "--save_folder", str(tmp_path / "x")])
        assert not (tmp_path / "x").exists()
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        run_stage("matsed_test", cfg, tmp_path / "y", "--pretrained_ckpt", str(tmp_path / "orbax"))
    for model, item in (("PasstComplexCNN", 9),):
        later = write_config(tmp_path / "later.yaml",
                             dict(finetune_config(mini_desed), model_name=model))
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            run_stage("matsed_test", later, tmp_path / "z")


def test_test_stage_with_jax_weights_matches_jax(jax_test_stage, tmp_path):
    """The same weights (a JAX param tree, carried by ``load_jax_params``):
    the JAX ``MATSEDTrainer``'s ``validation()`` and ``test()`` against the
    port trainer's ``validation()`` and ``cli.main(['matsed_test', ...])``:
    the same keys, PSDS1 and PSDS2 within ``PSDS_ATOL``, the F1s equal."""
    cfg_path, ckpt, want_val, want_test = jax_test_stage.result()

    assert run_stage("matsed_test", cfg_path, tmp_path / "run", "--pretrained_ckpt", ckpt) == 0
    got_test = logged_test_results(tmp_path / "run")
    stage = cli.setup(["matsed_test", "--config_dir", cfg_path, "--save_folder",
                       str(tmp_path / "run2"), "--device", "cpu", "--pretrained_ckpt", ckpt])
    got_val = cli.finetune_trainer(stage).validation(0)
    stage.logger.close()
    assert list(got_val) == list(want_val)
    for k, v in want_val.items():
        tol = PSDS_ATOL if k.startswith("psds") else 0.0
        assert got_val[k] == pytest.approx(float(v), abs=tol), k
    assert got_test.keys() == want_test.keys()
    for k, v in want_test.items():
        assert got_test[k] == pytest.approx(float(v), abs=PSDS_ATOL), k
