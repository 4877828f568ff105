"""Recipe CLI: ``python -m transformer4sed_tpu_torch.recipes.cli <stage> ...``
(port of ``recipes/cli.py``, the MAT-SED stages).

  matsed_pretrain  masked-reconstruction MLM (stage 1)
  matsed_finetune  mean-teacher semi-supervised fine-tune (stages 2-3;
                   finetune2 differs only by config: encoder_win)
  matsed_test      test with the median or max filter, or cSEBB

Stages hand off through ``--pretrained_ckpt`` (a checkpoint of the port's,
or an upstream ``.pt`` state dict) with the config's ``warm_start_drop``;
``--resume_ckpt auto`` resumes from ``best/last_state``. A stage runs on the
card, where the model computes in bf16 with f32 params, optimizer state and
EMA (``docs/PRECISION.md``); ``--device cpu`` runs it on the CPU in f32
throughout. The JAX package's other stages are not ported yet and raise,
naming their ROADMAP.md item.

:func:`build_model` is the one model builder; :func:`serving_model` (a
config and a checkpoint -> the model in eval mode, frontend, codec, median
widths, forward kwargs) serves the serve, infer, stream and export entry
points.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, NamedTuple

import torch

from transformer4sed_tpu_torch.recipes import common
from transformer4sed_tpu_torch.utils.device import resolve_device

MATSED_STAGES = ("matsed_pretrain", "matsed_finetune", "matsed_test")
# the JAX package's other stages and models, by their ROADMAP.md queue 1 item
_LATER_STAGES = {
    "pmam_extract": 8, "pmam_gmm": 8, "pmam_pseudo_labels": 8, "pmam_train": 8,
    "audioset_supervised": 9, "clap_train": 9,
    "dasm_train": 10, "dasm_ov": 10, "openset_eval": 10,
}
_LATER_MODELS = {"PasstComplexCNN": 9, "CLAP_SED": 9, "DASM_HTSAT": 9, "DASM": 10}


# upstream's spellings of the CNN branch's geometry (config/pmam/*.yaml)
_CNN_NAMES = {"kernel": "kernel_size", "pad": "padding"}


def _upstream_names(kwargs: Dict) -> Dict:
    """Constructor kwargs with upstream's names in the PMAM configs mapped to
    the port's: ``cnn_param``'s ``kernel`` / ``pad``, and ``f_pool_heads``
    dropped where it is the 6 heads of the attention f-pool
    (``models/passt_sed.py``; upstream reads it only to split its weights)."""
    kwargs = dict(kwargs)
    heads = kwargs.pop("f_pool_heads", 6)
    if heads != 6:
        raise ValueError(f"f_pool_heads={heads}: the attention f-pool has 6 heads")
    if isinstance(kwargs.get("cnn_param"), dict):
        kwargs["cnn_param"] = {_CNN_NAMES.get(k, k): v for k, v in kwargs["cnn_param"].items()}
    return kwargs


def build_model(config, device: torch.device):
    """(model, frontend) of the config's ``model_name`` for ``device``: f32
    params, computing in bf16 on the card (the kernels take bf16) and in f32
    on the CPU; built on the host with the constructor's weights until
    :func:`load_pretrained` fills and moves them."""
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.models.htsat import HTSATFrontend
    from transformer4sed_tpu_torch.models.htsat_heads import HTSAT_CNN
    from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED

    name = config.get("model_name", "PaSST_SED")
    if name in _LATER_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md, queue 1, item {_LATER_MODELS[name]}")
    model_cls = {"PaSST_SED": PaSST_SED, "PaSST_CNN": PaSST_CNN, "HTSAT_CNN": HTSAT_CNN}[name]
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = model_cls(**_upstream_names(common.model_init_kwargs(config, name)), dtype=dtype,
                      device="cpu")
    frontend = (HTSATFrontend(device=device) if name == "HTSAT_CNN"
                else PasstFrontend(device=device))
    return model, frontend


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a checkpoint of the port's or an upstream ``.pt``
    file; a JAX orbax directory is refused by name."""
    from transformer4sed_tpu_torch.utils.checkpoint import restore_params

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (a JAX orbax checkpoint?); the port reads its own "
            "checkpoints and upstream .pt state dicts, not orbax directories (ROADMAP.md, not "
            "ported)")
    return restore_params(path)


def load_pretrained(model, config, args, logger, device: torch.device):
    """A seeded init (``--random_seed``), then ``--pretrained_ckpt`` through
    ``load_partial`` with ``generals.warm_start_drop``; moves the model to
    ``device``. The checkpoint is a file of the port's or an upstream ``.pt``
    state dict; a JAX orbax directory is not read."""
    from transformer4sed_tpu_torch.utils.checkpoint import dropped_keys, load_partial
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    init_weights_(model, seed=args.random_seed)
    if args.pretrained_ckpt:
        restored = read_checkpoint(args.pretrained_ckpt)
        drop = config["generals"].get("warm_start_drop", [])
        own = model.state_dict()
        model.load_state_dict(load_partial(own, restored, drop_patterns=drop))
        loaded = [k for k in restored if k in own and restored[k].shape == own[k].shape]
        dropped = dropped_keys(own, restored, drop)
        logger.info(f"warm-started from {args.pretrained_ckpt} (dropped: {drop})")
        logger.info(f"warm start: {len(loaded) - len(dropped)} of {len(own)} keys loaded, "
                    f"dropped {dropped}")
    return model.to(device)


class Serving(NamedTuple):
    """What the serving entry points need of a config and a checkpoint."""

    model: torch.nn.Module
    frontend: Any
    codec: Any
    median_filter: List[int]
    model_kwargs: Dict


def serving_model(config, ckpt: str, device: torch.device) -> Serving:
    """The config's model (:func:`build_model`) with every weight of ``ckpt``
    (:func:`read_checkpoint`), on ``device`` in eval mode; its frontend; the
    codec (the classes of ``dataset.labels`` or of ``dataset.label_dict``,
    as the AudioSet-strong configs give them); the median widths; the
    forward's ``test_kwargs``."""
    name = config.get("model_name", "PaSST_SED")
    codec = common.codec_from_config(config, labels=common.label_dict_labels(config))
    model, frontend = build_model(config, device)
    model.load_state_dict(read_checkpoint(ckpt))
    return Serving(model.to(device).eval(), frontend, codec,
                   common.median_filter_from_config(config, codec),
                   dict(config.get(name, {}).get("test_kwargs", {})))


def serving_engine(config, ckpt: str, device: torch.device, batch_size: int,
                   threshold: float = 0.5):
    """``recipes.serve.InferenceEngine`` over :func:`serving_model`."""
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine

    s = serving_model(config, ckpt, device)
    return InferenceEngine(s.model, s.frontend, s.codec, s.median_filter, batch_size=batch_size,
                           threshold=threshold, model_kwargs=s.model_kwargs, device=device)


def _precision_line(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"device {device} ({torch.cuda.get_device_name(device)}): bf16 compute, f32 "
                "params, optimizer state and EMA")
    return f"device {device}: f32 throughout (the kernels' plain versions)"


def pretrain(model, frontend, config, codec, args, paths, logger) -> int:
    """MLM pretraining: the unlabeled-style sources (strong, weak and
    unlabeled folders, whichever the config names) at a prefix of
    ``training.batch_size``; the best student by validation loss."""
    from transformer4sed_tpu_torch.data.datasets import UnlabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.data.sampler import ConcatBatchSampler, RandomSampler
    from transformer4sed_tpu_torch.recipes.matsed import MLMTrainer
    from transformer4sed_tpu_torch.utils.checkpoint import save_params

    ds_cfg = config["dataset"]
    sources = [UnlabeledDataset(ds_cfg[k], False, codec)
               for k in ("strong_folder", "weak_folder", "unlabeled_folder") if ds_cfg.get(k)]
    batch_sizes = config["training"]["batch_size"][:len(sources)]
    sampler = ConcatBatchSampler([RandomSampler(len(s), i) for i, s in enumerate(sources)],
                                 batch_sizes)
    train_loader = DataLoader(sources, batch_sampler=sampler,
                              num_workers=config["generals"].get("num_workers", 4))
    val_loader = common.eval_loader(config, UnlabeledDataset(ds_cfg["val_folder"], False, codec),
                                    batch_size=sum(batch_sizes))
    trainer = MLMTrainer(model, frontend, config, train_loader, val_loader, logger)
    best_loss = float("inf")
    for epoch in range(config["training"]["scheduler"]["n_epochs"]):
        loss = trainer.train_epoch(epoch, args.random_seed)
        val_loss = trainer.validation()
        logger.info(f"epoch {epoch + 1}: train {loss:.5f} val {val_loss:.5f}")
        if val_loss < best_loss:
            best_loss = val_loss
            save_params(f"{paths['best_paths']}/best_student", trainer.model.state_dict())
    return 0


class Stage(NamedTuple):
    """A stage's parsed flags, config, save paths, logger, codec, device and
    warm-started model and frontend."""

    name: str
    args: Any
    config: Dict
    paths: Dict[str, str]
    logger: Any
    codec: Any
    device: torch.device
    model: torch.nn.Module
    frontend: Any


def setup(argv) -> Stage:
    """Parse a stage's flags, load its config and build its warm-started
    model."""
    stage, rest = argv[0], argv[1:]
    if stage in _LATER_STAGES:
        raise NotImplementedError(
            f"stage {stage!r} is not ported yet: ROADMAP.md, queue 1, item {_LATER_STAGES[stage]}")
    if stage not in MATSED_STAGES:
        raise SystemExit(f"unknown stage {stage!r}")
    args = common.build_argparser().parse_args(rest)
    device = resolve_device(args.device)  # raises before anything is written without a card
    config, paths, logger = common.prepare_run(args)
    codec = common.codec_from_config(config)
    model, frontend = build_model(config, device)
    logger.info(_precision_line(device))
    model = load_pretrained(model, config, args, logger, device)
    return Stage(stage, args, config, paths, logger, codec, device, model, frontend)


def finetune_trainer(st: Stage):
    """The stage's ``MATSEDTrainer`` over the DESED loaders."""
    from transformer4sed_tpu_torch.recipes.matsed import MATSEDTrainer

    loaders = common.desed_dataset_setting(st.config, st.codec, st.args.random_seed)
    return MATSEDTrainer(st.model, st.frontend, st.config, st.codec, *loaders, st.logger)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    st = setup(argv)
    args, config, logger = st.args, st.config, st.logger
    try:
        if st.name == "matsed_pretrain":
            return pretrain(st.model, st.frontend, config, st.codec, args, st.paths, logger)
        trainer = finetune_trainer(st)
        start_epoch = 0
        resume = common.resolve_resume(args, st.paths, logger)
        if resume:
            steps = trainer.restore_state(resume)
            start_epoch = steps // max(len(trainer.train_loader), 1)
            logger.info(f"resumed from {resume} at step {steps} (epoch {start_epoch})")
        if st.name == "matsed_finetune" and not args.test_only:
            trainer.run(config["training"]["scheduler"]["n_epochs"], st.paths["best_paths"],
                        args.random_seed, start_epoch=start_epoch)
        trainer.test(filter_type=config["training"].get("filter_type", "median"))
        return 0
    finally:
        logger.close()


if __name__ == "__main__":
    sys.exit(main())
