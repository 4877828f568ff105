"""Recipe plumbing (port of ``recipes/common.py``): CLI flags, config,
save folders and seeds, the codec, the DESED loaders, ground truth, the
optimizer from YAML and the resume path.

Keeps the reference's public conventions (``recipes/desed/setting.py``):
the flags ``--config_dir --save_folder --random_seed``; the YAML sections
``generals / training / feature / <ModelName> / dataset / synth_dataset /
opt``; the model's kwargs under ``<ModelName>.init_kwargs`` splatted into
the constructor and ``train_stu_kwargs / val_kwargs / test_kwargs`` into
its forward. Tables are read by the port's TSV reader (``data/tsv.py``) in
place of pandas, and the loaders decode a batch's files in one native call
(``data/audio_io.py:load_wav_batch``).

The JAX module's device plumbing has no counterpart, or a plain one:
``make_model_apply`` (the flax apply contract; a port model is called
itself, BatchNorm statistics in its buffers), ``put_train_batch`` (the
trainers move the host batch to the model's device, and under a mesh keep
their rows, ``parallel.put_batch``), ``shard_eval_put`` and
``localize_eval_params`` (the eval batch goes to the model's device with
``.to``; params are never committed to a mesh), and
``sibling_model_state`` (buffers are part of the saved state dicts).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer4sed_tpu_torch.core import schedules
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.data.datasets import (
    StronglyLabeledDataset,
    UnlabeledDataset,
    WeaklyLabeledDataset,
)
from transformer4sed_tpu_torch.data.loader import DataLoader
from transformer4sed_tpu_torch.data.sampler import ConcatBatchSampler, RandomSampler
from transformer4sed_tpu_torch.data.tsv import read_tsv
from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig
from transformer4sed_tpu_torch.utils.config import get_save_directories, load_yaml_with_include
from transformer4sed_tpu_torch.utils.logging import Logger

_FORWARD_KWARG_KEYS = (
    "init_kwargs",
    "train_stu_kwargs",
    "train_tch_kwargs",
    "train_kwargs",
    "val_kwargs",
    "test_kwargs",
)


def model_init_kwargs(config: Dict, name: Optional[str] = None) -> Dict:
    """Flat constructor kwargs from the ``<ModelName>`` section, across every
    reference layout: nested ``{init_kwargs: {...}}`` or kwargs directly
    under the model name, PaSST_CNN's ``{passt_sed_param, cnn_param}``
    nesting (``cnn_name`` inside ``cnn_param``), and ``lora_config {r,
    lora_alpha}`` -> ``lora_rank`` / ``lora_alpha``."""
    kwargs = _normalized_model_section(config, name)
    lora_config = kwargs.pop("lora_config", None)
    if lora_config:
        kwargs.setdefault("lora_rank", lora_config.get("r", 0))
        kwargs.setdefault("lora_alpha", lora_config.get("lora_alpha", 1.0))
    return kwargs


def _normalized_model_section(config: Dict, name: Optional[str] = None) -> Dict:
    """The ``<ModelName>`` section flattened across the nesting conventions,
    ``lora_config`` left in place."""
    section = dict(config.get(name or config.get("model_name", "PaSST_SED"), {}))
    if "init_kwargs" in section:
        kwargs = dict(section["init_kwargs"])
    else:
        kwargs = {k: v for k, v in section.items() if k not in _FORWARD_KWARG_KEYS}
    if "passt_sed_param" in kwargs:
        sed_param = dict(kwargs.pop("passt_sed_param"))
        cnn_param = kwargs.pop("cnn_param", None)
        kwargs = {**sed_param, **kwargs}
        if cnn_param is not None:
            cnn_param = dict(cnn_param)
            kwargs["cnn_name"] = cnn_param.pop("cnn_name", "base")
            kwargs["cnn_param"] = cnn_param
    return kwargs


def lora_ckpt_merged(config: Dict, cli_choice: Optional[str] = None) -> bool:
    """Whether a LoRA ``.pt`` checkpoint carries the merged delta: the CLI's
    ``--lora_ckpt`` if given, else ``<model>.lora_config.merged_checkpoint``,
    else True (the reference's published artifacts are merged)."""
    if cli_choice:
        if cli_choice not in ("merged", "unmerged"):
            raise ValueError(f"--lora_ckpt must be merged|unmerged, got {cli_choice!r}")
        return cli_choice == "merged"
    lora_config = _normalized_model_section(config).get("lora_config") or {}
    return bool(lora_config.get("merged_checkpoint", True))


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="transformer4sed_tpu_torch recipe runner")
    parser.add_argument("--config_dir", type=str, required=True, help="YAML config path")
    parser.add_argument("--save_folder", type=str, required=True)
    parser.add_argument("--random_seed", type=int, default=42)
    parser.add_argument("--test_only", action="store_true")
    parser.add_argument("--resume_ckpt", type=str, default=None)
    parser.add_argument("--pretrained_ckpt", type=str, default=None)
    parser.add_argument(
        "--lora_ckpt", choices=("merged", "unmerged"), default=None,
        help="merged-ness of a LoRA .pt checkpoint: 'merged' = published artifacts (default), "
             "'unmerged' = mid-training BestModels saves")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    parser.add_argument("--gmm_means_path", type=str, default=None,
                        help="pmam_train: the tokenizer's gmm_means.npy")
    parser.add_argument("--pseudo_label_dir", type=str, default=None,
                        help="pmam_train: the tokenizer's pseudo-label TSVs")
    return parser


def prepare_run(args) -> Tuple[Dict, Dict, Logger]:
    """Load the config, make the save folders and the logger, seed Python and
    NumPy. Under a process group (``parallel/multihost.py``) only the primary
    process writes ``log.txt`` and TensorBoard; the others log warnings to
    the stream."""
    import logging

    from transformer4sed_tpu_torch.parallel.multihost import is_primary, maybe_initialize

    maybe_initialize()
    config = load_yaml_with_include(args.config_dir)
    config.setdefault("generals", {})["save_folder"] = args.save_folder
    paths = get_save_directories(config, args.save_folder)
    if is_primary():
        logger = Logger(log_path=paths["log"], tensorboard_dir=paths["tensorboard"])
    else:
        logger = Logger(level=logging.WARNING)
    random.seed(args.random_seed)
    np.random.seed(args.random_seed)
    if config["generals"].get("compilation_cache"):
        logger.info(f"generals.compilation_cache={config['generals']['compilation_cache']!r} "
                    "is an XLA setting; ignored here")
    return config, paths, logger


def codec_from_config(config: Dict, labels: Optional[List[str]] = None) -> LabelCodec:
    feat = config["feature"]
    labels = labels if labels is not None else config["dataset"]["labels"]
    return LabelCodec(
        labels=tuple(labels),
        audio_len=feat.get("audio_max_len", 10.0),
        frame_len=feat.get("n_window", feat.get("n_fft", 1024)),
        frame_hop=feat.get("hop_length", feat.get("hopsize")),
        net_pooling=feat.get("net_pooling", feat.get("net_subsample", 1)),
        sr=feat.get("sample_rate", feat.get("sr")),
    )


def label_dict_labels(config: Dict) -> Optional[List[str]]:
    """The class list of ``dataset.label_dict`` (or ``label_dict_path``), a
    {label: index} JSON, in index order, as the JAX CLI reads the
    AudioSet-strong configs' classes; None where the config names none."""
    ds_cfg = config.get("dataset", {})
    path = ds_cfg.get("label_dict_path") or ds_cfg.get("label_dict")
    if not path:
        return None
    with open(path) as f:
        mapping = json.load(f)
    return sorted(mapping, key=mapping.get)


def desed_dataset_setting(config: Dict, codec: LabelCodec, seed: int = 42):
    """The 4-source DESED training loader ([strong, synth, weak, unlabeled]
    composition) and the validation and test loaders
    (``recipes/desed/setting.py:150-251``)."""
    ds_cfg = config["dataset"]
    synth_cfg = config.get("synth_dataset", {})
    batch_sizes = config["training"]["batch_size"]  # [strong, synth, weak, unlabeled]

    strong = StronglyLabeledDataset(read_tsv(ds_cfg["strong_tsv"]), ds_cfg["strong_folder"],
                                    False, codec)
    synth = StronglyLabeledDataset(read_tsv(synth_cfg["synth_train_tsv"]),
                                   synth_cfg["synth_train_folder"], False, codec)
    weak = WeaklyLabeledDataset(read_tsv(ds_cfg["weak_tsv"]), ds_cfg["weak_folder"], False, codec)
    unlabeled = UnlabeledDataset(ds_cfg["unlabeled_folder"], False, codec)

    sampler = ConcatBatchSampler(
        [RandomSampler(len(strong), seed), RandomSampler(len(synth), seed + 1),
         RandomSampler(len(weak), seed + 2), RandomSampler(len(unlabeled), seed + 3)],
        batch_sizes=batch_sizes,
    )
    num_workers = config["generals"].get("num_workers", 4)
    # every rank loads the global batch: the data-parallel step augments the
    # global batch on every rank and keeps its rows (train/mean_teacher.py)
    train_loader = DataLoader([strong, synth, weak, unlabeled], batch_sampler=sampler,
                              num_workers=num_workers)
    val_loader = eval_loader(config, StronglyLabeledDataset(
        read_tsv(ds_cfg["val_tsv"]), ds_cfg["val_folder"], True, codec))
    test_loader = val_loader
    if ds_cfg.get("test_tsv"):
        test_loader = eval_loader(config, StronglyLabeledDataset(
            read_tsv(ds_cfg["test_tsv"]), ds_cfg["test_folder"], True, codec))
    return train_loader, val_loader, test_loader


def eval_loader(config: Dict, dataset, batch_size: Optional[int] = None) -> DataLoader:
    """A sequential loader over ``dataset`` at ``training.batch_size_val``,
    the last batch kept, each process scoring its own share of the items."""
    return DataLoader(dataset, batch_size=batch_size or config["training"].get("batch_size_val", 24),
                      num_workers=config["generals"].get("num_workers", 4), drop_last=False,
                      process_shard_items=True)


def load_ground_truth(tsv_path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """Events TSV -> {clip_id: [(onset, offset, label)]}; a clip whose row
    has no label is kept with no events."""
    out: Dict[str, List] = {}
    for row in read_tsv(tsv_path).rows():
        clip = os.path.splitext(str(row["filename"]))[0]
        out.setdefault(clip, [])
        label = row.get("event_label", math.nan)
        if not (isinstance(label, float) and math.isnan(label)):
            out[clip].append((float(row["onset"]), float(row["offset"]), str(label)))
    return out


def load_durations(tsv_path: str) -> Dict[str, float]:
    """Durations TSV (filename, duration) -> {clip_id: seconds}."""
    return {
        os.path.splitext(str(row["filename"]))[0]: float(row["duration"])
        for row in read_tsv(tsv_path).rows()
    }


def resolve_resume(args, paths, logger) -> Optional[str]:
    """``--resume_ckpt auto``: the newest intact per-epoch checkpoint
    (``last_state``, else the backup ``last_state.prev``); an explicit path
    passes through."""
    resume = getattr(args, "resume_ckpt", None)
    if resume != "auto":
        return resume
    for name in ("last_state", "last_state.prev"):
        candidate = f"{paths['best_paths']}/{name}"
        if os.path.exists(candidate):
            return candidate
    logger.info("auto-resume: no last_state found, starting fresh")
    return None


def optimizer_from_config(config: Dict, steps_per_epoch: int
                          ) -> Tuple[ParamGroupConfig, Callable[[int], float], int]:
    """(param groups, ExponentialDown schedule, accumulation steps) from the
    YAML ``opt`` and ``training`` sections (``recipes/desed/setting.py:254-278``),
    what ``train/optim.py:build_optimizer`` and the trainers take. Accepts the
    DESED naming (encoder/decoder/head) and the AudioSet one
    (backbone/cnn/sed_decoder/head, with DASM's at_decoder and query groups). ``training.accum_steps`` k averages k
    loader batches per optimizer step; the schedule counts applied steps, so
    its horizon is ``steps_per_epoch // k`` a epoch."""
    lr_dict = config["opt"]["param_groups"]
    enc = lr_dict.get("encoder") or lr_dict.get("backbone")
    dec = lr_dict.get("decoder") or lr_dict.get("sed_decoder")
    if enc is None or dec is None or "head" not in lr_dict:
        raise KeyError("opt.param_groups needs encoder|backbone, decoder|sed_decoder and head")

    def spec(d):
        return GroupSpec(lr=d["lr"], weight_decay=d.get("weight_decay", 1e-8))

    pg = ParamGroupConfig(
        encoder=GroupSpec(lr=enc["lr"], weight_decay=enc.get("weight_decay", 1e-8),
                          step_lr=enc.get("step_lr", 0) or 0,
                          freeze_layer=enc.get("freeze_layer", 0) or 0),
        decoder=spec(dec),
        head=spec(lr_dict["head"]),
        cnn=spec(lr_dict["cnn"]) if lr_dict.get("cnn") else None,
        at_decoder=spec(lr_dict["at_decoder"]) if lr_dict.get("at_decoder") else None,
        query=spec(lr_dict["query"]) if lr_dict.get("query") else None,
        backbone_depth=config.get("backbone_depth", 12),
        clip_grad=20.0 if config["training"].get("clip_grad") else 0.0,
        lora_trainable=bool(config["opt"].get("lora_trainable", False)),
    )
    sch = config["training"]["scheduler"]
    accum = int(config["training"].get("accum_steps", 1) or 1)
    opt_steps_per_epoch = max(1, steps_per_epoch // accum)
    schedule = schedules.exponential_down(
        start_iter=sch["n_epochs_cut"] * opt_steps_per_epoch,
        total_iter=sch["n_epochs"] * opt_steps_per_epoch,
        exponent=sch.get("exponent", -0.5),
        warmup_iter=sch.get("lr_warmup_epochs", 0) * opt_steps_per_epoch,
        warmup_rate=sch.get("lr_warmup_rate", 0.1),
    )
    return pg, schedule, accum


def median_filter_from_config(config: Dict, codec: LabelCodec) -> List[int]:
    """Per-class median widths scaled to the prediction length
    (``finetune/train.py:221-227``)."""
    pred_len = config["feature"].get("pred_len", codec.n_frames)
    windows = config["training"]["median_window"]
    if isinstance(windows, int):
        windows = [windows] * codec.n_classes
    return [int(w / 156 * pred_len) for w in windows]


def step_generator(seed: int, index: int) -> torch.Generator:
    """The generator of a run's ``index``-th step (``epoch * steps + i``):
    seeded from (seed, index) alone, as the JAX recipes take
    ``fold_in(PRNGKey(seed), index)``, so a resumed run draws what the
    uninterrupted one drew. A CPU generator, whose draws are the same for a
    model on any device."""
    state = np.random.SeedSequence((int(seed), int(index))).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))
