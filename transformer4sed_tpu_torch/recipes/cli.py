"""Recipe CLI: ``python -m transformer4sed_tpu_torch.recipes.cli <stage> ...``
(port of ``recipes/cli.py``, the MAT-SED stages).

  matsed_pretrain  masked-reconstruction MLM (stage 1)
  matsed_finetune  mean-teacher semi-supervised fine-tune (stages 2-3;
                   finetune2 differs only by config: encoder_win)
  matsed_test      test with the median or max filter, or cSEBB
  pmam_extract / pmam_gmm / pmam_pseudo_labels
                   PMAM's tokenizer: frame features tapped from the frozen
                   MLM net, a GMM fitted on them, per-clip pseudo-label TSVs
  pmam_train       PMAM's post-pretraining: prototype BCE on the masked
                   frames against the pseudo-labels, LoRA inside a frozen
                   backbone (--gmm_means_path, --pseudo_label_dir)
  audioset_supervised
                   supervised AudioSet-strong training (HTSAT_CNN, PaSST_CNN)
  dasm_train       closed-set DASM (strong BCE + the AT branch's loss; the
                   dataset.text_query / audio_query banks of a projector model)
  dasm_ov          open-vocabulary DASM (common classes only, common-first
                   validation; needs dataset.state_json or type_map)
  clap_train       common-only CLAP-SED (the common slice of dataset.query_bank
                   in training, the whole bank in validation; needs
                   dataset.state_json or type_map)
  openset_eval     zero-shot evaluation of the extended vocabulary
                   (dataset.openset_label, openset_embedding, openset_tsv,
                   openset_dur, openset_folder; dataset.query_bank)

Stages hand off through ``--pretrained_ckpt`` (a checkpoint of the port's,
or an upstream ``.pt`` state dict) with the config's ``warm_start_drop``;
``--resume_ckpt auto`` resumes from ``best/last_state``. A stage runs on the
card, where the model computes in bf16 with f32 params, optimizer state and
EMA (``docs/PRECISION.md``); ``--device cpu`` runs it on the CPU in f32
throughout; the GMM runs in full f32 on either (``pmam/gmm.py``). The
tokenizer's draws (mask and frame offsets) come from a generator seeded by
``--random_seed``, where the JAX stages fold fixed keys. The AudioSet stages
keep ``best/best_student``, ``best_metric.json`` and ``last_state`` each epoch
(``--resume_ckpt auto``); ``openset_eval`` writes ``single_psds.json``. DASM's
stages take ``DASM`` or ``DASM_HTSAT``, ``openset_eval`` also ``CLAP_SED``. The
JAX package's other model (``PasstComplexCNN``) is not ported yet and raises,
naming its ROADMAP.md item; so do the AudioSet stages under several ranks.

:func:`build_model` is the one model builder; :func:`serving_model` (a
config and a checkpoint -> the model in eval mode, frontend, codec, median
widths, forward kwargs) serves the serve, infer, stream and export entry
points.
"""

from __future__ import annotations

import collections
import os
import re
import sys
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from transformer4sed_tpu_torch.recipes import common
from transformer4sed_tpu_torch.utils.device import resolve_device

MATSED_STAGES = ("matsed_pretrain", "matsed_finetune", "matsed_test")
PMAM_STAGES = ("pmam_extract", "pmam_gmm", "pmam_pseudo_labels", "pmam_train")
AUDIOSET_STAGES = ("audioset_supervised", "dasm_train", "dasm_ov", "clap_train",
                   "openset_eval")
# the JAX package's other models, by their ROADMAP.md queue 1 item
_LATER_MODELS = {"PasstComplexCNN": 9}
# the networks that take their queries from the caller (serve / infer --query)
QUERY_MODELS = ("DASM", "DASM_HTSAT")
HTSAT_MODELS = ("HTSAT_CNN", "CLAP_SED", "DASM_HTSAT")


# upstream's spellings of the CNN branch's geometry (config/pmam/*.yaml)
_CNN_NAMES = {"kernel": "kernel_size", "pad": "padding"}


def _upstream_names(kwargs: Dict) -> Dict:
    """Constructor kwargs with upstream's names in the PMAM configs mapped to
    the port's: ``cnn_param``'s ``kernel`` / ``pad``."""
    kwargs = dict(kwargs)
    if isinstance(kwargs.get("cnn_param"), dict):
        kwargs["cnn_param"] = {_CNN_NAMES.get(k, k): v for k, v in kwargs["cnn_param"].items()}
    return kwargs


def build_model(config, device: torch.device):
    """(model, frontend) of the config's ``model_name`` for ``device``: f32
    params, computing in bf16 on the card (the kernels take bf16) and in f32
    on the CPU; built on the host with the constructor's weights until
    :func:`load_pretrained` fills and moves them."""
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.models.dasm import DASM
    from transformer4sed_tpu_torch.models.htsat import HTSATFrontend
    from transformer4sed_tpu_torch.models.htsat_heads import CLAP_SED, DASM_HTSAT, HTSAT_CNN
    from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED

    name = config.get("model_name", "PaSST_SED")
    if name in _LATER_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md, queue 1, item {_LATER_MODELS[name]}")
    model_cls = {"PaSST_SED": PaSST_SED, "PaSST_CNN": PaSST_CNN, "HTSAT_CNN": HTSAT_CNN,
                 "DASM": DASM, "CLAP_SED": CLAP_SED, "DASM_HTSAT": DASM_HTSAT}[name]
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = model_cls(**_upstream_names(common.model_init_kwargs(config, name)), dtype=dtype,
                      device="cpu")
    frontend = (HTSATFrontend(device=device) if name in HTSAT_MODELS
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


def read_weights(path: str, model, config, lora_ckpt: Optional[str] = None
                 ) -> Dict[str, torch.Tensor]:
    """:func:`read_checkpoint` for ``model``: an upstream ``.pt`` whose
    weights carry the merged LoRA delta (``common.lora_ckpt_merged``: the
    ``--lora_ckpt`` flag, else the config, else merged) has the delta of each
    of ``model``'s LoRA layers subtracted, as the JAX package's converter
    does; the port's own checkpoints keep the factors unmerged and are read
    as they are. A model without LoRA keeps the merged weights and drops the
    factors (upstream's strict=False load into a plain PaSST)."""
    from transformer4sed_tpu_torch.models.lora import lora_modules, unmerge_lora_checkpoint

    restored = read_checkpoint(path)
    if (path.endswith(".pt") and lora_modules(model)
            and common.lora_ckpt_merged(config, lora_ckpt)):
        restored = unmerge_lora_checkpoint(model, restored)
    return restored


def _factor_pattern(name: str) -> str:
    """A LoRA factor's key with its block index starred (a log line's pattern)."""
    return re.sub(r"\.\d+\.", ".*.", name)


def load_pretrained(model, config, args, logger, device: torch.device):
    """A seeded init (``--random_seed``), then ``--pretrained_ckpt`` through
    ``load_partial`` with ``generals.warm_start_drop``; moves the model to
    ``device``. The checkpoint is a file of the port's or an upstream ``.pt``
    state dict (:func:`read_weights`); a JAX orbax directory is not read. The
    log counts the keys loaded, those dropped by the config, and those the
    model lacks, by name pattern (finetune1 drops the post-pretrain stage's
    LoRA factors and MLM head so)."""
    from transformer4sed_tpu_torch.utils.checkpoint import dropped_keys, load_partial
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    init_weights_(model, seed=args.random_seed)
    if args.pretrained_ckpt:
        restored = read_weights(args.pretrained_ckpt, model, config,
                                getattr(args, "lora_ckpt", None))
        drop = config["generals"].get("warm_start_drop", [])
        own = model.state_dict()
        model.load_state_dict(load_partial(own, restored, drop_patterns=drop))
        loaded = [k for k in restored if k in own and restored[k].shape == own[k].shape]
        dropped = dropped_keys(own, restored, drop)
        unknown = collections.Counter(_factor_pattern(k) for k in restored if k not in own)
        logger.info(f"warm-started from {args.pretrained_ckpt} (dropped: {drop})")
        logger.info(f"warm start: {len(loaded) - len(dropped)} of {len(own)} keys loaded, "
                    f"dropped {dropped}")
        if unknown:
            logger.info(f"warm start: {sum(unknown.values())} checkpoint keys the model lacks, "
                        f"dropped: {dict(sorted(unknown.items()))}")
    return model.to(device)


class Serving(NamedTuple):
    """What the serving entry points need of a config and a checkpoint."""

    model: torch.nn.Module
    frontend: Any
    codec: Any
    median_filter: List[int]
    model_kwargs: Dict


def serving_model(config, ckpt: str, device: torch.device, lora_ckpt: Optional[str] = None,
                  labels: Optional[List[str]] = None) -> Serving:
    """The config's model (:func:`build_model`) with every weight of ``ckpt``
    (:func:`read_weights`, ``lora_ckpt`` its merged-ness policy for an
    upstream LoRA ``.pt``), on ``device`` in eval mode; its frontend; the
    codec (the classes of ``labels``, else of ``dataset.labels`` or of
    ``dataset.label_dict``, as the AudioSet-strong configs give them); the
    median widths; the forward's ``test_kwargs``."""
    name = config.get("model_name", "PaSST_SED")
    codec = common.codec_from_config(config, labels=labels or common.label_dict_labels(config))
    model, frontend = build_model(config, device)
    model.load_state_dict(read_weights(ckpt, model, config, lora_ckpt))
    return Serving(model.to(device).eval(), frontend, codec,
                   common.median_filter_from_config(config, codec),
                   dict(config.get(name, {}).get("test_kwargs", {})))


def query_refusal(config) -> Optional[str]:
    """Why ``--query`` cannot serve the config's network, or None: it serves
    DASM and DASM_HTSAT. CLAP_SED has no ``query_type``, which the JAX
    serve passes with every ``--query`` (a TypeError there; ROADMAP.md,
    queue 3)."""
    name = config.get("model_name", "PaSST_SED")
    if name in QUERY_MODELS:
        return None
    if name == "CLAP_SED":
        return ("--query with CLAP_SED: its forward takes no query_type, which the JAX serve "
                "passes with every --query and fails on; serve its stored text_query, or "
                "evaluate new labels with the openset_eval stage")
    return f"--query serves an open-vocabulary DASM or DASM_HTSAT; the config builds {name}"


def serving_engine(config, ckpt: str, device: torch.device, batch_size: int,
                   threshold: float = 0.5, lora_ckpt: Optional[str] = None,
                   labels: Optional[List[str]] = None, model_kwargs: Optional[Dict] = None):
    """``recipes.serve.InferenceEngine`` over :func:`serving_model`;
    ``model_kwargs`` (an open-vocabulary DASM's or DASM_HTSAT's ``query``
    and ``query_type``)
    join the config's ``test_kwargs``."""
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine

    s = serving_model(config, ckpt, device, lora_ckpt, labels)
    return InferenceEngine(s.model, s.frontend, s.codec, s.median_filter, batch_size=batch_size,
                           threshold=threshold, model_kwargs={**s.model_kwargs,
                                                              **(model_kwargs or {})},
                           device=device)


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
    if stage not in MATSED_STAGES + PMAM_STAGES + AUDIOSET_STAGES:
        raise SystemExit(f"unknown stage {stage!r}")
    args = common.build_argparser().parse_args(rest)
    device = resolve_device(args.device)  # raises before anything is written without a card
    config, paths, logger = common.prepare_run(args)
    # AudioSet-strong: the classes of the label dict (setting.py:55-64)
    codec = common.codec_from_config(config, labels=common.label_dict_labels(config))
    model, frontend = build_model(config, device)
    logger.info(_precision_line(device))
    model = load_pretrained(model, config, args, logger, device)
    return Stage(stage, args, config, paths, logger, codec, device, model, frontend)


def _unlabeled_loader(st: Stage, return_name: bool):
    """The unlabeled folder at ``training.batch_size_val``, in order, the last
    batch kept."""
    from transformer4sed_tpu_torch.data.datasets import UnlabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader

    ds = UnlabeledDataset(st.config["dataset"]["unlabeled_folder"], return_name, st.codec)
    return DataLoader(ds, batch_size=st.config["training"].get("batch_size_val", 16),
                      num_workers=st.config["generals"].get("num_workers", 4), drop_last=False)


def _mels(st: Stage, loader):
    for batch in loader:
        wav = torch.from_numpy(batch["wav"]).to(st.device)
        yield st.frontend.normalize(st.frontend(wav)), batch.get("filename")


def pmam_extract(st: Stage) -> int:
    """PMAM tokenizer, stage 1: the frozen MLM net's frame features (the
    ``pmam.feature_layer`` tap, one frame in ``downsample_rate``) ->
    ``features.npy``."""
    import numpy as np

    from transformer4sed_tpu_torch.pmam.features import extract_frame_features

    pm = st.config.get("pmam", {})
    gen = torch.Generator().manual_seed(st.args.random_seed)
    feats = extract_frame_features(
        st.model.eval(), (mel for mel, _ in _mels(st, _unlabeled_loader(st, False))),
        feature_layer=pm.get("feature_layer", "transformer_0"),
        downsample_rate=pm.get("downsample_rate", 4), generator=gen)
    out = f"{st.paths['save_folder']}/features.npy"
    np.save(out, feats)
    st.logger.info(f"extracted {feats.shape} features -> {out}")
    return 0


def pmam_gmm(st: Stage) -> int:
    """PMAM tokenizer, stage 2: a GMM (optionally after PCA) on
    ``features.npy`` -> ``gmm_means.npy``, ``gmm_covariances.npy``,
    ``gmm_weights.npy``."""
    import time

    import numpy as np

    from transformer4sed_tpu_torch.pmam.gmm import PCA, GaussianMixture

    pm = st.config.get("pmam", {})
    folder = st.paths["save_folder"]
    feats = np.load(f"{folder}/features.npy")
    if pm.get("pca_dim"):
        feats = PCA(pm["pca_dim"], device=st.device).fit_transform(feats)
    t0 = time.perf_counter()
    gmm = GaussianMixture(num_components=pm.get("n_components", 64),
                          covariance_type=pm.get("covariance_type", "full"),
                          n_iter=pm.get("n_iter", 50), device=st.device).fit(feats)
    seconds = time.perf_counter() - t0
    np.save(f"{folder}/gmm_means.npy", gmm.means)
    np.save(f"{folder}/gmm_covariances.npy", gmm.covariances)
    np.save(f"{folder}/gmm_weights.npy", gmm.weights)
    st.logger.info(f"fitted GMM: means {gmm.means.shape} on {feats.shape[0]} rows in "
                   f"{seconds:.2f} s ({gmm.n_iter} EM iterations, {gmm.rows_per_chunk} rows a "
                   f"chunk); mean log-likelihood {gmm.log_likelihoods[0]:.4f} -> "
                   f"{gmm.log_likelihoods[-1]:.4f}")
    return 0


def load_gmm(folder: str, device: torch.device):
    """The GMM that ``pmam_gmm`` wrote to ``folder``; the covariance layout
    gives its type ([K, D] diagonal, [K, D, D] full)."""
    import numpy as np

    from transformer4sed_tpu_torch.pmam.gmm import GaussianMixture

    covs = np.load(f"{folder}/gmm_covariances.npy")
    gmm = GaussianMixture(num_components=covs.shape[0],
                          covariance_type="diag" if covs.ndim == 2 else "full", device=device)
    gmm.means = np.load(f"{folder}/gmm_means.npy")
    gmm.covariances = covs
    gmm.weights = np.load(f"{folder}/gmm_weights.npy")
    return gmm


def pmam_pseudo_labels(st: Stage) -> int:
    """PMAM tokenizer, stage 3: the GMM's posteriors of every clip's tapped
    frames -> ``pseudo_labels/<clip>.tsv``, batch by batch."""
    from transformer4sed_tpu_torch.pmam.pseudo_labels import generate_pseudo_labels

    pm = st.config.get("pmam", {})
    gmm = load_gmm(st.paths["save_folder"], st.device)
    gen = torch.Generator().manual_seed(st.args.random_seed)
    n = generate_pseudo_labels(st.model.eval(), gmm, _mels(st, _unlabeled_loader(st, True)),
                               out_dir=f"{st.paths['save_folder']}/pseudo_labels",
                               feature_layer=pm.get("feature_layer", "transformer_0"),
                               generator=gen)
    st.logger.info(f"wrote {n} pseudo-label TSVs")
    return 0


def pmam_train(st: Stage) -> int:
    """PMAM post-pretraining (upstream ``recipes/desed/pmam/{main,train}.py``):
    the prototype BCE on the masked frames against the pseudo-labels, LoRA
    factors, decoder and heads training (``opt.lora_trainable`` defaults to
    true); the best student by training loss. As in the JAX stage the step's
    config takes ``pmam.temperature``, ``training.w_AT`` and the model's
    ``train_kwargs`` only (the transform keeps its defaults), and the student
    is saved with its LoRA factors unmerged."""
    import numpy as np

    from transformer4sed_tpu_torch.data.datasets import FrameWiseLabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.parallel import multihost
    from transformer4sed_tpu_torch.pmam.train import PMAMConfig, PMAMTrainer
    from transformer4sed_tpu_torch.utils.checkpoint import save_params

    if multihost.process_count() > 1:
        raise NotImplementedError("pmam_train under several ranks is not ported yet: "
                                  "ROADMAP.md, queue 1, item 8a")
    config, args, folder = st.config, st.args, st.paths["save_folder"]
    pm = config.get("pmam", {})
    gmm_means = np.load(args.gmm_means_path
                        or pm.get("gmm_means_path", f"{folder}/gmm_means.npy"))
    ds = FrameWiseLabeledDataset(
        args.pseudo_label_dir or pm.get("pseudo_label_dir", f"{folder}/pseudo_labels"),
        config["dataset"]["unlabeled_folder"], False, st.codec)
    bs = config["training"]["batch_size"]
    loader = DataLoader(ds, batch_size=bs if isinstance(bs, int) else sum(bs),
                        num_workers=config["generals"].get("num_workers", 4))
    config.setdefault("opt", {}).setdefault("lora_trainable", True)
    pg, schedule, accum = common.optimizer_from_config(config, len(loader))
    name = config.get("model_name", "PaSST_CNN")
    cfg = PMAMConfig(temperature=pm.get("temperature", 0.1),
                     w_at=config["training"].get("w_AT", 0.0),
                     model_kwargs=config.get(name, {}).get("train_kwargs", {}))
    trainer = PMAMTrainer(st.model, st.frontend, gmm_means, cfg, pg, schedule, accum)
    best, n = float("inf"), len(loader)
    for epoch in range(config["training"]["scheduler"]["n_epochs"]):
        loader.set_epoch(epoch)
        acc: Dict[str, float] = {}
        for i, batch in enumerate(loader):
            metrics = trainer.step({"wav": batch["wav"], "labels": batch["label"]},
                                   common.step_generator(args.random_seed, epoch * n + i))
            for k in ("loss_total", "loss_strong", "loss_weak"):
                acc[k] = acc.get(k, 0.0) + float(metrics[k]) / n
        st.logger.scalars("Train", acc, epoch + 1)
        st.logger.info(f"epoch {epoch + 1}: "
                       + " ".join(f"{k}={v:.5f}" for k, v in sorted(acc.items())))
        if acc["loss_total"] < best:
            best = acc["loss_total"]
            save_params(f"{st.paths['best_paths']}/best_student", trainer.model.state_dict())
    return 0


_PMAM_RUN = {"pmam_extract": pmam_extract, "pmam_gmm": pmam_gmm,
             "pmam_pseudo_labels": pmam_pseudo_labels, "pmam_train": pmam_train}


def _one_rank(stage: str) -> None:
    from transformer4sed_tpu_torch.parallel import multihost

    if multihost.process_count() > 1:
        raise NotImplementedError(f"{stage} under several ranks is not ported yet: ROADMAP.md, "
                                  "queue 1, item 15")


def audioset_trainer(st: Stage):
    """The stage's trainer over the AudioSet-strong loaders:
    ``SupervisedTrainer`` (audioset_supervised), ``DASMTrainer`` with the
    ``dataset.text_query`` / ``audio_query`` banks of a projector model
    (dasm_train), ``OVDASMTrainer`` (dasm_ov) and ``CommonOnlyClapTrainer``
    (clap_train) with the common classes of the type map and the
    ``dataset.query_bank`` (or ``text_query``) bank."""
    import numpy as np

    from transformer4sed_tpu_torch.recipes.audioset_strong import (
        SupervisedTrainer,
        audioset_dataset_setting,
        load_type_map,
    )
    from transformer4sed_tpu_torch.recipes.clap import CommonOnlyClapTrainer
    from transformer4sed_tpu_torch.recipes.dasm_recipe import DASMTrainer, OVDASMTrainer
    from transformer4sed_tpu_torch.utils.config import resolve_meta_path

    ds = st.config["dataset"]
    train_loader, val_loader = audioset_dataset_setting(st.config, st.codec, st.args.random_seed)
    state_json = resolve_meta_path(ds.get("state_json") or ds.get("type_map"))
    type_map = load_type_map(state_json) if state_json else None
    loaders = (st.model, st.frontend, st.config, st.codec, train_loader, val_loader, st.logger)
    if st.name == "audioset_supervised":
        return SupervisedTrainer(*loaders, type_map=type_map)
    if st.name == "dasm_train":
        banks = ([np.load(ds[k]) for k in ("text_query", "audio_query") if ds.get(k)]
                 if st.model.query_projector is not None else [])
        bank = banks if len(banks) > 1 else (banks[0] if banks else None)
        return DASMTrainer(*loaders, type_map=type_map, query_bank=bank)
    if type_map is None:
        raise SystemExit(f"{st.name} needs dataset.state_json (common/rare map)")
    common_mask = np.asarray([type_map.get(c) == "common" for c in st.codec.labels])
    bank_path = ds.get("query_bank") or ds.get("text_query")
    trainer = OVDASMTrainer if st.name == "dasm_ov" else CommonOnlyClapTrainer
    return trainer(*loaders, type_map=type_map, common_mask=common_mask,
                   query_bank=np.load(bank_path) if bank_path else None)


def audioset_train(st: Stage) -> int:
    """audioset_supervised, dasm_train, dasm_ov, clap_train: epochs of training and
    validation (PSDS at alpha 0), the best student by ``psds``
    (``best/best_student``, ``best_metric.json``) and ``last_state`` each
    epoch; ``--resume_ckpt auto`` resumes from it."""
    from transformer4sed_tpu_torch.utils.logging import BestModels

    _one_rank(st.name)
    trainer = audioset_trainer(st)
    ds = st.config["dataset"]
    gt = common.load_ground_truth(ds["val_tsv"])
    durations = common.load_durations(ds["val_dur"])
    median = common.median_filter_from_config(st.config, st.codec)
    best = BestModels(st.paths["best_paths"], flush_every=1)
    start_epoch = 0
    resume = common.resolve_resume(st.args, st.paths, st.logger)
    if resume:
        steps = trainer.restore_state(resume)
        start_epoch = steps // max(len(trainer.train_loader), 1)
        st.logger.info(f"resumed from {resume} at step {steps} (epoch {start_epoch})")
    for epoch in range(start_epoch, st.config["training"]["scheduler"]["n_epochs"]):
        metrics = trainer.train_epoch(epoch, st.args.random_seed)
        results = trainer.validation(epoch, gt, durations, median_filter=median)
        st.logger.info(f"epoch {epoch + 1}: train {metrics} val {results}")
        best.update(epoch, results["psds"], trainer.model.state_dict())
        trainer.save_state(f"{st.paths['best_paths']}/last_state")
    best.flush()
    return 0


def openset_eval(st: Stage) -> int:
    """Zero-shot evaluation of the extended vocabulary (upstream
    ``detect_any_sound/passt/openset_evaluation.py``): the novel labels of
    ``dataset.openset_label`` after the codec's, their queries
    ``dataset.openset_embedding`` after the bank (``dataset.query_bank``, or
    the model's learnable one), the ``test_kwargs`` forward on
    ``dataset.openset_tsv`` / ``openset_folder``; logs the PSDS and the ten
    best classes and writes ``single_psds.json``."""
    import json

    import numpy as np

    from transformer4sed_tpu_torch.core.codec import LabelCodec
    from transformer4sed_tpu_torch.data.datasets import StronglyLabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.data.tsv import read_tsv
    from transformer4sed_tpu_torch.recipes.dasm_recipe import openset_evaluate
    from transformer4sed_tpu_torch.utils.config import resolve_meta_path

    _one_rank(st.name)
    ds, codec = st.config["dataset"], st.codec
    with open(resolve_meta_path(ds["openset_label"])) as f:
        extra_labels = json.load(f)
    codec_open = LabelCodec(labels=tuple(codec.labels) + tuple(extra_labels),
                            audio_len=codec.audio_len, frame_len=codec.frame_len,
                            frame_hop=codec.frame_hop, net_pooling=codec.net_pooling, sr=codec.sr)
    test = StronglyLabeledDataset(read_tsv(ds["openset_tsv"]), ds["openset_folder"], True,
                                  codec_open)
    loader = DataLoader(test, batch_size=st.config["training"].get("batch_size_val", 16),
                        drop_last=False, num_workers=st.config["generals"].get("num_workers", 4))
    psds, single, top10 = openset_evaluate(
        st.model, st.frontend, codec_open, loader, np.load(ds["openset_embedding"]),
        common.load_ground_truth(ds["openset_tsv"]), common.load_durations(ds["openset_dur"]),
        query_bank=np.load(ds["query_bank"]) if ds.get("query_bank") else None,
        median_filter=common.median_filter_from_config(st.config, codec_open),
        model_kwargs=st.config.get(st.config.get("model_name", "DASM"), {}).get(
            "test_kwargs", {}))
    with open(f"{st.paths['save_folder']}/single_psds.json", "w") as f:
        json.dump({k: round(v, 4) for k, v in sorted(single.items(), key=lambda kv: kv[1])}, f,
                  indent=4)
    st.logger.info(f"openset psds={psds:.4f}; top10={top10}")
    return 0


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
        if st.name in _PMAM_RUN:
            return _PMAM_RUN[st.name](st)
        if st.name == "openset_eval":
            return openset_eval(st)
        if st.name in AUDIOSET_STAGES:
            return audioset_train(st)
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
