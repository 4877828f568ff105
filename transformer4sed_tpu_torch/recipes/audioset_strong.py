"""AudioSet-strong recipe: the supervised strong-label train step and its
epoch loop (port of ``recipes/audioset_strong.py``).

``recipes/audioset_strong/base/passt_cnn/train.py``'s loop body for
HTSAT_CNN: frontend -> frame shift (labels on their own, finer grid) ->
whole-batch mixup -> one filt_aug view -> model forward in training mode
(BatchNorm batch statistics, running statistics carried in the model's
buffers from step to step, CNN dropout) -> class loss on the strong
output -> backward -> global-norm clip -> AdamW per param group -> LR
schedule.

The random numbers of a step are drawn first (:func:`draw_supervised`, from
a ``torch.Generator``) and applied second, so a test can feed the draws of
another implementation.

The epoch loop (``recipes/audioset_strong/setting.py`` and
``base/passt_cnn/train.py``): :func:`audioset_dataset_setting` (the strong
train set drawn by the weighted sampler of ``dataset.weight_tsv``, 100k clips
an epoch, and the validation set), the label tables (:func:`load_label_dict`,
:func:`load_type_map`) and :class:`SupervisedTrainer` (epochs of the step,
validation by PSDS at ``alpha_ct = alpha_st = 0`` over the classes present in
the validation ground truth, with common/rare means by a type map, and the
resumable train state). DASM's trainers (``recipes/dasm_recipe.py``) subclass
it. The loop runs on one device: the AudioSet stages under several ranks
are ROADMAP.md queue 1 item 15.

Under data parallelism (``parallel.shard_train_step``) every rank
preprocesses the global batch with the same generator and keeps its
contiguous block of rows (as ``train/mean_teacher.py`` does, for the same
reason: the whole-batch mixup pairs rows across ranks); BatchNorm takes the
global batch's statistics and the gradients are averaged over the ``data``
group.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


from transformer4sed_tpu_torch.core import losses as L
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models.cnn import BatchRows
from transformer4sed_tpu_torch.parallel.partition import sharded_param_ids
from transformer4sed_tpu_torch.train.optim import (
    GradientAccumulator,
    ParamGroupConfig,
    apply_gradients,
    build_optimizer,
    global_norm,
    live_params,
    load_optimizer_state,
)


@dataclass(frozen=True)
class SupervisedConfig:
    """The JAX package's fields, without its ``net_pooling``, which its step
    never reads (the ratio comes from the mel and label shapes)."""

    loss_name: str = "BCELoss"
    loss_kwargs: Optional[dict] = None
    max_shift_frame: int = 64000  # 2 * sr (reference uses wav-scale shifts on mel)
    mixup_prob: float = 0.5
    mixup_alpha: float = 10.0
    mixup_beta: float = 0.5
    transform_choice: Tuple[int, int, int, int] = (1, 0, 0, 0)
    filter_db_range: Tuple[float, float] = (-0.5, 0.5)
    filter_bands: Tuple[int, int] = (3, 6)
    filter_minimum_bandwidth: int = 6
    filter_type: str = "step"
    model_kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SupervisedDraw:
    """The random numbers of one preprocess call."""

    fminmax: Optional[Tuple[float, float]]  # the frontend's training draw (None: it has none)
    shifts: torch.Tensor                    # [B] frame shifts
    do_mix: bool
    perm: torch.Tensor                      # [B] mixup partner of each clip
    c: float                                # mixup coefficient
    views: List[augment.ViewDraw]           # one feature-transformation view


def draw_supervised(gen: torch.Generator, cfg: SupervisedConfig, mel_shape,
                    fminmax: Optional[Tuple[float, float]] = None,
                    max_shift: Optional[int] = None) -> SupervisedDraw:
    """Draw for a [B, F, T] mel batch: per-sample shifts of spread
    ``max_shift`` (default: ``cfg.max_shift_frame``, at most half the clip),
    one Beta(alpha, beta) coefficient, one permutation and one probability
    draw for the whole batch, one transformation view. ``fminmax`` is the
    frontend's own draw, made before the mel exists."""
    b, _, t = mel_shape
    if max_shift is None:
        max_shift = min(cfg.max_shift_frame, t // 2)
    shifts = augment.draw_frame_shift(gen, b, max_shift)
    do_mix = float(torch.rand((), generator=gen, device=gen.device)) < cfg.mixup_prob
    perm, c = augment.draw_mixup(gen, b, cfg.mixup_alpha, cfg.mixup_beta)
    views = augment.draw_feature_transformation(
        gen, mel_shape, 1, cfg.transform_choice, filter_db_range=cfg.filter_db_range,
        filter_bands=cfg.filter_bands, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
        filter_type=cfg.filter_type)
    return SupervisedDraw(fminmax, shifts, do_mix, perm, c, views)


def to_feature_layout(mel: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """HTSAT-style frontends emit [B, 1, T, F]; the augmentations work on
    [B, F, T]. Returns (mel [B, F, T], whether it was 4-d)."""
    if mel.ndim == 4:
        return mel[:, 0].transpose(1, 2), True
    return mel, False


def from_feature_layout(mel: torch.Tensor, was_4d: bool) -> torch.Tensor:
    return mel.transpose(1, 2)[:, None] if was_4d else mel


def make_supervised_preprocess(frontend, cfg: SupervisedConfig, device):
    """Frontend + augmentation chain of the supervised step. Returns
    ``preprocess(batch, gen, draw=None) -> (mel, labels)`` with mel in the
    model's native layout; ``draw`` replaces the generator's draws."""

    def preprocess(batch: Dict[str, Any], gen: Optional[torch.Generator],
                   draw: Optional[SupervisedDraw] = None):
        wav = torch.as_tensor(batch["wav"]).to(device)
        labels = torch.as_tensor(batch["labels"]).to(device=device, dtype=torch.float32)
        fminmax = draw.fminmax if draw is not None else frontend.draw_fminmax(gen)
        mel, was_4d = to_feature_layout(frontend.normalize(frontend(wav, fminmax)))
        if draw is None:
            draw = draw_supervised(gen, cfg, mel.shape, fminmax)
        # may be fractional: HTSAT label grids are finer than the mel grid
        net_pooling = mel.shape[-1] / labels.shape[-1]
        mel, labels = augment.frame_shift(mel, draw.shifts, labels, net_pooling=net_pooling)
        if draw.do_mix:
            mel, labels = augment.mixup(mel, draw.perm, draw.c, labels)
        mel = augment.feature_transformation(
            mel, draw.views, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
            filter_type=cfg.filter_type, norm_std=5.0)
        return from_feature_layout(mel, was_4d), labels

    return preprocess


def make_supervised_loss_fn(model: torch.nn.Module, frontend, cfg: SupervisedConfig, device):
    """Loss of the supervised step (preprocess + training-mode forward):
    ``loss_fn(batch, gen, draw=None, dropout_masks=None, rows=None) -> (loss,
    metrics)``; ``rows`` (global row indices) keeps those rows of the
    preprocessed global batch, and the model draws its CNN dropout masks for
    the global batch and keeps them too."""
    loss_of = L.loss_function_factory(cfg.loss_name, cfg.loss_kwargs)
    preprocess = make_supervised_preprocess(frontend, cfg, device)

    def loss_fn(batch, gen, draw=None, dropout_masks=None, rows=None):
        mel, labels = preprocess(batch, gen, draw)
        batch_rows = None
        if rows is not None:
            batch_rows = BatchRows(rows, mel.shape[0])
            mel, labels = mel.index_select(0, rows), labels.index_select(0, rows)
        extra = {} if dropout_masks is None else {"dropout_masks": dropout_masks}
        out = model(mel, train=True, generator=gen, rows=batch_rows, **extra, **cfg.model_kwargs)
        loss_strong = loss_of(out.strong.float(), labels)
        return loss_strong, {"loss_class_strong": loss_strong.detach()}

    return loss_fn


class SupervisedStep:
    """The supervised strong-label step (``make_supervised_step``) of
    PaSST_CNN / HTSAT_CNN on AudioSet-strong, holding what the JAX package's
    train state holds: the model (params and BatchNorm running statistics),
    AdamW and its schedule, and the step count. :meth:`step` runs one train
    step on the model's device."""

    def __init__(self, model: torch.nn.Module, frontend, cfg: SupervisedConfig,
                 optim_cfg: ParamGroupConfig = ParamGroupConfig(),
                 schedule: Optional[Callable[[int], float]] = None, accum_steps: int = 1):
        self.model = model.train()
        self.frontend = frontend
        self.cfg = cfg
        self.optim_cfg = optim_cfg
        self.optimizer, self.scheduler, self.labels = build_optimizer(model, optim_cfg, schedule)
        self.device = next(model.parameters()).device
        self.loss_fn = self.make_loss_fn()
        self.accumulator = GradientAccumulator(accum_steps) if accum_steps > 1 else None
        self.step_count = 0  # applied optimizer steps
        self.mesh = None  # a parallel.Mesh, set by parallel.shard_train_step
        self.sharded = sharded_param_ids(model)

    def make_loss_fn(self):
        """The step's ``loss_fn(batch, gen, draw, dropout_masks, rows) -> (loss,
        metrics)``; DASM's step overrides it."""
        return make_supervised_loss_fn(self.model, self.frontend, self.cfg, self.device)

    def models(self):
        return (self.model,)

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs (``utils/checkpoint.py:save_checkpoint``)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step_count,
                "accum": None if self.accumulator is None else self.accumulator.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        load_optimizer_state(self, state)

    def forward_backward(self, batch: Dict[str, Any], generator: Optional[torch.Generator],
                         draw: Optional[SupervisedDraw] = None, dropout_masks=None,
                         **model_draws) -> Dict[str, Any]:
        """Preprocess, the training-mode forward (which moves the running
        statistics) and the backward into ``.grad``; returns the loss and
        ``grad_norm`` (0-d tensors on the device). Under a mesh: this rank's
        rows, the gradients averaged and the loss reported as its mean over
        the ``data`` group."""
        self.model.train()
        rows = None
        if self.mesh is not None:
            n = torch.as_tensor(batch["wav"]).shape[0]
            rows = self.mesh.batch_rows((n,)).to(self.device)
        loss, metrics = self.loss_fn(batch, generator, draw, dropout_masks, rows, **model_draws)
        self.model.zero_grad(set_to_none=True)  # frozen params too: they are in no group
        loss.backward()
        # a param the loss does not read (HTSAT's tscam head under HTSAT_CNN)
        # has a zero gradient in the JAX package, where AdamW still decays it
        for p in live_params(self.optimizer):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            self.mesh.average_gradients(self.model.parameters())
            metrics = self.mesh.mean_metrics(metrics)
        metrics["grad_norm"] = global_norm(self.model.parameters(), self.mesh, self.sharded)
        return metrics

    def step(self, batch: Dict[str, Any], generator: Optional[torch.Generator],
             draw: Optional[SupervisedDraw] = None, dropout_masks=None,
             **model_draws) -> Dict[str, Any]:
        """One train step on ``batch`` (``wav`` [B, S], ``labels``
        [B, C, T_lab]): :meth:`forward_backward`, then (every ``accum_steps``-th
        call) clip, AdamW, the schedule."""
        metrics = self.forward_backward(batch, generator, draw, dropout_masks, **model_draws)
        self.step_count += apply_gradients(self.optimizer, self.scheduler, self.optim_cfg.clip_grad,
                                           self.accumulator, self.mesh, self.sharded)
        return metrics


# -- the epoch loop -------------------------------------------------------------------

def get_weighted_sampler(weight_tsv: str, num_samples: int = 100_000, seed: int = 0):
    """Per-clip sampling weights from ``weight.tsv`` (column ``weight``)."""
    from transformer4sed_tpu_torch.data.sampler import WeightedSampler
    from transformer4sed_tpu_torch.data.tsv import read_tsv

    return WeightedSampler(read_tsv(weight_tsv)["weight"].astype(np.float64),
                           num_samples=num_samples, seed=seed)


def load_label_dict(path: str) -> Tuple[str, ...]:
    """Ordered class list from a {label: index} JSON (labeldict_audioset_strong)."""
    with open(path) as f:
        mapping = json.load(f)
    return tuple(sorted(mapping, key=mapping.get))


def load_type_map(state_json: str) -> Dict[str, str]:
    """class -> 'common' / 'rare' map from the recipe's ``state.json``."""
    with open(state_json) as f:
        return json.load(f)


def audioset_dataset_setting(config: Dict, codec, seed: int = 0):
    """Train and validation loaders for AudioSet-strong
    (``recipes/audioset_strong/setting.py:55-269``): the strongly labelled
    train set drawn by the weighted sampler (``training.num_samples`` or
    ``samples_per_epoch`` draws an epoch, 100k by default) when
    ``dataset.weight_tsv`` is set, else shuffled; the validation set in order
    at ``training.batch_size_val``."""
    from transformer4sed_tpu_torch.data.datasets import StronglyLabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.data.sampler import RandomSampler
    from transformer4sed_tpu_torch.data.tsv import read_tsv
    from transformer4sed_tpu_torch.recipes.common import eval_loader
    from transformer4sed_tpu_torch.utils.config import resolve_meta_path

    ds, tr = config["dataset"], config["training"]
    batch = tr["batch_size"]
    batch = sum(batch) if isinstance(batch, (list, tuple)) else batch
    train = StronglyLabeledDataset(read_tsv(ds["train_tsv"]), ds["train_folder"], False, codec)
    if ds.get("weight_tsv"):
        sampler = get_weighted_sampler(
            resolve_meta_path(ds["weight_tsv"]),
            num_samples=tr.get("num_samples", tr.get("samples_per_epoch", 100_000)), seed=seed)
    else:
        sampler = RandomSampler(len(train), seed)
    train_loader = DataLoader(train, sampler=sampler, batch_size=batch,
                              num_workers=config.get("generals", {}).get("num_workers", 4))
    val = StronglyLabeledDataset(read_tsv(ds["val_tsv"]), ds["val_folder"], True, codec)
    return train_loader, eval_loader(config, val, batch_size=tr.get("batch_size_val", batch))


def drop_absent_classes(single_class_psds: Dict[str, float], ground_truth,
                        classes: Sequence[str]) -> Dict[str, float]:
    """The per-class PSDS of the classes the validation ground truth holds
    (``base/passt_cnn/train.py:169-175``)."""
    present = {label for events in ground_truth.values() for _, _, label in events}
    return {c: v for c, v in single_class_psds.items() if c in present}


def split_psds_by_type(single_class_psds: Dict[str, float],
                       type_map: Dict[str, str]) -> Dict[str, float]:
    """Per-class PSDS -> the mean of each type (``psds_common``,
    ``psds_rare``; ``base/passt_cnn/train.py:207-237`` with state.json)."""
    groups: Dict[str, list] = {}
    for cls, value in single_class_psds.items():
        groups.setdefault(type_map.get(cls, "unknown"), []).append(value)
    return {f"psds_{k}": float(np.mean(v)) for k, v in groups.items()}


def psds_at_alpha_zero(scores, ground_truth, durations) -> Tuple[float, Dict[str, float]]:
    """PSDS at dtc = gtc = 0.7 with no cross-trigger or instability cost,
    the AudioSet recipes' validation metric; and the per-class values."""
    from transformer4sed_tpu_torch.eval.psds import compute_psds_from_scores

    return compute_psds_from_scores(scores, ground_truth, durations, dtc_threshold=0.7,
                                    gtc_threshold=0.7, alpha_ct=0.0, alpha_st=0.0)


class SupervisedTrainer:
    """Epoch loop of supervised AudioSet-strong training (PaSST_CNN /
    HTSAT_CNN, and DASM through its subclasses) on one device: the model is
    built, warm-started and on its device; :meth:`make_step` builds the train
    step (a :class:`SupervisedStep`). Validation computes PSDS with
    ``alpha_st = 0`` over the classes present in the validation ground
    truth and, given a type map, the common and rare means
    (``base/passt_cnn/train.py:140-320``)."""

    def __init__(self, model: torch.nn.Module, frontend, config: Dict, codec, train_loader,
                 val_loader, logger, type_map: Optional[Dict[str, str]] = None):
        from transformer4sed_tpu_torch.recipes import common

        self.model = model
        self.frontend = frontend
        self.config = config
        self.codec = codec
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.type_map = type_map
        self.model_name = config.get("model_name", "PaSST_CNN")
        self.device = next(model.parameters()).device
        pg, schedule, accum = common.optimizer_from_config(config, len(train_loader))
        self.step = self.make_step(pg, schedule, accum)

    def model_kwargs(self, key: str) -> Dict:
        return dict(self.config.get(self.model_name, {}).get(key, {}))

    def make_step(self, pg: ParamGroupConfig, schedule, accum: int) -> SupervisedStep:
        """The train step of ``make_supervised_step`` from the config's
        ``class_loss``, ``training.transform.choice`` and ``train_kwargs``
        (the transform's other fields keep their defaults, as in the JAX
        trainer)."""
        cls_loss = self.config.get("class_loss", {})
        cfg = SupervisedConfig(
            loss_name=cls_loss.get("loss_name", "BCELoss"), loss_kwargs=cls_loss.get("kwargs"),
            transform_choice=tuple(self.config["training"].get("transform", {}).get(
                "choice", (1, 0, 0, 0))),
            model_kwargs=self.model_kwargs("train_kwargs"))
        return SupervisedStep(self.model, self.frontend, cfg, pg, schedule, accum)

    def save_state(self, path: str):
        """The whole train state (params, BatchNorm statistics, AdamW, the
        schedule, the step) for ``--resume_ckpt``."""
        from transformer4sed_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(path, self.step.state_dict())

    def restore_state(self, path: str) -> int:
        """Restore the train state at ``path``; returns its applied steps."""
        from transformer4sed_tpu_torch.utils.checkpoint import restore_checkpoint

        restore_checkpoint(path, self.step)
        return self.step.step_count

    def train_epoch(self, epoch: int, seed: int) -> Dict[str, float]:
        """One pass of the train loader; step i of the epoch draws from
        ``common.step_generator(seed, epoch * n + i)``. Returns the metrics'
        epoch means."""
        from transformer4sed_tpu_torch.recipes import common

        self.train_loader.set_epoch(epoch)
        acc: Dict[str, float] = {}
        n = len(self.train_loader)
        for i, batch in enumerate(self.train_loader):
            metrics = self.step.step({"wav": batch["wav"], "labels": batch["label"]},
                                     common.step_generator(seed, epoch * n + i))
            for k, v in metrics.items():
                acc[k] = acc.get(k, 0.0) + float(v) / n
        self.logger.scalars("Train", acc, epoch + 1)
        return acc

    @torch.no_grad()
    def eval_forward(self, mel: torch.Tensor, pad_mask: torch.Tensor):
        """The model's eval forward on a validation batch: its ``strong``
        [B, C, T] and ``at_out``."""
        out = self.model(mel, pad_mask=pad_mask, **self.model_kwargs("val_kwargs"))
        return out.strong, out.at_out

    def validation_scores(self, median_filter):
        """The validation loader scored in eval mode: (the filtered clip
        scores, the AT branch's [N, C] outputs or None, the clips' [N, C]
        presence labels)."""
        from transformer4sed_tpu_torch.eval.decode import batched_decode_preds

        scores, at_preds, at_targets = {}, [], []
        was_training = self.model.training
        self.model.eval()
        try:
            for batch in self.val_loader:
                wav = torch.from_numpy(batch["wav"]).to(self.device)
                mel = self.frontend.normalize(self.frontend(wav))
                pad_mask = torch.from_numpy(batch["pad_mask"]).to(self.device)
                strong, at_out = self.eval_forward(mel, pad_mask)
                if at_out is not None:
                    at_preds.append(at_out.float().cpu().numpy())
                    at_targets.append((batch["label"].sum(-1) >= 1).astype(np.float32))
                _, post = batched_decode_preds(strong.float(), batch["filename"], self.codec,
                                               filter=median_filter)
                scores.update(post)
        finally:
            self.model.train(was_training)
        return scores, (np.concatenate(at_preds) if at_preds else None), (
            np.concatenate(at_targets) if at_targets else None)

    def validation(self, epoch: int, ground_truth, durations, median_filter=7) -> Dict[str, float]:
        scores, _, _ = self.validation_scores(median_filter)
        psds, single = psds_at_alpha_zero(scores, ground_truth, durations)
        results = {"psds": psds}
        if self.type_map:
            results.update(split_psds_by_type(
                drop_absent_classes(single, ground_truth, self.codec.labels), self.type_map))
        self.logger.scalars("validation", results, epoch + 1)
        return results
