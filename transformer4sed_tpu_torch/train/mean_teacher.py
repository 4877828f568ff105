"""Mean-teacher semi-supervised training step (port of ``train/mean_teacher.py``).

The MAT-SED finetune loop body (reference
``recipes/desed/finetune/train.py:129-213``): mel frontend with the
fmin/fmax draw, frame shift, per-subset mixup, two augmented views, the
teacher forward without gradients, the student forward and backward
through the attention kernels' autograd Functions, six losses, global-norm
clipping, AdamW, the LR schedule and the EMA teacher update. A model with
BatchNorm (PaSST_CNN's CNN branch) keeps its running statistics in its
buffers: the student's move with its forward, the teacher's with the
teacher's own training-mode forward, and the EMA averages parameters only
(the JAX package's ``model_state_aware`` step).

The batch is the fixed composition [strong | weak | unlabeled]
(``ConcatDatasetBatchSampler``), so the reference's boolean index masks are
slices. Random numbers come from the generator passed to
:meth:`MeanTeacherTrainer.step`, drawn on its device (a CPU generator makes
the same draws whatever device the model is on). With ``accum_steps`` k
(``training.accum_steps``), k steps' gradients are averaged and applied on
the k-th (``train/optim.py:GradientAccumulator``); the EMA update and the
step count, which drives the consistency ramp, advance only then, as the
JAX step gates them on ``update_applied``. ``make_multi_step`` (a
``lax.scan`` over steps) has no counterpart.

Under data parallelism (``parallel.shard_train_step``) every rank is given
the global batch and the same generator, runs :func:`preprocess` on the whole
of it and keeps its rows: an equal share of each subset. Mixup pairs rows
across a whole subset, so a row's partner may sit on another rank; running
the augmentation globally keeps every draw (fmin/fmax, shift, mixup, the
filt_aug views) and every partner as one process would have them, with no
gather, for the price of the frontend on the global batch. The models'
per-row draws (dropout and DropPath, the CNN branch's dropout) are drawn for
the global batch too: the step passes them this rank's ``BatchRows``
(``models/cnn.py``). The losses are then
means over the local rows, whose mean over the ``data`` group is the global
loss, and the gradients are averaged over that group.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from transformer4sed_tpu_torch.core import losses as L
from transformer4sed_tpu_torch.core.ema import ema_update
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models.cnn import BatchRows
from transformer4sed_tpu_torch.parallel.partition import sharded_param_ids
from transformer4sed_tpu_torch.train.optim import (
    GradientAccumulator,
    ParamGroupConfig,
    apply_gradients,
    build_optimizer,
    global_norm,
    load_optimizer_state,
)


@dataclass(frozen=True)
class MeanTeacherConfig:
    # batch composition (strong includes synth, as the reference folds them)
    strong_num: int = 4
    weak_num: int = 4
    unlabel_num: int = 4
    net_pooling: int = 1
    # loss weights (config/mat-sed/base/finetune1.yaml 'training' section)
    w_weak: float = 0.5
    w_weak_cons: float = 1.0
    w_at: float = 0.2
    w_cons_max: float = 40.0
    w_cons_min: float = 0.0
    self_loss_warmup_steps: int = 1000
    cons_scheduler: str = "Sigmoid"  # or "Linear"
    ema_factor: float = 0.999
    # augmentation
    mixup_prob: float = 0.5
    mixup_alpha: float = 10.0
    mixup_beta: float = 0.5
    max_shift_frame: int = 90
    n_transform: int = 2  # 0: no aug; 1: same view for stu/tch; 2: distinct views
    transform_choice: Tuple[int, int, int, int] = (1, 0, 0, 0)
    filter_db_range: Tuple[float, float] = (-0.5, 0.5)
    filter_bands: Tuple[int, int] = (3, 6)
    filter_minimum_bandwidth: int = 6
    filter_type: str = "step"
    freq_mask_ratio: Optional[int] = None
    noise_snrs: Optional[Tuple[float, float]] = None
    # model forward kwargs
    stu_kwargs: Dict[str, Any] = field(default_factory=dict)
    tch_kwargs: Dict[str, Any] = field(default_factory=dict)

    @property
    def batch_size(self) -> int:
        return self.strong_num + self.weak_num + self.unlabel_num


def consistency_weight(step: int, cfg: MeanTeacherConfig) -> float:
    """w_cons ramp (reference ``get_self_weight``, ``finetune/train.py:96-115``)."""
    warm = min(max(step / max(cfg.self_loss_warmup_steps, 1), 0.0), 1.0)
    if cfg.cons_scheduler == "Sigmoid":
        warm = 1.0 / (1.0 + math.exp(-10.0 * (warm - 0.5))) if warm < 1.0 else 1.0
    elif cfg.cons_scheduler != "Linear":
        raise ValueError(f"unknown cons scheduler {cfg.cons_scheduler!r}")
    return max(cfg.w_cons_max * warm, cfg.w_cons_min)


def pool_strong_labels(labels: torch.Tensor) -> torch.Tensor:
    """[N, C, T] strong grid -> [N, C] weak labels by linear-softmax pooling
    (reference ``pool_strong_labels``, ``finetune/train.py:26-29``)."""
    x = torch.clamp(labels, 1e-5, 1.0)
    return torch.clamp((x * x).sum(-1) / x.sum(-1), 1e-7, 1.0)


def preprocess(frontend, cfg: MeanTeacherConfig, batch: Dict[str, Any], gen: torch.Generator,
               device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frontend and augmentation: (student mel, teacher mel, labels, weak
    tags) on ``device``. Mixup draws an independent Beta coefficient and
    permutation per subset (the reference draws inside its per-mask loop,
    ``train.py:78-80``), applied to both with one probability draw."""
    s, w = cfg.strong_num, cfg.weak_num
    wav = torch.as_tensor(batch["wav"]).to(device)
    labels = torch.as_tensor(batch["labels"]).to(device=device, dtype=torch.float32)
    mel = frontend.normalize(frontend(wav, frontend.draw_fminmax(gen)))
    b = mel.shape[0]

    shifts = augment.draw_frame_shift(gen, b, cfg.max_shift_frame)
    mel, labels = augment.frame_shift(mel, shifts, labels, net_pooling=cfg.net_pooling)

    if cfg.mixup_prob > 0:
        do_mix = float(torch.rand((), generator=gen, device=gen.device)) < cfg.mixup_prob
        for lo, hi in ((0, s), (s, s + w)):
            if hi - lo <= 0:  # an empty subset: the reference's mixup is a no-op
                continue
            perm, c = augment.draw_mixup(gen, hi - lo, cfg.mixup_alpha, cfg.mixup_beta)
            if do_mix:
                m, lab = augment.mixup(mel[lo:hi], perm, c, labels[lo:hi])
                mel = torch.cat([mel[:lo], m, mel[hi:]])
                labels = torch.cat([labels[:lo], lab, labels[hi:]])

    if cfg.n_transform == 0:
        stu_mel = tch_mel = mel
    else:
        views = augment.draw_feature_transformation(
            gen, mel.shape, cfg.n_transform, cfg.transform_choice,
            filter_db_range=cfg.filter_db_range, filter_bands=cfg.filter_bands,
            filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
            filter_type=cfg.filter_type, freq_mask_ratio=cfg.freq_mask_ratio,
            noise_snrs=cfg.noise_snrs,
        )
        out = augment.feature_transformation(
            mel, views, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
            filter_type=cfg.filter_type, norm_std=5.0)
        stu_mel, tch_mel = (out, out) if cfg.n_transform == 1 else out

    # weak labels: tag-sum over the weak rows (the reference's pooled weak
    # labels for the strong rows feed no loss and are not built)
    weak_tags = labels[s:s + w].sum(-1)
    return stu_mel, tch_mel, labels, weak_tags


def mean_teacher_losses(stu, tch, labels: torch.Tensor, weak_tags: torch.Tensor, step: int,
                        cfg: MeanTeacherConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) of the reference's six losses; ``step`` is the
    number of completed optimizer steps (w_cons reads step + 1, the
    reference's ``scheduler.step_num``, ``train.py:103,178``)."""
    s, w = cfg.strong_num, cfg.weak_num
    zero = stu.strong.new_zeros(())
    loss_class_strong = L.bce(stu.strong[:s], labels[:s]) if s > 0 else zero
    loss_class_weak = L.bce(stu.weak[s:s + w], weak_tags) if w > 0 else zero
    loss_class_at = L.bce(stu.at_out[s:s + w], weak_tags) if w > 0 else zero
    loss_cons_strong = L.mse(stu.strong, tch.strong)
    loss_cons_weak = L.mse(stu.weak, tch.at_out)
    loss_cons_at = L.mse(stu.at_out, tch.at_out)
    w_cons = consistency_weight(step + 1, cfg)
    self_loss = (loss_cons_strong + cfg.w_weak_cons * loss_cons_weak
                 + cfg.w_at * loss_cons_at) * w_cons
    total = loss_class_strong + cfg.w_weak * loss_class_weak + self_loss + cfg.w_at * loss_class_at
    metrics = {
        "loss_total": total,
        "loss_class_strong": loss_class_strong,
        "loss_class_weak": loss_class_weak,
        "loss_class_at_specific": loss_class_at,
        "loss_cons_strong": loss_cons_strong,
        "loss_cons_weak": loss_cons_weak,
        "loss_cons_at_specific": loss_cons_at,
    }
    return total, {k: v.detach() for k, v in metrics.items()} | {"w_cons": w_cons}


class MeanTeacherTrainer:
    """Student, EMA teacher, AdamW and schedule; :meth:`step` runs one
    train step. The teacher starts as a copy of the student."""

    def __init__(self, model: torch.nn.Module, frontend, cfg: MeanTeacherConfig,
                 optim_cfg: ParamGroupConfig = ParamGroupConfig(),
                 schedule: Optional[Callable[[int], float]] = None, accum_steps: int = 1):
        self.student = model.train()
        self.teacher = copy.deepcopy(model).requires_grad_(False)
        self.frontend = frontend
        self.cfg = cfg
        self.optim_cfg = optim_cfg
        self.optimizer, self.scheduler, self.labels = build_optimizer(model, optim_cfg, schedule)
        self.accumulator = GradientAccumulator(accum_steps) if accum_steps > 1 else None
        self.device = next(model.parameters()).device
        self.step_count = 0  # applied optimizer steps
        self.mesh = None  # a parallel.Mesh, set by parallel.shard_train_step
        self.sharded = sharded_param_ids(model)

    def models(self):
        return self.student, self.teacher

    def forward_backward(self, batch: Dict[str, Any],
                         generator: torch.Generator) -> Dict[str, Any]:
        """Preprocess, the teacher forward, the student forward and the
        backward of the total loss into the student's ``.grad``; returns the
        losses (0-d tensors on the device), ``w_cons`` and ``grad_norm``.
        Under a mesh: this rank's rows, the gradients averaged and the losses
        reported as their mean over the ``data`` group."""
        cfg = self.cfg
        stu_mel, tch_mel, labels, weak_tags = preprocess(self.frontend, cfg, batch, generator,
                                                         self.device)
        draws = {}
        if self.mesh is not None:
            sizes = (cfg.strong_num, cfg.weak_num, cfg.unlabel_num)
            rows = self.mesh.batch_rows(sizes).to(self.device)
            # the models' per-row draws, for the global batch
            draws["rows"] = BatchRows(rows, stu_mel.shape[0])
            stu_mel, tch_mel, labels = (x.index_select(0, rows) for x in (stu_mel, tch_mel, labels))
            s, w, u = self.mesh.local_sizes(sizes)
            weak_tags = labels[s:s + w].sum(-1)  # this rank's weak rows of the global tags
            cfg = dataclasses.replace(cfg, strong_num=s, weak_num=w, unlabel_num=u)
        with torch.no_grad():
            tch = self.teacher(tch_mel, train=True, generator=generator, **draws,
                               **cfg.tch_kwargs)
        stu = self.student(stu_mel, train=True, generator=generator, **draws, **cfg.stu_kwargs)
        total, metrics = mean_teacher_losses(stu, tch, labels, weak_tags, self.step_count, cfg)
        self.student.zero_grad(set_to_none=True)  # frozen params too: they are in no group
        total.backward()
        if self.mesh is not None:
            self.mesh.average_gradients(self.student.parameters())
            metrics = self.mesh.mean_metrics(metrics)
        metrics["grad_norm"] = global_norm(self.student.parameters(), self.mesh, self.sharded)
        return metrics

    def step(self, batch: Dict[str, Any], generator: torch.Generator) -> Dict[str, Any]:
        """One train step on ``batch`` (``wav`` [B, S], ``labels`` [B, C, T_lab]
        in [strong | weak | unlabeled] order): :meth:`forward_backward`,
        clip, AdamW, the schedule and the EMA update (under accumulation,
        only on every k-th step); returns its metrics."""
        metrics = self.forward_backward(batch, generator)
        if not apply_gradients(self.optimizer, self.scheduler, self.optim_cfg.clip_grad,
                               self.accumulator, self.mesh, self.sharded):
            return metrics
        # the reference's EMA counter is scheduler.step_num = completed
        # steps + 1, stepped before the update: the first update reads 2
        ema_update(self.student.parameters(), self.teacher.parameters(), self.step_count + 2,
                   self.cfg.ema_factor)
        self.step_count += 1
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs (``utils/checkpoint.py:save_checkpoint``)."""
        return {"student": self.student.state_dict(), "teacher": self.teacher.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step_count,
                "accum": None if self.accumulator is None else self.accumulator.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.student.load_state_dict(state["student"])
        self.teacher.load_state_dict(state["teacher"])
        load_optimizer_state(self, state)
