"""AudioSet-strong recipe: the supervised strong-label train step (port of
the step of ``recipes/audioset_strong.py``).

``recipes/audioset_strong/base/passt_cnn/train.py``'s loop body for
HTSAT_CNN: frontend -> frame shift (labels on their own, finer grid) ->
whole-batch mixup -> one filt_aug view -> model forward in training mode
(BatchNorm batch statistics, running statistics carried in the model's
buffers from step to step, CNN dropout) -> class loss on the strong
output -> backward -> global-norm clip -> AdamW per param group -> LR
schedule.

The random numbers of a step are drawn first (:func:`draw_supervised`, from
a ``torch.Generator``) and applied second, so a test can feed the draws of
another implementation. The ``SupervisedTrainer`` epoch loop, the
weighted sampler, the label tables and validation come with the data and
eval slices (ROADMAP.md, queue 1, items 3, 4 and 9).

Under data parallelism (``parallel.shard_train_step``) every rank
preprocesses the global batch with the same generator and keeps its
contiguous block of rows (as ``train/mean_teacher.py`` does, for the same
reason: the whole-batch mixup pairs rows across ranks); BatchNorm takes the
global batch's statistics and the gradients are averaged over the ``data``
group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


from transformer4sed_tpu_torch.core import losses as L
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models.cnn import BatchRows
from transformer4sed_tpu_torch.parallel.partition import sharded_param_ids
from transformer4sed_tpu_torch.train.optim import (
    ParamGroupConfig,
    build_optimizer,
    clip_by_global_norm,
    global_norm,
    live_params,
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
                    fminmax: Optional[Tuple[float, float]] = None) -> SupervisedDraw:
    """Draw for a [B, F, T] mel batch: per-sample shifts of at most half the
    clip, one Beta(alpha, beta) coefficient, one permutation and one
    probability draw for the whole batch, one transformation view.
    ``fminmax`` is the frontend's own draw, made before the mel exists."""
    b, _, t = mel_shape
    shifts = augment.draw_frame_shift(gen, b, min(cfg.max_shift_frame, t // 2))
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
                 schedule: Optional[Callable[[int], float]] = None):
        self.model = model.train()
        self.frontend = frontend
        self.cfg = cfg
        self.optim_cfg = optim_cfg
        self.optimizer, self.scheduler, self.labels = build_optimizer(model, optim_cfg, schedule)
        self.device = next(model.parameters()).device
        self.loss_fn = make_supervised_loss_fn(model, frontend, cfg, self.device)
        self.step_count = 0  # completed optimizer steps
        self.mesh = None  # a parallel.Mesh, set by parallel.shard_train_step
        self.sharded = sharded_param_ids(model)

    def models(self):
        return (self.model,)

    def forward_backward(self, batch: Dict[str, Any], generator: Optional[torch.Generator],
                         draw: Optional[SupervisedDraw] = None,
                         dropout_masks=None) -> Dict[str, Any]:
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
        loss, metrics = self.loss_fn(batch, generator, draw, dropout_masks, rows)
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
             draw: Optional[SupervisedDraw] = None, dropout_masks=None) -> Dict[str, Any]:
        """One train step on ``batch`` (``wav`` [B, S], ``labels``
        [B, C, T_lab]): :meth:`forward_backward`, clip, AdamW, the schedule."""
        metrics = self.forward_backward(batch, generator, draw, dropout_masks)
        if self.optim_cfg.clip_grad:
            clip_by_global_norm(live_params(self.optimizer), self.optim_cfg.clip_grad, self.mesh,
                                self.sharded)
        self.optimizer.step()
        self.scheduler.step()
        self.step_count += 1
        return metrics
