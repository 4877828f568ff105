"""Masked-reconstruction (MLM) pretraining step, MAT-SED stage 1 (port of
``train/mlm.py``).

The loss is the mean squared error between the decoder's input before
masking and the reconstruction, over the masked frames only
(``recipes/desed/mlm/mlm_passt/train.py:36-38``), as a mask-weighted mean.
The augmentation is the reference MLM trainer's: frame shift and one
``feature_transformation`` view (``mlm_passt/train.py:24-33``). The step
order is the JAX package's ``make_mlm_step``: the frontend's training draw,
normalise, frame shift, one view, the forward in training mode (which draws
the mask), the masked MSE, backward, clip, AdamW, the schedule.

Two choices of the JAX package are kept (``PARITY.md``): the masking really
masks (the reference's in-place write is lost), and the target
``frame_before_mask`` is not detached, so the f-pool and projector modules
learn from both branches. A frozen group (the pretrain recipe freezes the
encoder with ``lr: 0``) is left out of the optimizer and of the clip norm.
With ``accum_steps`` k the gradients of k steps are averaged and applied on
the k-th (``train/optim.py:GradientAccumulator``), and the step count
advances only then (the JAX step's ``step_increment``).

Under data parallelism (``parallel.shard_train_step``) every rank runs
:func:`preprocess` on the global batch with the same generator and keeps its
share of the rows; the model draws dropout, DropPath and the mask for the
global batch (``models/cnn.py:BatchRows``), and the masker's random tokens
come from the whole batch through a differentiable gather
(``parallel.Mesh.gather_rows``). The loss divides each rank's masked squares
by the masked count of the global batch, so the mean of the ranks' losses
and gradients over the ``data`` group is the one-process step's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

import torch.distributed as dist

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


def mlm_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             masked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error over masked frames only. pred/target [B, T, C],
    mask [B, T] (bool or float); ``masked``: the masked-frame count to divide
    by (default: ``mask``'s own)."""
    mask = mask.to(pred.dtype)
    sq = ((pred - target) ** 2).sum(-1)
    count = mask.sum() if masked is None else masked.to(pred.dtype)
    denom = torch.clamp(count, min=1.0) * pred.shape[-1]
    return (sq * mask).sum() / denom


@dataclass(frozen=True)
class MLMConfig:
    max_shift_frame: int = 90
    transform_choice: Tuple[int, int, int, int] = (1, 0, 0, 0)
    filter_db_range: Tuple[float, float] = (-0.5, 0.5)
    filter_bands: Tuple[int, int] = (3, 6)
    filter_minimum_bandwidth: int = 6
    filter_type: str = "step"
    freq_mask_ratio: Optional[int] = None
    noise_snrs: Optional[Tuple[float, float]] = None
    model_kwargs: Dict[str, Any] = field(default_factory=dict)


def preprocess(frontend, cfg: MLMConfig, batch: Dict[str, Any], gen: torch.Generator,
               device) -> torch.Tensor:
    """Frontend, frame shift and one transformation view: the mel on ``device``."""
    wav = torch.as_tensor(batch["wav"]).to(device)
    mel = frontend.normalize(frontend(wav, frontend.draw_fminmax(gen)))
    shifts = augment.draw_frame_shift(gen, mel.shape[0], cfg.max_shift_frame)
    mel = augment.frame_shift(mel, shifts)
    views = augment.draw_feature_transformation(
        gen, mel.shape, 1, cfg.transform_choice, filter_db_range=cfg.filter_db_range,
        filter_bands=cfg.filter_bands, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
        filter_type=cfg.filter_type, freq_mask_ratio=cfg.freq_mask_ratio,
        noise_snrs=cfg.noise_snrs)
    return augment.feature_transformation(
        mel, views, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
        filter_type=cfg.filter_type, norm_std=5.0)


class MLMTrainer:
    """The model in MLM mode, AdamW and its schedule; :meth:`step` runs one
    pretraining step on the model's device. The random numbers of a step come
    from the generator passed to it; ``forward_kwargs`` (``mlm_draws``,
    ``patchout_draws``) hand the model's own draws in instead."""

    def __init__(self, model: torch.nn.Module, frontend, cfg: MLMConfig = MLMConfig(),
                 optim_cfg: ParamGroupConfig = ParamGroupConfig(),
                 schedule: Optional[Callable[[int], float]] = None, accum_steps: int = 1):
        self.model = model.train()
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
        return (self.model,)

    def forward_backward(self, batch: Dict[str, Any], generator: torch.Generator,
                         **forward_kwargs) -> Dict[str, Any]:
        """Preprocess, the masked forward and the backward of the loss into
        ``.grad``; returns ``loss_mlm``, the masked share of the frames and
        ``grad_norm`` (0-d tensors on the device). Under a mesh: this rank's
        rows, the gradients averaged and the metrics reported as their mean
        over the ``data`` group."""
        mel = preprocess(self.frontend, self.cfg, batch, generator, self.device)
        mesh = self.mesh
        if mesh is not None:
            total = mel.shape[0]
            rows = mesh.batch_rows((total,)).to(self.device)
            forward_kwargs = {"rows": BatchRows(
                rows, total, lambda x: mesh.gather_rows(x, rows, total)), **forward_kwargs}
            mel = mel.index_select(0, rows)
        out = self.model(mel, train=True, generator=generator, **forward_kwargs,
                         **self.cfg.model_kwargs)
        masked = None
        if mesh is not None:  # the global batch's masked count, times the ranks averaged over
            masked = out.mask_id_seq.float().sum().reshape(1)
            dist.all_reduce(masked, op=dist.ReduceOp.SUM, group=mesh.data_group)
            masked = masked[0] / mesh.data
        loss = mlm_loss(out.mlm_pred.float(), out.frame_before_mask.float(), out.mask_id_seq,
                        masked)
        self.model.zero_grad(set_to_none=True)  # frozen params too: they are in no group
        loss.backward()
        metrics = {"loss_mlm": loss.detach(), "masked_share": out.mask_id_seq.float().mean()}
        if mesh is not None:
            mesh.average_gradients(self.model.parameters())
            metrics = mesh.mean_metrics(metrics)
        metrics["grad_norm"] = global_norm(self.model.parameters(), mesh, self.sharded)
        return metrics

    def step(self, batch: Dict[str, Any], generator: torch.Generator,
             **forward_kwargs) -> Dict[str, Any]:
        """One pretraining step on ``batch`` (``wav`` [B, S]):
        :meth:`forward_backward`, clip, AdamW, the schedule (under
        accumulation, only on every k-th step)."""
        metrics = self.forward_backward(batch, generator, **forward_kwargs)
        if apply_gradients(self.optimizer, self.scheduler, self.optim_cfg.clip_grad,
                           self.accumulator, self.mesh, self.sharded):
            self.step_count += 1
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs (``utils/checkpoint.py:save_checkpoint``)."""
        return {"student": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step_count,
                "accum": None if self.accumulator is None else self.accumulator.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["student"])
        load_optimizer_state(self, state)
