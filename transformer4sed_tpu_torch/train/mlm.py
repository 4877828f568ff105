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
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.train.optim import (
    ParamGroupConfig,
    build_optimizer,
    clip_by_global_norm,
    global_norm,
    live_params,
)


def mlm_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over masked frames only. pred/target [B, T, C],
    mask [B, T] (bool or float)."""
    mask = mask.to(pred.dtype)
    sq = ((pred - target) ** 2).sum(-1)
    denom = torch.clamp(mask.sum(), min=1.0) * pred.shape[-1]
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
                 schedule: Optional[Callable[[int], float]] = None):
        self.model = model.train()
        self.frontend = frontend
        self.cfg = cfg
        self.optim_cfg = optim_cfg
        self.optimizer, self.scheduler, self.labels = build_optimizer(model, optim_cfg, schedule)
        self.device = next(model.parameters()).device
        self.step_count = 0  # completed optimizer steps

    def forward_backward(self, batch: Dict[str, Any], generator: torch.Generator,
                         **forward_kwargs) -> Dict[str, Any]:
        """Preprocess, the masked forward and the backward of the loss into
        ``.grad``; returns ``loss_mlm``, the masked share of the frames and
        ``grad_norm`` (0-d tensors on the device)."""
        mel = preprocess(self.frontend, self.cfg, batch, generator, self.device)
        out = self.model(mel, train=True, generator=generator, **forward_kwargs,
                         **self.cfg.model_kwargs)
        loss = mlm_loss(out.mlm_pred.float(), out.frame_before_mask.float(), out.mask_id_seq)
        self.model.zero_grad(set_to_none=True)  # frozen params too: they are in no group
        loss.backward()
        return {"loss_mlm": loss.detach(), "masked_share": out.mask_id_seq.float().mean(),
                "grad_norm": global_norm(self.model.parameters())}

    def step(self, batch: Dict[str, Any], generator: torch.Generator,
             **forward_kwargs) -> Dict[str, Any]:
        """One pretraining step on ``batch`` (``wav`` [B, S]):
        :meth:`forward_backward`, clip, AdamW, the schedule."""
        metrics = self.forward_backward(batch, generator, **forward_kwargs)
        if self.optim_cfg.clip_grad:
            clip_by_global_norm(live_params(self.optimizer), self.optim_cfg.clip_grad)
        self.optimizer.step()
        self.scheduler.step()
        self.step_count += 1
        return metrics
