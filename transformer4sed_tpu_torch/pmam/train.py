"""PMAM prototype-BCE post-pretraining step (port of ``pmam/train.py``).

Reference hot loop (``recipes/desed/pmam/train.py:82-143``): the model runs
its MLM path; the reconstruction is compared with the GMM prototypes
(:func:`prototype_predictions`), trained with BCE against the frame-wise
pseudo-labels at masked positions only (:func:`masked_bce`), plus ``w_at``
times the weak BCE of the AT branch. The step order is the JAX package's
``make_pmam_step``: the frontend's training draw, normalise, frame shift of
the mel and the labels, one feature-transformation view, the forward in
training mode with its patchout, dropout and mask draws, the losses,
backward, clip, AdamW, the schedule. The CNN branch's BatchNorm statistics
move with the training-mode forward, as in the PMAM mean-teacher step. Only
the LoRA factors, the decoder and the heads train (``opt.lora_trainable``
with the encoder's lr 0, ``train/optim.py``); the gradient crosses the frozen
backbone to reach the factors. The step's draws come from the generator
passed to it; ``forward_kwargs`` (``mlm_draws``, ``patchout_draws``,
``dropout_masks``) hand the model's own in instead. One process: the step
raises under a mesh (ROADMAP.md, queue 1, item 8a).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from transformer4sed_tpu_torch.core import losses as L
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.train.mlm import MLMTrainer
from transformer4sed_tpu_torch.train.optim import ParamGroupConfig, global_norm


def prototype_predictions(logit: torch.Tensor, gmm_means: torch.Tensor,
                          temperature: float = 0.1) -> torch.Tensor:
    """[B, T, C] reconstruction x [K, C] prototypes -> [B, T, K] probabilities,
    in float32. Only the logit side is L2-normalised (norm clamped at 1e-12,
    ``F.normalize``): the GMM means keep their magnitudes, as upstream
    (``train.py:82-87``); then ``sigmoid((leaky_relu(sim, 0.2) * 2 - 1) / T)``."""
    logit = logit.float()
    logit_n = logit / torch.clamp(torch.linalg.vector_norm(logit, dim=-1, keepdim=True),
                                  min=1e-12)
    sim = torch.einsum("btc,kc->btk", logit_n, gmm_means.float())
    return torch.sigmoid((F.leaky_relu(sim, negative_slope=0.2) * 2.0 - 1.0) / temperature)


def masked_bce(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BCE over the masked frames only: pred and target [B, T, K], mask [B, T];
    the shared NaN-safe log (``core/losses.py:safe_log``)."""
    losses = -(target * L.safe_log(pred) + (1.0 - target) * L.safe_log(1.0 - pred))
    mask = mask.to(losses.dtype)
    return (losses.mean(-1) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@dataclass(frozen=True)
class PMAMConfig:
    temperature: float = 0.1
    w_at: float = 0.0
    max_shift_frame: int = 90
    transform_choice: Tuple[int, int, int, int] = (1, 0, 0, 0)
    filter_db_range: Tuple[float, float] = (-0.5, 0.5)
    filter_bands: Tuple[int, int] = (3, 6)
    filter_minimum_bandwidth: int = 6
    filter_type: str = "step"
    net_pooling: int = 1
    model_kwargs: Dict[str, Any] = field(default_factory=dict)


def preprocess(frontend, cfg: PMAMConfig, batch: Dict[str, Any], gen: torch.Generator,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frontend, frame shift of the mel and the labels, one transformation
    view: (mel, labels [B, K, T]) on ``device``."""
    wav = torch.as_tensor(batch["wav"]).to(device)
    labels = torch.as_tensor(batch["labels"]).to(device=device, dtype=torch.float32)
    mel = frontend.normalize(frontend(wav, frontend.draw_fminmax(gen)))
    shifts = augment.draw_frame_shift(gen, mel.shape[0], cfg.max_shift_frame)
    mel, labels = augment.frame_shift(mel, shifts, labels, net_pooling=cfg.net_pooling)
    views = augment.draw_feature_transformation(
        gen, mel.shape, 1, cfg.transform_choice, filter_db_range=cfg.filter_db_range,
        filter_bands=cfg.filter_bands, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
        filter_type=cfg.filter_type)
    mel = augment.feature_transformation(mel, views,
                                         filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
                                         filter_type=cfg.filter_type, norm_std=5.0)
    return mel, labels


class PMAMTrainer(MLMTrainer):
    """The model in MLM mode against the GMM prototypes: the MLM trainer's
    AdamW, schedule, accumulation, :meth:`step` and state, with the
    prototype-BCE loss in :meth:`forward_backward`."""

    def __init__(self, model: torch.nn.Module, frontend, gmm_means,
                 cfg: PMAMConfig = PMAMConfig(), optim_cfg: ParamGroupConfig = ParamGroupConfig(),
                 schedule: Optional[Callable[[int], float]] = None, accum_steps: int = 1):
        if getattr(model, "masker", None) is None:
            raise ValueError("PMAM post-pretraining needs the model's MLM head (mlm=True)")
        super().__init__(model, frontend, cfg, optim_cfg, schedule, accum_steps)
        self.gmm_means = torch.as_tensor(np.asarray(gmm_means), dtype=torch.float32,
                                         device=self.device)
        out_dim = model.mlm_mlp[2].out_features
        if self.gmm_means.shape[-1] != out_dim:
            raise ValueError(
                f"the GMM's means are {self.gmm_means.shape[-1]} wide but the MLM head predicts "
                f"{out_dim}: mlm_dict.out_dim must be the width of the tokenizer's tap")

    def forward_backward(self, batch: Dict[str, Any], generator: torch.Generator,
                         **forward_kwargs) -> Dict[str, torch.Tensor]:
        """Preprocess, the masked forward, the losses and their backward into
        ``.grad``; returns ``loss_total``, ``loss_strong``, ``loss_weak``,
        the masked share of the frames and ``grad_norm`` (0-d tensors). One
        process only (``batch`` [B, S] with ``labels`` [B, K, T] pseudo-labels)."""
        if self.mesh is not None:
            raise NotImplementedError("the PMAM step under several ranks is not ported yet: "
                                      "ROADMAP.md, queue 1, item 8a")
        cfg = self.cfg
        mel, labels = preprocess(self.frontend, cfg, batch, generator, self.device)
        out = self.model(mel, train=True, generator=generator, **forward_kwargs,
                         **cfg.model_kwargs)
        pred = prototype_predictions(out.mlm_pred, self.gmm_means, cfg.temperature)
        loss_strong = masked_bce(pred, labels.transpose(1, 2), out.mask_id_seq)
        loss_weak = torch.zeros((), device=self.device)
        if cfg.w_at > 0 and out.at_out is not None:
            label_weak = (labels.sum(-1) >= 1).float()
            loss_weak = L.bce(out.at_out.float(), label_weak)
        total = loss_strong + cfg.w_at * loss_weak
        self.model.zero_grad(set_to_none=True)  # frozen params too: they are in no group
        total.backward()
        return {"loss_total": total.detach(), "loss_strong": loss_strong.detach(),
                "loss_weak": loss_weak.detach(),
                "masked_share": out.mask_id_seq.float().mean(),
                "grad_norm": global_norm(self.model.parameters())}
