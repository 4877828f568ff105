"""CLAP-SED recipe: common-only supervised training of the CLAP query head
(port of ``recipes/clap.py``; upstream ``recipes/audioset_strong/clap/``).

  * :class:`ClapStep`, ``make_clap_step`` on :class:`SupervisedStep`'s
    chassis (``clap/train.py:14-59``): the HTSAT frontend's [B, 1, T, F]
    log-mel in the augmentations' [B, F, T] layout, the labels cut to the
    common classes, the frame shift with the integer ``net_pooling =
    max(round(T / T_lab), 1)`` (31 at ``pred_len: 32`` on 1001 mel frames),
    the whole-batch Beta mixup, one filt_aug view (``norm_std`` 5), the
    training forward on the common rows of the query bank (bn0 takes the
    batch statistics and moves its running ones), the class loss on the
    strong output alone, backward, clip, AdamW per param group, schedule.
    The frontend's output is not normalised, as in the JAX step. The draws
    are made first (:func:`recipes.audioset_strong.draw_supervised`) and
    applied second, so a test can feed the JAX package's;
  * :class:`CommonOnlyClapTrainer`, the epoch loop of
    :class:`SupervisedTrainer` with that step, validating on the full bank
    (the JAX trainer's ``val_kwargs['query']``).

``text_query`` is a param, as in the JAX module: the step never reads it, so
its gradient is zero and AdamW's decoupled decay alone moves it, as JAX's
labels put it in the ``head`` group.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transformer4sed_tpu_torch.core import losses as L
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.recipes.audioset_strong import (
    SupervisedConfig,
    SupervisedDraw,
    SupervisedStep,
    SupervisedTrainer,
    draw_supervised,
    from_feature_layout,
    to_feature_layout,
)


def make_clap_loss_fn(model: torch.nn.Module, frontend, cfg: SupervisedConfig, device,
                      common_idx: Optional[torch.Tensor], common_query: torch.Tensor):
    """``loss_fn(batch, gen, draw=None, dropout_masks=None, rows=None) ->
    (loss, metrics)`` of ``make_clap_step``."""
    loss_of = L.loss_function_factory(cfg.loss_name, cfg.loss_kwargs)

    def loss_fn(batch: Dict, gen: Optional[torch.Generator],
                draw: Optional[SupervisedDraw] = None, dropout_masks=None, rows=None):
        if rows is not None:
            raise NotImplementedError("the CLAP step under several ranks is not ported yet: "
                                      "ROADMAP.md, queue 1, item 15")
        wav = torch.as_tensor(batch["wav"]).to(device)
        labels = torch.as_tensor(batch["labels"]).to(device=device, dtype=torch.float32)
        if common_idx is not None:
            labels = labels.index_select(1, common_idx)
        fminmax = draw.fminmax if draw is not None else frontend.draw_fminmax(gen)
        mel, was_4d = to_feature_layout(frontend(wav, fminmax))
        if draw is None:
            draw = draw_supervised(gen, cfg, mel.shape, fminmax)
        net_pooling = max(int(round(mel.shape[-1] / labels.shape[-1])), 1)
        mel, labels = augment.frame_shift(mel, draw.shifts, labels, net_pooling=net_pooling)
        if draw.do_mix:
            mel, labels = augment.mixup(mel, draw.perm, draw.c, labels)
        mel = augment.feature_transformation(
            mel, draw.views, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
            filter_type=cfg.filter_type, norm_std=5.0)
        out = model(from_feature_layout(mel, was_4d), train=True, query=common_query,
                    **cfg.model_kwargs)
        loss_strong = loss_of(out.strong.float(), labels)
        return loss_strong, {"loss_class_strong": loss_strong.detach()}

    return loss_fn


class ClapStep(SupervisedStep):
    """``make_clap_step`` on a CLAP_SED: :class:`SupervisedStep`'s state,
    optimizer and schedule with the CLAP loss. ``common_mask``: length-C
    bool, True = common (None: every class); ``query_bank``: [C, query_dim]
    frozen text embeddings in the codec's class order."""

    def __init__(self, model, frontend, cfg: SupervisedConfig, optim_cfg, schedule=None,
                 accum_steps: int = 1, common_mask=None, query_bank=None):
        if query_bank is None:
            raise ValueError("the CLAP step needs the query bank (dataset.query_bank)")
        device = next(model.parameters()).device
        bank = torch.as_tensor(np.asarray(query_bank, np.float32)).to(device)
        self.common_idx = None
        if common_mask is not None:
            self.common_idx = torch.as_tensor(
                np.flatnonzero(np.asarray(common_mask, dtype=bool)), device=device)
            bank = bank.index_select(0, self.common_idx)
        self.common_query = bank
        super().__init__(model, frontend, cfg, optim_cfg, schedule, accum_steps)

    def make_loss_fn(self):
        return make_clap_loss_fn(self.model, self.frontend, self.cfg, self.device,
                                 self.common_idx, self.common_query)


class CommonOnlyClapTrainer(SupervisedTrainer):
    """The CLAP-SED epoch loop (``clap/train.py:10-59`` on the supervised
    chassis): training on the common classes with the common slice of the
    bank, validation on the full bank. ``query_bank``: [C, query_dim] in the
    codec's class order; ``common_mask``: length-C bool, True = common."""

    def __init__(self, *args, common_mask=None, query_bank=None, **kwargs):
        if common_mask is None or query_bank is None:
            raise ValueError("CommonOnlyClapTrainer requires common_mask and query_bank")
        self.common_mask = np.asarray(common_mask, dtype=bool)
        self.query_bank = np.asarray(query_bank, np.float32)
        super().__init__(*args, **kwargs)
        self.val_query = torch.from_numpy(self.query_bank).to(self.device)

    def make_step(self, pg, schedule, accum: int) -> ClapStep:
        cls_loss = self.config.get("class_loss", {})
        cfg = SupervisedConfig(
            loss_name=cls_loss.get("loss_name", "BCELoss"), loss_kwargs=cls_loss.get("kwargs"),
            transform_choice=tuple(self.config["training"].get("transform", {}).get(
                "choice", (1, 0, 0, 0))),
            model_kwargs=self.model_kwargs("train_kwargs"))
        return ClapStep(self.model, self.frontend, cfg, pg, schedule, accum,
                        common_mask=self.common_mask, query_bank=self.query_bank)

    @torch.no_grad()
    def eval_forward(self, mel, pad_mask):
        out = self.model(mel, pad_mask=pad_mask, **{**self.model_kwargs("val_kwargs"),
                                                     "query": self.val_query})
        return out.strong, out.at_out
