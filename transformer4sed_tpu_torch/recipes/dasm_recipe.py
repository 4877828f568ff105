"""DASM recipes: closed-set AudioSet-strong training, open-vocabulary
training and zero-shot open-set evaluation (port of ``recipes/dasm_recipe.py``).

  * :class:`DASMStep`, the closed-set step (upstream
    ``recipes/audioset_strong/detect_any_sound/passt/train.py:36-282``):
    frontend -> frame shift -> whole-batch mixup -> one filt_aug view ->
    the training forward -> strong BCE plus ``w_AT`` times the AT branch's
    loss, CE over the (C+1)-way per-query logits against
    :func:`models.dasm.multi_label_to_multi_class` of the weak labels
    (``out_type='logit'``) or BCE on its sigmoid -> backward -> clip ->
    AdamW per param group -> schedule. In open-vocabulary mode
    (``common_mask``) the labels keep the common classes only, and a
    learnable-query model runs on the common slice of its ``at_query`` bank,
    taken inside the loss so that its gradient reaches the bank. The draws
    (frontend, shift, mixup, filt_aug; the model's modality pick and AT
    dropout masks) are made first and applied second, so a test can feed the
    JAX package's;
  * :class:`DASMTrainer` and :class:`OVDASMTrainer`, epoch loops on
    ``recipes/audioset_strong.py:SupervisedTrainer``. The open-vocabulary one
    (upstream ``open_vocabulary.py:16-305``) trains on the common classes and
    validates every query in common-first order under
    :func:`open_vocab_att_mask` (a rare query sees the common ones and
    itself), reorders the predictions back and reports ``psds``, the AT
    branch's macro mAP and ``psds_common`` / ``psds_rare``;
  * :func:`openset_evaluate` (upstream ``openset_evaluation.py:66-215``): the
    novel classes' queries appended to the bank, the extended vocabulary
    detected zero-shot.

Where the port departs from the JAX trainer: whether the open-vocabulary
step slices ``at_query`` in the loss is read from the model (no projectors:
a learnable bank), where the JAX trainer reads the config's
``at_param.query_projector``, which ``config/dasm/open_vocab.yaml`` does not
set; the JAX step then reads an ``at_query`` that a projector model lacks
(ROADMAP.md, queue 3). Where the JAX trainer runs, the two agree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from transformer4sed_tpu_torch.core import losses as L
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models.dasm import multi_label_to_multi_class
from transformer4sed_tpu_torch.recipes.audioset_strong import (
    SupervisedDraw,
    SupervisedStep,
    SupervisedTrainer,
    drop_absent_classes,
    draw_supervised,
    psds_at_alpha_zero,
    split_psds_by_type,
)
from transformer4sed_tpu_torch.train.mean_teacher import pool_strong_labels


# -- open-vocabulary query utilities -------------------------------------------------

def common_first_order(common_mask) -> np.ndarray:
    """The permutation that puts the common classes before the rare ones."""
    common_mask = np.asarray(common_mask, dtype=bool)
    return np.concatenate([np.flatnonzero(common_mask), np.flatnonzero(~common_mask)])


def reorder_pred(pred: torch.Tensor, common_mask) -> torch.Tensor:
    """Undo the common-first order on axis 1 (upstream ``reorder_pred``)."""
    inverse = np.argsort(common_first_order(common_mask))
    return pred.index_select(1, torch.as_tensor(inverse, device=pred.device))


def open_vocab_att_mask(common_mask) -> np.ndarray:
    """[Q, Q] bool self-attention mask (True = blocked) for the common-first
    order: every query may attend the common queries and itself, the rare
    ones are hidden from each other (upstream ``get_att_mask``)."""
    common_mask = np.asarray(common_mask, dtype=bool)
    n, n_common = len(common_mask), int(common_mask.sum())
    mask = np.ones((n, n), dtype=bool)
    mask[:, :n_common] = False
    np.fill_diagonal(mask, False)
    return mask


def macro_average_precision(preds: np.ndarray, targets: np.ndarray) -> float:
    """Macro mAP over the classes with at least one positive (torchmetrics
    ``MultilabelAveragePrecision(average='macro')``, ``open_vocabulary.py:147``);
    ``preds`` / ``targets`` [N, C] scores and {0, 1} labels."""
    preds = np.asarray(preds, dtype=np.float64)
    targets = np.asarray(targets) > 0.5
    aps = []
    for c in range(preds.shape[1]):
        pos = targets[:, c]
        n_pos = int(pos.sum())
        if n_pos == 0:
            continue
        hits = pos[np.argsort(-preds[:, c], kind="stable")]
        precision = np.cumsum(hits) / (np.arange(hits.shape[0]) + 1)
        aps.append(float((precision * hits).sum() / n_pos))
    return float(np.mean(aps)) if aps else 0.0


# -- the DASM train step --------------------------------------------------------------

@dataclass(frozen=True)
class DASMTrainConfig:
    out_type: str = "sigmoid"  # 'sigmoid' | 'logit'
    w_at: float = 1.0
    net_pooling: int = 1
    max_shift_frame: int = 90
    mixup_prob: float = 0.5
    mixup_alpha: float = 10.0
    mixup_beta: float = 0.5
    transform_choice: Tuple[int, int, int, int] = (1, 0, 0, 0)
    filter_db_range: Tuple[float, float] = (-0.5, 0.5)
    filter_bands: Tuple[int, int] = (3, 6)
    filter_minimum_bandwidth: int = 6
    filter_type: str = "step"
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    # open vocabulary: the common classes (None: closed set)
    common_mask: Optional[Tuple[bool, ...]] = None
    # open vocabulary with learnable queries: the loss slices the model's own
    # at_query to the common classes, so that the bank takes the gradient
    query_from_params: bool = False


def ce_multiclass(at_logits: torch.Tensor, weak_targets: torch.Tensor) -> torch.Tensor:
    """CE of the (C+1)-way per-query logits against the multi-class targets
    of the weak labels (upstream ``train.py:92-96``), in float32."""
    targets = multi_label_to_multi_class(weak_targets.float())
    logp = torch.log_softmax(at_logits.float(), dim=-1)
    return -(targets * logp).sum(-1).mean()


def draw_dasm(gen: torch.Generator, cfg: DASMTrainConfig, mel_shape,
              fminmax=None) -> SupervisedDraw:
    """The preprocess draws of a DASM step: the supervised step's, with the
    shift's spread ``cfg.max_shift_frame`` itself (the JAX step takes it
    whole, where the supervised one caps it at half the clip)."""
    return draw_supervised(gen, cfg, mel_shape, fminmax, max_shift=cfg.max_shift_frame)


class DASMStep(SupervisedStep):
    """``make_dasm_step`` on a DASM model: :class:`SupervisedStep`'s state,
    optimizer and schedule, with DASM's preprocess and loss. ``query``: the
    external query bank of a projector model (one array, or a list per
    modality), passed to every training forward."""

    def __init__(self, model, frontend, cfg: DASMTrainConfig, optim_cfg, schedule=None,
                 accum_steps: int = 1, query=None):
        self.query = query
        super().__init__(model, frontend, cfg, optim_cfg, schedule, accum_steps)

    def make_loss_fn(self):
        model, frontend, cfg, device = self.model, self.frontend, self.cfg, self.device
        common_idx = (None if cfg.common_mask is None else torch.as_tensor(
            np.flatnonzero(np.asarray(cfg.common_mask, dtype=bool)), device=device))

        def loss_fn(batch, gen, draw=None, dropout_masks=None, rows=None, query_pick=None):
            if rows is not None:
                raise NotImplementedError("the DASM step under several ranks is not ported yet: "
                                          "ROADMAP.md, queue 1, item 15")
            wav = torch.as_tensor(batch["wav"]).to(device)
            labels = torch.as_tensor(batch["labels"]).to(device=device, dtype=torch.float32)
            if common_idx is not None:
                labels = labels.index_select(1, common_idx)
            fminmax = draw.fminmax if draw is not None else frontend.draw_fminmax(gen)
            mel = frontend.normalize(frontend(wav, fminmax))
            if draw is None:
                draw = draw_dasm(gen, cfg, mel.shape, fminmax)
            mel, labels = augment.frame_shift(mel, draw.shifts, labels,
                                              net_pooling=cfg.net_pooling)
            if draw.do_mix:
                mel, labels = augment.mixup(mel, draw.perm, draw.c, labels)
            mel = augment.feature_transformation(
                mel, draw.views, filter_minimum_bandwidth=cfg.filter_minimum_bandwidth,
                filter_type=cfg.filter_type, norm_std=5.0)
            labels_weak = pool_strong_labels(labels)
            kwargs = dict(cfg.model_kwargs)
            if self.query is not None:
                kwargs["query"] = self.query
            if common_idx is not None and cfg.query_from_params:
                kwargs["query"] = model.at_query.index_select(0, common_idx)
            out = model(mel, train=True, generator=gen, dropout_masks=dropout_masks,
                        query_pick=query_pick, **kwargs)
            if cfg.out_type == "logit":
                loss_at = ce_multiclass(out.at_out, labels_weak)
            else:
                loss_at = L.bce(out.at_out.float(), labels_weak)
            loss_strong = L.bce(out.strong.float(), labels)
            total = loss_strong + cfg.w_at * loss_at
            return total, {"loss_total": total.detach(),
                           "loss_class_strong": loss_strong.detach(),
                           "loss_class_at_specific": loss_at.detach()}

        return loss_fn


# -- epoch loops ----------------------------------------------------------------------

def _bank_on(bank, device):
    """A query bank (one array, or a list per modality) as f32 tensors on ``device``."""
    if bank is None:
        return None
    if isinstance(bank, (list, tuple)):
        return [_bank_on(b, device) for b in bank]
    return torch.as_tensor(np.asarray(bank, np.float32)).to(device)


class DASMTrainer(SupervisedTrainer):
    """Closed-set DASM epoch loop (upstream
    ``recipes/audioset_strong/detect_any_sound/passt/train.py``): the
    supervised AudioSet-strong loop with :class:`DASMStep`. ``query_bank``:
    a projector model's external query tensors (one [C, d] array per
    modality; a list trains on one modality per query, drawn each step, and
    evaluates on the first); None for a learnable-query model."""

    def __init__(self, model, *args, query_bank=None, **kwargs):
        if model.query_projector is not None and query_bank is None:
            raise ValueError("query_projector DASM needs dataset.text_query/audio_query banks "
                             "for closed-set training")
        self.query_bank = _bank_on(query_bank, next(model.parameters()).device)
        super().__init__(model, *args, **kwargs)

    def dasm_config(self, common_mask=None) -> DASMTrainConfig:
        tr = self.config["training"]
        model_cfg = self.config.get(self.model_name, {})
        return DASMTrainConfig(
            out_type=model_cfg.get("at_param", {}).get("out_type", "sigmoid"),
            w_at=tr.get("w_AT", 1.0),
            transform_choice=tuple(tr.get("transform", {}).get("choice", (1, 0, 0, 0))),
            model_kwargs=model_cfg.get("train_kwargs", {}),
            common_mask=common_mask,
            query_from_params=common_mask is not None and self.model.query_projector is None)

    def train_query(self):
        """The bank every training forward gets (None: the model's own)."""
        return self.query_bank

    def make_step(self, pg, schedule, accum: int) -> DASMStep:
        return DASMStep(self.model, self.frontend, self.dasm_config(), pg, schedule, accum,
                        query=self.train_query())

    @torch.no_grad()
    def eval_forward(self, mel, pad_mask):
        kwargs = self.model_kwargs("val_kwargs")
        if self.query_bank is not None:
            kwargs["query"] = self.query_bank
        out = self.model(mel, pad_mask=pad_mask, **kwargs)
        return out.strong, out.at_out


class OVDASMTrainer(DASMTrainer):
    """Open-vocabulary DASM loop (upstream ``open_vocabulary.py:16-305``):
    training sees the common classes only (``common_mask``, a length-C bool
    array in the codec's class order), validation runs every query in
    common-first order under :func:`open_vocab_att_mask`, reorders the
    predictions back, and reports PSDS, the AT branch's macro mAP and the
    per-type PSDS. ``query_bank``: one [C, d] array of a projector model, or
    None (the model's learnable bank)."""

    def __init__(self, *args, common_mask=None, query_bank=None, **kwargs):
        if common_mask is None:
            raise ValueError("OVDASMTrainer requires common_mask")
        self.common_mask = np.asarray(common_mask, dtype=bool)
        super().__init__(*args, query_bank=query_bank, **kwargs)

    def train_query(self):
        if self.query_bank is None:
            return None
        return self.query_bank[torch.as_tensor(self.common_mask, device=self.device)]

    def make_step(self, pg, schedule, accum: int) -> DASMStep:
        cfg = self.dasm_config(common_mask=tuple(bool(b) for b in self.common_mask))
        return DASMStep(self.model, self.frontend, cfg, pg, schedule, accum,
                        query=self.train_query())

    def eval_queries(self) -> Tuple[torch.Tensor, np.ndarray]:
        """The bank in common-first order and its self-attention mask
        (``open_vocabulary.py:98-132``)."""
        bank = self.query_bank if self.query_bank is not None else self.model.at_query.detach()
        order = torch.as_tensor(common_first_order(self.common_mask), device=bank.device)
        return bank.index_select(0, order), open_vocab_att_mask(self.common_mask)

    @torch.no_grad()
    def eval_forward(self, mel, pad_mask):
        query, att_mask = self.eval_queries()
        out = self.model(mel, pad_mask=pad_mask, query=query, tgt_mask=att_mask,
                         **self.model_kwargs("val_kwargs"))
        at_out = out.at_out
        if at_out.ndim == 3:  # 'logit' head: the clip score is the softmax diagonal
            probs = torch.softmax(at_out.float(), dim=-1)
            qi = torch.arange(probs.shape[1], device=probs.device)
            at_out = probs[:, qi, qi]
        return reorder_pred(out.strong, self.common_mask), reorder_pred(at_out, self.common_mask)

    def validation(self, epoch: int, ground_truth, durations, median_filter=7) -> Dict[str, float]:
        scores, at_preds, at_targets = self.validation_scores(median_filter)
        psds, single = psds_at_alpha_zero(scores, ground_truth, durations)
        single = drop_absent_classes(single, ground_truth, self.codec.labels)
        results = {"psds": psds, "at_mAP": macro_average_precision(at_preds, at_targets)}
        if self.type_map:
            results.update(split_psds_by_type(single, self.type_map))
        self.logger.scalars("validation", results, epoch + 1)
        return results


@torch.no_grad()
def openset_evaluate(model, frontend, codec, loader, extra_query, ground_truth, durations, *,
                     query_bank=None, median_filter=7, filter_type: str = "median",
                     model_kwargs: Optional[dict] = None, query_type: Optional[str] = None):
    """Open-set evaluation (upstream ``openset_evaluation.py:66-215``): the
    novel classes' query embeddings ``extra_query`` [C_novel, d] appended to
    the trained bank (``query_bank``, or the model's learnable ``at_query``),
    the extended vocabulary detected zero-shot. ``codec`` carries the
    extended class list (base then novel, in query order). Returns (psds,
    per-class psds, the ten best classes)."""
    from transformer4sed_tpu_torch.eval.decode import batched_decode_preds

    device = next(model.parameters()).device
    if query_bank is None and model.at_query is None:
        raise ValueError("a query-projector DASM evaluates the open set on its bank: "
                         "dataset.query_bank")
    bank = (_bank_on(query_bank, device) if query_bank is not None
            else model.at_query.detach())
    query = torch.cat([bank, _bank_on(extra_query, device)], dim=0)
    if query.shape[0] != codec.n_classes:
        raise ValueError(f"extended query count {query.shape[0]} != codec classes "
                         f"{codec.n_classes}")
    kwargs = dict(model_kwargs or {})
    if query_type is not None:
        kwargs["query_type"] = query_type
    was_training = model.training
    model.eval()
    scores = {}
    try:
        for batch in loader:
            mel = frontend.normalize(frontend(torch.from_numpy(batch["wav"]).to(device)))
            out = model(mel, pad_mask=torch.from_numpy(batch["pad_mask"]).to(device), query=query,
                        **kwargs)
            _, post = batched_decode_preds(out.strong.float(), batch["filename"], codec,
                                           filter=median_filter, filter_type=filter_type)
            scores.update(post)
    finally:
        model.train(was_training)
    psds, single = psds_at_alpha_zero(scores, ground_truth, durations)
    top10 = dict(sorted(single.items(), key=lambda kv: kv[1], reverse=True)[:10])
    return psds, single, top10

