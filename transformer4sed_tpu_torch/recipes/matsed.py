"""MAT-SED recipe: the mean-teacher fine-tune and MLM pretrain trainers
(port of ``recipes/matsed.py``).

The orchestration of the reference's ``recipes/desed/finetune/train.py`` and
``recipes/desed/mlm``: the host loop feeds loader batches to the port's train
steps (``train/mean_teacher.py``, ``train/mlm.py``), validates (scores on the
model's device, decoded there, PSDS1, PSDS2 and event F1 on the host), keeps
the best student and teacher by PSDS1 (``utils/logging.py:BestModels``) and
checkpoints the whole train state each epoch (``utils/checkpoint.py``).

Each step's generator comes from ``(seed, epoch * steps + i)`` alone
(``recipes/common.py:step_generator``, the JAX recipes' ``fold_in``), so a
run resumed from ``last_state`` draws exactly what the uninterrupted run
drew. Under a process group of several ranks (``parallel/multihost.py``) the
trainers take the data-parallel step (``parallel.shard_train_step``): every
rank loads the global batch, since the step augments the global batch on
every rank, and each scores its share of the evaluation clips, merged before
PSDS. The JAX test stage's PSD-ROC plot (best-effort there) needs
``utils/visualization.py`` and matplotlib and is left out.
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.eval.decode import batched_decode_preds, decode_pred_batch
from transformer4sed_tpu_torch.eval.psds import compute_psds_from_scores
from transformer4sed_tpu_torch.eval.sed_f1 import event_based_f1
from transformer4sed_tpu_torch.parallel import multihost
from transformer4sed_tpu_torch.recipes import common
from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherConfig, MeanTeacherTrainer
from transformer4sed_tpu_torch.train.mlm import MLMConfig
from transformer4sed_tpu_torch.train.mlm import MLMTrainer as MLMStep
from transformer4sed_tpu_torch.train.mlm import mlm_loss
from transformer4sed_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from transformer4sed_tpu_torch.utils.logging import BestModels, Logger

PSDS1 = dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0.0, alpha_st=1.0)
PSDS2 = dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3, alpha_ct=0.5,
             alpha_st=1.0)


def weak_macro_f1(preds: np.ndarray, targets: np.ndarray, threshold: float = 0.5) -> float:
    """Macro multilabel F1 at a fixed threshold (torchmetrics parity)."""
    p = preds >= threshold
    t = targets >= 0.5
    f1s = []
    for c in range(p.shape[1]):
        tp = int((p[:, c] & t[:, c]).sum())
        fp = int((p[:, c] & ~t[:, c]).sum())
        fn = int((~p[:, c] & t[:, c]).sum())
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(f1s))


def mean_teacher_config(config: Dict, codec: LabelCodec, steps_per_epoch: int) -> MeanTeacherConfig:
    """The mean-teacher step's config from the YAML, field for field as the
    JAX ``MATSEDTrainer`` maps it."""
    tr = config["training"]
    bs = tr["batch_size"]  # [strong, synth, weak, unlabeled]
    tf = tr.get("transform", {})
    section = config.get(config.get("model_name", "PaSST_SED"), {})
    return MeanTeacherConfig(
        strong_num=bs[0] + bs[1],
        weak_num=bs[2],
        unlabel_num=bs[3],
        net_pooling=codec.net_pooling,
        w_weak=tr.get("w_weak", 0.5),
        w_weak_cons=tr.get("w_weak_cons", 1.0),
        w_at=tr.get("w_AT", 0.2),
        w_cons_max=tr.get("w_cons_max", 40.0),
        w_cons_min=tr.get("w_cons_min", 0.0),
        self_loss_warmup_steps=tr.get("self_loss_warmup", 10) * steps_per_epoch,
        cons_scheduler=tr.get("cons_scheduler_name", "Sigmoid"),
        ema_factor=tr.get("ema_factor", 0.999),
        n_transform=tf.get("n_transform", 2),
        transform_choice=tuple(tf.get("choice", (1, 0, 0, 0))),
        filter_db_range=tuple(tf.get("filter_db_range", (-0.5, 0.5))),
        filter_bands=tuple(tf.get("filter_bands", (3, 6))),
        filter_minimum_bandwidth=tf.get("filter_minimum_bandwidth", 6),
        filter_type=tf.get("filter_type", "step"),
        freq_mask_ratio=tf.get("freq_mask_ratio"),
        noise_snrs=tf.get("noise_snrs"),
        stu_kwargs=section.get("train_stu_kwargs", {}),
        tch_kwargs=section.get("train_tch_kwargs", {}),
    )


def mlm_config(config: Dict) -> MLMConfig:
    """The MLM step's config from the YAML as the JAX ``MLMTrainer`` maps it:
    the transform choice and the forward kwargs (the other transform
    settings keep their defaults there too)."""
    name = config.get("model_name", "PaSST_SED")
    return MLMConfig(
        transform_choice=tuple(config["training"].get("transform", {}).get("choice",
                                                                            (1, 0, 0, 0))),
        model_kwargs=config.get(name, {}).get("train_kwargs", {}),
    )


def load_test_tables(config: Dict, val_gt, val_durations):
    """(ground truth, durations, whether it is the validation split) of the
    test split: its own tables, or the validation ones (``val_gt``,
    ``val_durations``) when ``dataset.test_tsv`` names the same file."""
    ds = config["dataset"]
    test_tsv = ds.get("test_tsv") or ds["val_tsv"]
    if os.path.realpath(test_tsv) == os.path.realpath(ds["val_tsv"]):
        return val_gt, val_durations, True
    if not ds.get("test_dur"):
        raise ValueError("dataset.test_tsv names a split different from val_tsv but "
                         "dataset.test_dur is not set; provide the duration table for the "
                         "test split")
    return common.load_ground_truth(test_tsv), common.load_durations(ds["test_dur"]), False


def psds_of(scores, gt, durations):
    """(PSDS1, PSDS2, per-class PSDS1) of test-split scores."""
    psds1, single1 = compute_psds_from_scores(scores, gt, durations, **PSDS1)
    psds2, _ = compute_psds_from_scores(scores, gt, durations, **PSDS2)
    return float(psds1), float(psds2), single1


def _data_parallel(trainer, sizes, logger):
    """Attach a data mesh over every rank when a process group of several
    exists and each subset of the batch splits over them."""
    world = multihost.process_count()
    if world > 1 and all(n % world == 0 for n in sizes):
        from transformer4sed_tpu_torch.parallel import make_mesh, shard_train_step

        shard_train_step(trainer, make_mesh())
        logger.info(f"sharding batches over {world} ranks")


def _host_batch(batch: Dict[str, Any], keys) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(batch[src])) for k, src in keys.items()}


class _EvalMode:
    """``model.eval()`` for the block, the previous mode restored after."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def __enter__(self):
        self.was_training = self.model.training
        self.model.eval()
        return self.model

    def __exit__(self, *exc):
        self.model.train(self.was_training)


class MATSEDTrainer:
    """Mean-teacher fine-tuning of a built, warm-started model: epochs,
    validation, best models, checkpoints and the test stage."""

    def __init__(self, model: torch.nn.Module, frontend, config: Dict, codec: LabelCodec,
                 train_loader, val_loader, test_loader, logger: Logger):
        self.frontend = frontend
        self.config = config
        self.codec = codec
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.logger = logger
        self.model_name = config.get("model_name", "PaSST_SED")
        self.mt_cfg = mean_teacher_config(config, codec, len(train_loader))
        pg, schedule, accum = common.optimizer_from_config(config, len(train_loader))
        self.trainer = MeanTeacherTrainer(model, frontend, self.mt_cfg, pg, schedule, accum)
        self.device = self.trainer.device
        cfg = self.mt_cfg
        _data_parallel(self.trainer, (cfg.strong_num, cfg.weak_num, cfg.unlabel_num), logger)
        self.median_filter = common.median_filter_from_config(config, codec)
        self.ground_truth = common.load_ground_truth(config["dataset"]["val_tsv"])
        self.durations = common.load_durations(config["dataset"]["val_dur"])

    @property
    def student(self) -> torch.nn.Module:
        return self.trainer.student

    @property
    def teacher(self) -> torch.nn.Module:
        return self.trainer.teacher

    def _forward_kwargs(self, key: str) -> Dict:
        return self.config.get(self.model_name, {}).get(key, {})

    @torch.no_grad()
    def _eval_forward(self, model, batch, kwargs_key: str):
        wav = torch.from_numpy(batch["wav"]).to(self.device)
        pad_mask = torch.from_numpy(batch["pad_mask"]).to(self.device)
        mel = self.frontend.normalize(self.frontend(wav))
        return model(mel, pad_mask=pad_mask, **self._forward_kwargs(kwargs_key))

    # -- stages ---------------------------------------------------------------------
    def train_epoch(self, epoch: int, seed: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        metrics_acc: Dict[str, float] = {}
        n = len(self.train_loader)
        for i, batch in enumerate(self.train_loader):
            metrics = self.trainer.step(_host_batch(batch, {"wav": "wav", "labels": "label"}),
                                        common.step_generator(seed, epoch * n + i))
            loss = float(metrics["loss_total"])
            if not np.isfinite(loss):  # the reference's NaN guard (finetune/train.py:190-191)
                raise FloatingPointError(f"non-finite loss at epoch {epoch} step {i}: {loss}")
            for k, v in metrics.items():
                metrics_acc[k] = metrics_acc.get(k, 0.0) + float(v) / n
        self.logger.scalars("Train", metrics_acc, epoch + 1)
        self.logger.info(f"epoch {epoch + 1}: "
                         + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics_acc.items())))
        return metrics_acc

    def _collect_scores(self, model, kwargs_key: str, raw: bool = False):
        """Score the validation loader with ``model`` in eval mode; ``raw``
        returns unfiltered score curves (cSEBB tuning) and skips the event
        decode and the weak predictions."""
        scores_post, event_rows, weak_preds, weak_labels = {}, [], [], []
        with _EvalMode(model):
            for batch in self.val_loader:
                out = self._eval_forward(model, batch, kwargs_key)
                strong, weak = out.strong.float(), out.weak.float()
                raw_scores, post = batched_decode_preds(
                    strong, batch["filename"], self.codec,
                    filter=None if raw else self.median_filter, weak_preds=weak,
                    need_weak_mask=self.config["training"].get("weak_mask", False))
                scores_post.update(raw_scores if raw else post)
                if raw:
                    continue
                preds = decode_pred_batch(strong, weak, batch["filename"], self.codec, [0.5],
                                          self.median_filter)
                event_rows.extend(preds[0.5])
                if out.at_out is not None:
                    weak_preds.append(out.at_out.float().cpu().numpy())
                    weak_labels.append((batch["label"].sum(-1) >= 1).astype(np.float32))
        if multihost.process_count() > 1:  # each rank scored its share of the clips
            scores_post = multihost.gather_clip_scores(scores_post)
            event_rows = [r for part in multihost.gather_objects(event_rows) for r in part]
            weak_preds = [a for part in multihost.gather_objects(weak_preds) for a in part]
            weak_labels = [a for part in multihost.gather_objects(weak_labels) for a in part]
        return scores_post, event_rows, weak_preds, weak_labels

    def validation(self, epoch: int) -> Dict[str, float]:
        results = OrderedDict()
        for tag, model in (("s", self.student), ("t", self.teacher)):
            scores, rows, weak_p, weak_l = self._collect_scores(model, "val_kwargs")
            psds1, _ = compute_psds_from_scores(scores, self.ground_truth, self.durations, **PSDS1)
            psds2, _ = compute_psds_from_scores(scores, self.ground_truth, self.durations, **PSDS2)
            pred_events = {}
            for fname, label, onset, offset in rows:
                pred_events.setdefault(fname.rsplit(".", 1)[0], []).append((onset, offset, label))
            ef1 = event_based_f1(pred_events, self.ground_truth, self.codec.labels)
            results[f"psds1/{tag}"] = float(psds1)
            results[f"psds2/{tag}"] = float(psds2)
            results[f"event_f1/{tag}"] = float(ef1["macro_f1"])
            if weak_p:
                results[f"weak_f1/{tag}"] = weak_macro_f1(np.concatenate(weak_p),
                                                          np.concatenate(weak_l))
        self.logger.scalars("validation", results, epoch + 1)
        self.logger.info(f"val epoch {epoch + 1}: "
                         + " ".join(f"{k}={v:.4f}" for k, v in results.items()))
        return results

    def save_state(self, path: str):
        if multihost.is_primary():
            save_checkpoint(path, self.trainer.state_dict())

    def restore_state(self, path: str) -> int:
        """Restore the train state at ``path``; returns its applied steps."""
        restore_checkpoint(path, self.trainer)
        return self.trainer.step_count

    def run(self, n_epochs: int, save_dir: str, seed: int = 0,
            start_epoch: int = 0) -> Dict[str, float]:
        best = BestModels(save_dir)
        last_val: Dict[str, float] = {}
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            self.train_epoch(epoch, seed)
            if (epoch + 1) % self.config["generals"].get("val_interval", 1) == 0:
                last_val = self.validation(epoch)
                best.update(epoch, last_val.get("psds1/s", 0.0), self.student.state_dict(),
                            self.teacher.state_dict())
            self.logger.info(f"epoch {epoch + 1} took {(time.time() - t0) / 60:.2f} min")
            self.save_state(f"{save_dir}/last_state")
        best.flush()
        return last_val

    def test(self, filter_type: str = "median", save_dir: Optional[str] = None) -> Dict[str, float]:
        """The teacher on the test split, with the median or max filter, or
        cSEBB post-processing on the raw scores (``filter_type='sebb'``;
        ``training.sebb``: ``'auto'``, tuned per class against PSDS1 on the
        validation split, or a parameter mapping). ``save_dir``: where the
        per-class PSDS1 goes, as ``single_psds.json`` sorted ascending."""
        use_sebb = filter_type == "sebb"
        test_gt, test_dur, same_as_val = load_test_tables(self.config, self.ground_truth,
                                                           self.durations)
        scores_post = {}
        with _EvalMode(self.teacher):
            for batch in self.test_loader:
                out = self._eval_forward(self.teacher, batch, "test_kwargs")
                raw, post = batched_decode_preds(
                    out.strong.float(), batch["filename"], self.codec,
                    filter=None if use_sebb else self.median_filter,
                    filter_type="median" if use_sebb else filter_type,
                    weak_preds=out.weak.float(),
                    need_weak_mask=self.config["training"].get("weak_mask", False))
                scores_post.update(raw if use_sebb else post)
        if multihost.process_count() > 1:
            scores_post = multihost.gather_clip_scores(scores_post)
        if use_sebb:
            from transformer4sed_tpu_torch.eval.sebbs import CSEBBParams, apply_csebbs, tune_csebbs

            sebb_cfg = self.config["training"].get("sebb", {})
            if isinstance(sebb_cfg, str) and sebb_cfg != "auto":
                raise ValueError(
                    f"training.sebb must be 'auto' or a parameter mapping, got {sebb_cfg!r}")
            if sebb_cfg == "auto":
                tune_scores = scores_post
                if not same_as_val:
                    tune_scores, *_ = self._collect_scores(self.teacher, "test_kwargs", raw=True)
                params, best = tune_csebbs(tune_scores, self.ground_truth, self.durations)
                self.logger.info(f"sebb auto-tune on val (best val psds1 {best:.4f}): {params}")
                scores_post = apply_csebbs(scores_post, params)
            else:
                scores_post = apply_csebbs(scores_post, CSEBBParams(**sebb_cfg))
        psds1, psds2, single1 = psds_of(scores_post, test_gt, test_dur)
        results = {"psds1": psds1, "psds2": psds2}
        if save_dir and multihost.is_primary():
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "single_psds.json"), "w") as f:
                json.dump(dict(sorted(single1.items(), key=lambda kv: kv[1])), f, indent=2)
        self.logger.info(f"test ({filter_type}): {results}")
        return results


class MLMTrainer:
    """Masked-reconstruction pretraining (MAT-SED stage 1): epochs and the
    validation loss."""

    def __init__(self, model: torch.nn.Module, frontend, config: Dict, train_loader, val_loader,
                 logger: Logger):
        self.frontend = frontend
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.model_name = config.get("model_name", "PaSST_SED")
        if getattr(model, "masker", None) is None:
            raise ValueError(
                "masked-reconstruction pretraining needs the model's MLM head: set "
                f"{self.model_name}.init_kwargs.mlm: true (+ mlm_dict) in the config")
        pg, schedule, accum = common.optimizer_from_config(config, len(train_loader))
        self.trainer = MLMStep(model, frontend, mlm_config(config), pg, schedule, accum)
        self.device = self.trainer.device
        # the batch the loader really gives: a prefix of training.batch_size,
        # one entry per present source folder
        _data_parallel(self.trainer, (len(next(iter(train_loader.batch_sampler))),), logger)

    @property
    def model(self) -> torch.nn.Module:
        return self.trainer.model

    def train_epoch(self, epoch: int, seed: int) -> float:
        self.train_loader.set_epoch(epoch)
        total = 0.0
        n = len(self.train_loader)
        for i, batch in enumerate(self.train_loader):
            metrics = self.trainer.step(_host_batch(batch, {"wav": "wav"}),
                                        common.step_generator(seed, epoch * n + i))
            total += float(metrics["loss_mlm"]) / n
        self.logger.scalar("Train/loss_mlm", total, epoch + 1)
        return total

    @torch.no_grad()
    def validation(self, seed: int = 0) -> float:
        """Mean reconstruction loss over the validation loader (the
        best-model metric); batch i's mask from ``(seed, i)``."""
        total, n = 0.0, 0
        with _EvalMode(self.model) as model:
            for i, batch in enumerate(self.val_loader):
                wav = torch.from_numpy(batch["wav"]).to(self.device)
                mel = self.frontend.normalize(self.frontend(wav))
                out = model(mel, generator=common.step_generator(seed, i))
                total += float(mlm_loss(out.mlm_pred.float(), out.frame_before_mask.float(),
                                        out.mask_id_seq))
                n += 1
        if multihost.process_count() > 1:  # each rank scored its share of the clips
            parts = multihost.gather_objects((total, n))
            total, n = sum(t for t, _ in parts), sum(c for _, c in parts)
        return total / max(n, 1)
