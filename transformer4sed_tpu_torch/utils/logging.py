"""Run logging: Python logging, TensorBoard scalars and the best-model
tracker (port of ``utils/logging.py``).

The reference's ``Logger``/``BestModels`` (``src/utils/log.py:10-89``):
stream and file logging, a TensorBoard writer where
``torch.utils.tensorboard`` imports, and a tracker that keeps the best
student and teacher by a validation metric and writes them to disk every
``flush_every`` updates, with ``best_metric.json`` beside them so that a
resumed run cannot overwrite a better checkpoint from before the
interruption. The codecarbon tracker of the JAX module has no caller and is
not ported. The saved models are state dicts (``utils/checkpoint.py``):
buffers such as BatchNorm statistics are part of ``best_student`` and
``best_teacher``, where the JAX package writes them beside them as
``best_model_state`` and ``best_model_state_teacher``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
from typing import Any, Dict, Mapping, Optional

import torch

from transformer4sed_tpu_torch.parallel.multihost import is_primary
from transformer4sed_tpu_torch.utils.checkpoint import _to_cpu, save_params

_FORMAT = "[%(asctime)s] %(levelname)s %(message)s"


class Logger:
    def __init__(self, logger_name: str = "t4s_torch", log_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None, level: int = logging.INFO):
        self.logger = logging.getLogger(logger_name)
        self.logger.setLevel(level)
        for handler in self.logger.handlers:
            handler.close()
        self.logger.handlers.clear()
        self.logger.propagate = False
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(logging.Formatter(_FORMAT))
        self.logger.addHandler(stream)
        if log_path:
            fh = logging.FileHandler(log_path)
            fh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(fh)
        self.tensorboard_writer = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tensorboard_writer = SummaryWriter(tensorboard_dir)
            except ImportError:
                self.logger.warning("tensorboard unavailable; scalar logging disabled")

    def info(self, msg: str):
        self.logger.info(msg)

    def scalar(self, tag: str, value: float, step: int):
        if self.tensorboard_writer is not None:
            self.tensorboard_writer.add_scalar(tag, float(value), global_step=step)

    def scalars(self, prefix: str, values: Mapping[str, Any], step: int):
        for k, v in values.items():
            try:
                self.scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self.tensorboard_writer is not None:
            self.tensorboard_writer.close()
        for handler in self.logger.handlers:
            handler.close()
        self.logger.handlers.clear()


class BestModels:
    """Track the best student / teacher by a validation metric (higher is
    better), flushing them to disk every ``flush_every`` updates."""

    def __init__(self, save_dir: str, flush_every: int = 2):
        self.save_dir = save_dir
        self.flush_every = flush_every
        self.best_metric = -math.inf
        self.best_epoch = -1
        self._student: Optional[Dict[str, torch.Tensor]] = None
        self._teacher: Optional[Dict[str, torch.Tensor]] = None
        self._dirty = False
        self._since_flush = 0
        os.makedirs(save_dir, exist_ok=True)
        # a resumed run must not let its first epoch overwrite a better
        # best from before the interruption (flush writes the metric)
        metric_path = os.path.join(save_dir, "best_metric.json")
        if os.path.exists(metric_path):
            with open(metric_path) as f:
                prev = json.load(f)
            self.best_metric = float(prev.get("metric", -math.inf))
            self.best_epoch = int(prev.get("epoch", -1))

    def update(self, epoch: int, metric: float, student: Mapping[str, torch.Tensor],
               teacher: Optional[Mapping[str, torch.Tensor]] = None) -> bool:
        """``student`` / ``teacher``: state dicts, copied to the host on a
        new best."""
        improved = metric > self.best_metric
        if improved:
            self.best_metric = metric
            self.best_epoch = epoch
            self._dirty = True
            self._student = _to_cpu(dict(student))
            self._teacher = None if teacher is None else _to_cpu(dict(teacher))
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()
            self._since_flush = 0
        return improved

    def flush(self):
        """Write the best models and ``best_metric.json`` when a new best
        arrived since the last flush (the primary process writes)."""
        if self._student is None or not self._dirty:
            return
        self._dirty = False
        if not is_primary():
            return
        save_params(os.path.join(self.save_dir, "best_student"), self._student)
        if self._teacher is not None:
            save_params(os.path.join(self.save_dir, "best_teacher"), self._teacher)
        with open(os.path.join(self.save_dir, "best_metric.json"), "w") as f:
            json.dump({"metric": float(self.best_metric), "epoch": self.best_epoch}, f)
