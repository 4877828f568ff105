"""Feature scaler: dataset-level or instance-level normalisation.

Port of the JAX package's ``data/scaler.py`` on torch tensors, computed on
the device of its input. Semantics of the reference ``TorchScaler``
(``src/preprocess/scaler.py:5-121``): 'dataset' statistics are the mean of
per-batch means over a fitting loader (kept with checkpoints); 'instance'
computes statistics per sample over ``dims``. Normtypes: standard / mean /
minmax (instance only). ``state_dict`` and ``load_state_dict`` use the JAX
keys, ``mean`` and ``mean_squared``, and take its numpy arrays as they are.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


class Scaler:
    def __init__(
        self,
        statistic: str = "dataset",
        normtype: str = "standard",
        dims: Tuple[int, ...] = (1, 2),
        eps: float = 1e-8,
    ):
        if statistic not in ("dataset", "instance", None):
            raise ValueError(f"unknown statistic {statistic!r}")
        if normtype not in ("standard", "mean", "minmax", None):
            raise ValueError(f"unknown normtype {normtype!r}")
        if statistic == "dataset" and normtype == "minmax":
            raise NotImplementedError("dataset+minmax not supported (parity with reference)")
        self.statistic = statistic
        self.normtype = normtype
        self.dims = tuple(dims)
        self.eps = eps
        self.mean: Optional[torch.Tensor] = None
        self.mean_squared: Optional[torch.Tensor] = None

    def fit(self, batches, transform_func: Callable = lambda b: b):
        """Accumulate batch-mean statistics over an iterable of batches."""
        mean = mean_sq = None
        count = 0
        for batch in batches:
            feats = torch.as_tensor(transform_func(batch))
            m = feats.mean(dim=self.dims, keepdim=True).mean(0, keepdim=True)
            m2 = (feats ** 2).mean(dim=self.dims, keepdim=True).mean(0, keepdim=True)
            mean = m if mean is None else mean + m
            mean_sq = m2 if mean_sq is None else mean_sq + m2
            count += 1
        if not count:
            raise ValueError("Scaler.fit got no batches")
        self.mean = mean / count
        self.mean_squared = mean_sq / count
        return self

    def state_dict(self):
        return {"mean": self.mean, "mean_squared": self.mean_squared}

    def load_state_dict(self, state):
        if self.statistic == "dataset":
            self.mean = torch.as_tensor(state["mean"])
            self.mean_squared = torch.as_tensor(state["mean_squared"])
        return self

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.statistic is None or self.normtype is None:
            return x
        if self.statistic == "dataset":
            if self.mean is None:
                raise RuntimeError("Scaler must be fit before use")
            mean = self.mean.to(x.device)
            if self.normtype == "mean":
                return x - mean
            if self.normtype == "standard":
                std = torch.sqrt(self.mean_squared.to(x.device) - mean ** 2)
                return (x - mean) / (std + self.eps)
            raise NotImplementedError(self.normtype)
        # instance
        if self.normtype == "mean":
            return x - x.mean(dim=self.dims, keepdim=True)
        if self.normtype == "standard":
            # torch.std is Bessel-corrected (ddof=1), as the reference's
            return (x - x.mean(dim=self.dims, keepdim=True)) / (
                x.std(dim=self.dims, keepdim=True) + self.eps
            )
        lo = x.amin(dim=self.dims, keepdim=True)
        hi = x.amax(dim=self.dims, keepdim=True)
        return (x - lo) / (hi - lo + self.eps)
