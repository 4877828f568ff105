"""BatchNorm over the trailing feature axis (port of ``models/norm.py``).

``RefBatchNorm`` in the JAX package reproduces ``torch.nn.BatchNorm2d`` on
channels-last tensors; here it is that behaviour written out: statistics in
float32 over every axis but the last, the biased variance to normalise the
batch, the unbiased one into the running variance, and torch's momentum
convention (the weight of the new batch statistic). Params and buffers
carry torch's names (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so upstream state dicts load.
``self.training`` takes the place of ``use_running_average``; flax's
"skip the update while initialising" has no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class RefBatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            n = xf.numel() // xf.shape[-1]
            mean = xf.mean(axes)
            var = (xf - mean).square().mean(axes)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)
