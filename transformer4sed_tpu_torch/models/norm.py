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

Under data parallelism (``mesh`` set by ``parallel.shard_train_step``) the
statistics are the global batch's, as GSPMD computes them in the JAX
package: in two passes, as the JAX ``RefBatchNorm`` takes them, an
all-reduce over the ``data`` group of the sums for the mean, then one of the
centred squares for the variance (E[x^2] - E[x]^2 in one pass loses digits
as (|mean| / std)^2 grows: bn0's log-mel bins reach 9), both in float32 and
differentiated as sums over ranks, and the unbiased
running variance from the global count, which is the local count times the
``data`` size (every rank holds an equal share of the global batch,
``Mesh.batch_rows``), so no count is read back to the host. Per-replica statistics
(torch ``DataParallel``'s) would differ at the scale of the activations' RMS.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.parallel.collectives import all_reduce_sum


class RefBatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.mesh = None  # a parallel.Mesh: statistics over its data group

    def _batch_stats(self, xf: torch.Tensor):
        """(mean, biased variance, count) over every axis but the last."""
        c = xf.shape[-1]
        if self.mesh is None:
            axes = tuple(range(xf.ndim - 1))
            mean = xf.mean(axes)
            return mean, (xf - mean).square().mean(axes), xf.numel() // c
        flat = xf.reshape(-1, c)
        n = flat.shape[0] * self.mesh.data  # equal shares on every rank
        mean = all_reduce_sum(flat.sum(0), self.mesh.data_group) / n
        var = all_reduce_sum((flat - mean).square().sum(0), self.mesh.data_group) / n
        return mean, var, n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, var, n = self._batch_stats(xf)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)
