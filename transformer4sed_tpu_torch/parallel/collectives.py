"""Differentiable collectives of the data-parallel and tensor-parallel layouts.

The JAX package leaves every collective to GSPMD, which keeps global
semantics; the port computes locally on each rank and writes the three it
needs out, each a ``torch.autograd.Function`` over one process group:

  * :func:`copy_to_group` — identity forward, gradient summed over the group
    backward: the input of a column-parallel layer, and a replicated
    parameter that a rank reads only a slice of (its heads of the XL
    position biases, of ``linear_pos``, of a Swin bias table);
  * :func:`reduce_from_group` — sum over the group forward, identity
    backward: the output of a row-parallel layer, whose cotangent is the same
    on every rank of the group;
  * :func:`all_reduce_sum` — sum forward and sum backward: global-batch
    BatchNorm statistics over the ``data`` group, where each rank's loss reads
    the statistics of every rank's rows.

The collectives run on the tensors' device (gloo on the CPU, NCCL on the
card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes unchanged."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiated as a sum over ranks."""
    return _AllReduceSum.apply(x, group)
