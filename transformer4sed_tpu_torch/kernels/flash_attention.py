"""Heads-in-lanes flash attention: the CUDA kernels and their plain versions.

Port of the heads-in-lanes path of
``transformer4sed_tpu/kernels/flash_attention.py`` (the PaSST backbone's
attention, ``models/vit.py:113-122``): softmax attention with no mask over
q/k/v given as [B, N, H*d] lane slices of the qkv projection. Three
kernels, each read by stride so no head transpose is made:

  * ``csrc/flash_attention.cu`` ``t4s_flash_nhd_fwd`` for
    ``_flash_nhd_forward`` (no-grad calls: serving, the mean teacher);
  * the same source's ``t4s_flash_nhd_fwd_lse`` for
    ``_flash_nhd_forward_lse`` (output and row log-sum-exp);
  * ``csrc/flash_attention_bwd.cu`` for ``_flash_nhd_backward`` (dq, dk,
    dv from the saved output and log-sum-exp).

:func:`flash_attention_nhd` dispatches like the JAX ``custom_vjp``: with
autograd recording and an operand that requires grad it runs
:class:`FlashAttentionNHD` (LSE forward, saved-O/LSE backward), otherwise
the plain forward kernel. Each wrapper launches its kernel for CUDA
tensors and uses its plain version only for tensors on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from transformer4sed_tpu_torch.kernels import _build

def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def _scale(q: torch.Tensor, num_heads: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1] // num_heads)


def row_delta(o: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, [B, N, H*d] -> f32 [B, H, N]
    (the JAX wrappers compute it outside the kernel too)."""
    b, n, c = o.shape
    prod = (do.float() * o.float()).reshape(b, n, num_heads, c // num_heads).sum(-1)
    return prod.transpose(1, 2).contiguous()


def flash_attention_nhd_reference(q, k, v, num_heads: int, sm_scale: Optional[float] = None):
    """Plain PyTorch softmax attention in the [B, N, H*d] layout; scores and
    softmax in float32 (the reference's ``_xla_attention``)."""
    scale = _scale(q, num_heads, sm_scale)
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    return _merge_heads(torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), vh))


def flash_attention_nhd_lse_reference(q, k, v, num_heads: int, sm_scale: Optional[float] = None):
    """Plain version of the LSE forward: (out [B, N, H*d], lse f32 [B, H, N])."""
    scale = _scale(q, num_heads, sm_scale)
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return _merge_heads(torch.matmul(p.to(v.dtype), vh)), lse


def flash_attention_nhd_backward_reference(q, k, v, o, lse, do, num_heads: int,
                                           sm_scale: Optional[float] = None):
    """Plain version of the backward from the saved (o, lse): the formulas
    of ``_nhd_dqkv_kernel``, in float32, with P and dS rounded to v's dtype
    before their products as the kernels round them. Returns float32
    (dq, dk, dv); :class:`FlashAttentionNHD` casts them to the primals'
    dtypes."""
    scale = _scale(q, num_heads, sm_scale)
    qh, kh, vh, doh = (_split_heads(x, num_heads) for x in (q, k, v, do))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(doh.float(), vh.float().transpose(-1, -2))
    ds = p * (dp - row_delta(o, do, num_heads)[..., None])
    lo = v.dtype
    dv = torch.matmul(p.to(lo).float().transpose(-1, -2), doh.float())
    dk = torch.matmul(ds.to(lo).float().transpose(-1, -2), qh.float()) * scale
    dq = torch.matmul(ds.to(lo).float(), kh.float()) * scale
    return _merge_heads(dq), _merge_heads(dk), _merge_heads(dv)


def check_cuda_operands(what: str, *tensors: torch.Tensor) -> None:
    """What the attention kernels take: bf16 CUDA tensors on one device,
    unit stride along the last dim, strides and addresses 16-byte aligned."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{what}: operands on {x.device} and {dev}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the CUDA kernel takes bfloat16, got {x.dtype}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"{what}: operand strides {x.stride()} are not 16-byte aligned rows")


def check_f32_rows(what: str, x: torch.Tensor, shape) -> None:
    """The kernels' float32 side tensors (lse, delta): contiguous, on the card."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{what}: expected contiguous float32 {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")


def _check_shapes(what, q, k, v, num_heads):
    c = q.shape[-1]
    if k.shape != q.shape or v.shape != q.shape or c % num_heads or c // num_heads != 64:
        raise ValueError(f"{what}: unsupported shapes {tuple(q.shape)}, {num_heads} heads")


def _strides(*tensors):
    return [s for x in tensors for s in (x.stride(0), x.stride(1))]


def _forward_kernel(q, k, v, num_heads, scale, with_lse: bool):
    what = "flash_attention_nhd_lse" if with_lse else "flash_attention_nhd"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    _check_shapes(what, q, k, v, num_heads)
    check_cuda_operands(what, q, k, v)
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=q.device) if with_lse else None
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    symbol = "t4s_flash_nhd_fwd_lse" if with_lse else "t4s_flash_nhd_fwd"
    with torch.cuda.device(q.device):
        status = _build.function("flash_attention", symbol, len(ptrs), 8)(
            *ptrs, b, n, num_heads, c // num_heads, *_strides(q, k, v, out), scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    return out, lse


def flash_attention_nhd_lse(q, k, v, num_heads: int, sm_scale: Optional[float] = None):
    """(out [B, N, H*d], lse f32 [B, H, N]): the LSE forward kernel for CUDA
    tensors (bf16, head dim 64), its plain version for CPU tensors."""
    scale = _scale(q, num_heads, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_nhd_lse_reference(q, k, v, num_heads, scale)
    out, lse = _forward_kernel(q, k, v, num_heads, scale, with_lse=True)
    flash_attention_nhd_lse.launches += 1
    return out, lse


def flash_attention_nhd_backward(q, k, v, o, lse, do, num_heads: int,
                                 sm_scale: Optional[float] = None):
    """(dq, dk, dv) from the saved (o, lse): the backward kernel for CUDA
    tensors (bf16 results), its plain version for CPU tensors (float32)."""
    scale = _scale(q, num_heads, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_nhd_backward_reference(q, k, v, o, lse, do, num_heads, scale)
    what = "flash_attention_nhd_backward"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    _check_shapes(what, q, k, v, num_heads)
    b, n, c = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} / do {tuple(do.shape)} vs q {tuple(q.shape)}")
    check_cuda_operands(what, q, k, v, o, do)
    check_f32_rows(what, lse, (b, num_heads, n))
    delta = row_delta(o, do, num_heads)
    dq_acc = torch.zeros((b, n, c), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, n, c), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, n, c), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _build.function("flash_attention_bwd", "t4s_flash_nhd_bwd", 9, 14)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, n, num_heads, c // num_heads, *_strides(q, k, v, do, dq_acc, dk, dv), scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_attention_nhd_backward.launches += 1
    return dq_acc.to(q.dtype), dk, dv


class FlashAttentionNHD(torch.autograd.Function):
    """The differentiated path: LSE forward, then the fused backward from
    the saved q, k, v, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        out, lse = flash_attention_nhd_lse(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_nhd_backward(q, k, v, out, lse, do.contiguous(), ctx.num_heads,
                                             ctx.scale)
        return (*(g.to(x.dtype) for g, x in zip(grads, (q, k, v))), None, None)


def flash_attention_nhd(q, k, v, num_heads: int, sm_scale: Optional[float] = None):
    """softmax(scale * Q K^T) V per head, q/k/v [B, N, H*d] -> [B, N, H*d].

    Differentiated calls run :class:`FlashAttentionNHD`; others launch the
    forward kernel for CUDA tensors (bf16, head dim 64) and take the plain
    version for CPU tensors. Any other case raises.
    """
    scale = _scale(q, num_heads, sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionNHD.apply(q, k, v, num_heads, scale)
    if q.device.type == "cpu":
        return flash_attention_nhd_reference(q, k, v, num_heads, scale)
    out, _ = _forward_kernel(q, k, v, num_heads, scale, with_lse=False)
    flash_attention_nhd.launches += 1
    return out


flash_attention_nhd.launches = 0
flash_attention_nhd_lse.launches = 0
flash_attention_nhd_backward.launches = 0
