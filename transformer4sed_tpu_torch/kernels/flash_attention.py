"""Heads-in-lanes flash attention: the CUDA kernel and its plain version.

Port of ``transformer4sed_tpu/kernels/flash_attention.py:_flash_nhd_forward``
(the PaSST backbone's attention, ``models/vit.py:113-122``): softmax
attention with no mask over q/k/v given as [B, N, H*d] lane slices of
the qkv projection. The kernel (``csrc/flash_attention.cu``) reads the
slices by stride, so no head transpose is made.

:func:`flash_attention_nhd` launches the kernel for CUDA tensors and
uses :func:`flash_attention_nhd_reference` only for tensors on the CPU.
Forward only: the backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from transformer4sed_tpu_torch.kernels import _build

_FN = None


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def flash_attention_nhd_reference(q, k, v, num_heads: int, sm_scale: Optional[float] = None):
    """Plain PyTorch softmax attention in the [B, N, H*d] layout; scores and
    softmax in float32 (the reference's ``_xla_attention``)."""
    d = q.shape[-1] // num_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return _merge_heads(torch.matmul(p.to(v.dtype), vh))


def check_cuda_operands(what: str, *tensors: torch.Tensor) -> None:
    """What the attention kernels take: bf16 CUDA tensors on one device,
    unit stride along the last dim, strides and addresses 16-byte aligned,
    and no autograd (forward kernels only)."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{what}: operands on {x.device} and {dev}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the CUDA kernel takes bfloat16, got {x.dtype}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"{what}: operand strides {x.stride()} are not 16-byte aligned rows")
    forbid_grad(what, *tensors)


def forbid_grad(what: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward-only; its backward comes with the "
            "training slice (ROADMAP.md, queue 1, item 1)"
        )


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").t4s_flash_nhd_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_nhd(q, k, v, num_heads: int, sm_scale: Optional[float] = None):
    """softmax(scale * Q K^T) V per head, q/k/v [B, N, H*d] -> [B, N, H*d].

    CUDA tensors (bf16, head dim 64) launch the hand-written kernel;
    CPU tensors take the plain version. Any other case raises.
    """
    b, n, c = q.shape
    d = c // num_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_nhd_reference(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nhd: no kernel for device {q.device}")
    if k.shape != q.shape or v.shape != q.shape or c % num_heads or d != 64:
        raise ValueError(f"flash_attention_nhd: unsupported shapes {q.shape}, {num_heads} heads")
    check_cuda_operands("flash_attention_nhd", q, k, v)
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            scale, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "flash_attention_nhd")
    flash_attention_nhd.launches += 1
    return out


flash_attention_nhd.launches = 0
