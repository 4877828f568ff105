"""Swin window attention: the CUDA kernels and their plain versions.

Port of ``transformer4sed_tpu/kernels/window_attention.py`` (the HTSAT
backbone's attention, ``models/htsat.py:190-198``): per window and head

    softmax(scale * Q K^T + bias[h] + shift[w mod nW]) V

with q/k/v ``[B*nW, n, H, d]`` (the lane slices of the qkv projection, read
by stride), the relative-position bias ``[H, n, n]`` and the optional
additive shifted-window mask ``[nW, n, n]`` (0 / -100). Two kernels, on one
Hopper body (``csrc/window.cuh``):

  * ``csrc/window_attention.cu`` ``t4s_window_fwd`` for ``_window_forward``;
  * ``csrc/window_attention_bwd.cu`` ``t4s_window_bwd`` for
    ``_window_backward``: no log-sum-exp is saved, the scores are recomputed
    and delta comes from the saved output.

Both take every operand by TMA and run work items of a window position and
a group of heads over a slice of the images, planned in ``csrc/window.cuh``
(``wa_plan``) from the card's SM count.

:func:`swin_window_attention` dispatches like the JAX ``custom_vjp``: with
autograd recording and an operand that requires grad it runs
:class:`SwinWindowAttention` (forward kernel, saved q, k, v, bias, mask and
output, backward kernel), otherwise the forward kernel alone, through the
custom op ``t4s::window_fwd`` (``_build.define_op``). Each wrapper
launches its kernel for CUDA tensors (bf16, n = 64, d = 24: every HTSAT
stage) and uses its plain version only for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels.flash_attention import check_cuda_operands, check_f32_rows

WINDOW_TOKENS, HEAD_DIM = 64, 24  # what the CUDA kernels are built for
# planted faults of the window kernels (csrc/window.cuh: WaFault), for the
# kernel check only
WA_FAULTS = {"slot": 1, "skip_reduce": 2}


def _window_index(bnw: int, n_windows: int, device) -> torch.Tensor:
    return torch.arange(bnw, device=device) % n_windows


def _check_windows(what: str, bnw: int, shift_mask, n_windows: int) -> None:
    if shift_mask is None:
        return
    if shift_mask.shape[0] != n_windows:
        raise ValueError(f"{what}: shift mask of {shift_mask.shape[0]} windows, "
                         f"n_windows={n_windows}")
    if bnw % n_windows:
        raise ValueError(f"{what}: bnw={bnw} must be a multiple of n_windows={n_windows} "
                         "(q rows are B*nW windows in image order)")


def _scores(q, k, bias, shift_mask, n_windows: int, sm_scale: float) -> torch.Tensor:
    """f32 [B*nW, H, n, n] scores: scale * Q K^T + bias + shift."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    s = s + bias[None].float()
    if shift_mask is not None:
        idx = _window_index(q.shape[0], n_windows, q.device)
        s = s + shift_mask[idx][:, None].float()
    return s


def window_attention_plain(q, k, v, bias, shift_mask, n_windows: int, sm_scale: float):
    """Plain PyTorch version of the forward (the reference's
    ``_xla_window_attention``): scores and softmax in float32, P cast to
    v's dtype before P V. Returns [B*nW, n, H, d] in v's dtype."""
    _check_windows("window_attention", q.shape[0], shift_mask, n_windows)
    p = torch.softmax(_scores(q, k, bias, shift_mask, n_windows, sm_scale), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def window_attention_backward_plain(q, k, v, o, g, bias, shift_mask, n_windows: int,
                                    sm_scale: float):
    """Plain version of the backward from the saved output: the formulas of
    ``_window_backward_kernel`` in float32, with P rounded to the
    cotangent's dtype before dV and dS to k's dtype before dQ and dK, as
    the kernels round them. Returns float32 (dq, dk, dv), dbias [H, n, n]
    and dshift [nW, n, n] (None without a mask), both float32 sums of the
    unrounded dS; :class:`SwinWindowAttention` casts to the primals' dtypes."""
    bnw = q.shape[0]
    _check_windows("window_attention_backward", bnw, shift_mask, n_windows)
    p = torch.softmax(_scores(q, k, bias, shift_mask, n_windows, sm_scale), dim=-1)
    gf = g.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    delta = (gf * o.float()).sum(-1).transpose(1, 2)  # [B*nW, H, n]
    ds = p * (dp - delta[..., None])
    ds_lo = ds.to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, q.float()) * sm_scale
    dbias = ds.sum(0)
    dshift = None
    if shift_mask is not None:
        dshift = ds.reshape(bnw // n_windows, n_windows, *ds.shape[1:]).sum((0, 2))
    return dq, dk, dv, dbias, dshift


def _check_cuda_call(what: str, operands, bias, shift_mask, n_windows: int) -> None:
    """Check a launch's operands."""
    q = operands[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    bnw, n, h, d = q.shape
    if (n, d) != (WINDOW_TOKENS, HEAD_DIM):
        raise ValueError(f"{what}: the CUDA kernel takes {WINDOW_TOKENS}-token windows of head "
                         f"dim {HEAD_DIM}, got {tuple(q.shape)}")
    for x in operands:
        if x.shape != q.shape or x.stride(2) != d:
            raise ValueError(f"{what}: operand {tuple(x.shape)} strides {x.stride()} is not a "
                             f"[B*nW, n, H, d] lane view of {tuple(q.shape)}")
    check_cuda_operands(what, *operands)
    check_f32_rows(what, bias, (h, n, n))
    _check_windows(what, bnw, shift_mask, n_windows)
    if shift_mask is not None:
        check_f32_rows(what, shift_mask, (n_windows, n, n))


def _strides(*tensors):
    return [s for x in tensors for s in (x.stride(0), x.stride(1))]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def window_attention(q, k, v, bias, shift_mask, n_windows: int, sm_scale: float,
                     fault: int = 0):
    """The forward alone: the kernel for CUDA tensors, the plain version for
    CPU tensors. ``n_windows`` is read only with a mask (without one every
    window is alike). ``fault`` plants one of ``WA_FAULTS``: 0 on every
    real path."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, shift_mask, n_windows, sm_scale)
    what = "window_attention"
    _check_cuda_call(what, (q, k, v), bias, shift_mask, n_windows)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _build.function("window_attention", "t4s_window_fwd", 6, 8, n_ints=6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), _ptr(shift_mask),
            out.data_ptr(), *q.shape, n_windows if shift_mask is not None else 1, fault,
            *_strides(q, k, v, out), sm_scale, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    window_attention.launches += 1
    return out


def window_attention_backward(q, k, v, o, g, bias, shift_mask, n_windows: int, sm_scale: float,
                              fault: int = 0):
    """(dq, dk, dv, dbias, dshift-or-None) from the saved output: the backward
    kernel for CUDA tensors (bf16 dq, dk, dv; f32 dbias and dshift), its
    plain version for CPU tensors (all float32). ``fault`` as for
    :func:`window_attention`."""
    if q.device.type == "cpu":
        return window_attention_backward_plain(q, k, v, o, g, bias, shift_mask, n_windows,
                                               sm_scale)
    what = "window_attention_backward"
    _check_cuda_call(what, (q, k, v, o, g), bias, shift_mask, n_windows)
    _, n, h, _ = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=x.dtype, device=q.device) for x in (q, k, v))
    dbias = torch.zeros((h, n, n), dtype=torch.float32, device=q.device)
    dshift = None
    if shift_mask is not None:
        dshift = torch.zeros((n_windows, n, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = _build.function("window_attention_bwd", "t4s_window_bwd", 12, 10, n_ints=6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            bias.data_ptr(), _ptr(shift_mask), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), _ptr(dshift), *q.shape,
            n_windows if shift_mask is not None else 1, fault, *_strides(q, k, v, o, g),
            sm_scale, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    window_attention_backward.launches += 1
    return dq, dk, dv, dbias, dshift


class SwinWindowAttention(torch.autograd.Function):
    """The differentiated path: the forward kernel, then the recompute
    backward from the saved q, k, v, bias, mask and output. The mask's
    gradient is returned only when the mask asks for one (in the model it
    is a constant buffer)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, shift_mask, n_windows: int, sm_scale: float):
        out = window_attention(q, k, v, bias, shift_mask, n_windows, sm_scale)
        ctx.save_for_backward(q, k, v, bias, shift_mask, out)
        ctx.n_windows, ctx.sm_scale = n_windows, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, shift_mask, out = ctx.saved_tensors
        if g.stride(-1) != 1 or g.stride(2) != g.shape[-1]:
            g = g.contiguous()
        dq, dk, dv, dbias, dshift = window_attention_backward(
            q, k, v, out, g, bias, shift_mask, ctx.n_windows, ctx.sm_scale)
        if shift_mask is not None and ctx.needs_input_grad[4]:
            dshift = dshift.to(shift_mask.dtype)
        else:
            dshift = None
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias.to(bias.dtype), dshift,
                None, None)


def swin_window_attention(q, k, v, bias, shift_mask, n_windows: int, sm_scale: float):
    """Window attention with rel-pos bias and optional Swin shift mask.

    q/k/v: [B*nW, n, H, d]; bias: [H, n, n]; shift_mask: [nW, n, n] additive
    (or None); n_windows = nW (windows per image, the mask's period).
    Returns [B*nW, n, H, d]. Differentiated calls run
    :class:`SwinWindowAttention`; others the forward alone, through the op
    ``t4s::window_fwd``.
    """
    tensors = (q, k, v, bias) + (() if shift_mask is None else (shift_mask,))
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return SwinWindowAttention.apply(q, k, v, bias, shift_mask, n_windows, sm_scale)
    return window_fwd(q, k, v, bias, shift_mask, n_windows, float(sm_scale))


def _window_fwd_cpu(q, k, v, bias, shift_mask, n_windows: int, sm_scale: float):
    """The plain version in the kernel's layout ([B*nW, n, H, d] contiguous)."""
    return window_attention_plain(q, k, v, bias, shift_mask, n_windows, sm_scale).contiguous()


# row 14 as the custom op t4s::window_fwd (the no-grad calls of swin_window_attention)
window_fwd = _build.define_op(
    "window_fwd", "(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? shift_mask, "
    "int n_windows, float sm_scale) -> Tensor",
    cpu=_window_fwd_cpu, cuda=window_attention,
    fake=lambda q, *args: q.new_empty(q.shape))


window_attention.launches = 0
window_attention_backward.launches = 0
