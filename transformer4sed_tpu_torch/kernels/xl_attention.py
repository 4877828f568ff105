"""Fused Transformer-XL attention: the CUDA kernels and their plain versions.

Port of ``transformer4sed_tpu/kernels/xl_attention.py`` (the decoders'
attention, ``models/xl.py:182-197``):

    softmax(scale * (qu K^T + relshift(qv P^T))) V,   qu = q + u, qv = q + v

with u/v = ``pos_bias_u``/``pos_bias_v`` [H, d] added in float32 and rounded
to q's dtype, P the projected position table [H, 2T-1, d] in offset order
T-1 ... -(T-1), and an optional per-head band (row i attends
[i - w//2, i + w//2) plus i). Two families of three kernels each:

  * heads in lanes, head dim 64 (q/k/v as [B, T, H*d] lane slices, the bias
    added in the kernel): ``csrc/xl_attention.cu`` ``t4s_xl_nhd_fwd`` for
    ``_xl_nhd_forward`` (no-grad calls: serving, the mean teacher), the same
    source's ``t4s_xl_nhd_fwd_lse`` for ``_xl_nhd_forward_lse``, and
    ``csrc/xl_attention_bwd.cu`` for ``_xl_nhd_backward`` (dq, dk, dv,
    d``pos_bias_u``, d``pos_bias_v`` and dP);
  * head major, head dims 32 and 64 (qu, qv, k, v as [B, H, T, d] views with
    any batch, head and row strides; qu and qv given, dqu and dqv returned
    apart): ``csrc/xl_attention_hm.cu`` ``t4s_xl_hm_fwd`` for ``_xl_forward``,
    ``t4s_xl_hm_fwd_lse`` for ``_xl_forward_lse`` and
    ``csrc/xl_attention_hm_bwd.cu`` for ``_xl_backward``
    (:func:`flash_xl_attention`, :class:`XLAttention`).

The kernels do the rel-shift as index arithmetic on a position strip in
shared memory; the plain versions below compute the full position scores
and skew them (:func:`rel_shift`, and its adjoint :func:`rel_unshift` in
the backward). :func:`flash_xl_attention_nhd` dispatches like the JAX
``custom_vjp``: at head dim 64 differentiated calls run
:class:`XLAttentionNHD` and others the plain forward kernel; any other head
dim goes, as in the JAX package's fall-back, through strided head-major
views to :func:`flash_xl_attention`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels.flash_attention import (
    _merge_heads,
    _split_heads,
    check_cuda_operands,
    check_f32_rows,
    row_delta,
)

_NEG_INF = -1e30


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T-1] position scores -> [..., T, T] with
    out[..., i, j] = x[..., i, (T-1) - i + j] (pad/reshape skew)."""
    *lead, t, n = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(*lead, 2 * t, t)[..., 1:, :]
    return x.reshape(*lead, t, n)[..., :t]


def rel_unshift(x: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`rel_shift`: [..., T, T] -> [..., T, 2T-1] with
    out[..., i, (T-1) - i + j] = x[..., i, j] and zeros elsewhere."""
    t = x.shape[-1]
    i = torch.arange(t, device=x.device)
    idx = (t - 1 - i)[:, None] + i[None, :]
    out = x.new_zeros(*x.shape[:-1], 2 * t - 1)
    return out.scatter_(-1, idx.expand(x.shape), x)


def add_pos_bias(q, bias_u, bias_v, num_heads: int):
    """(qu, qv) [B, H, T, d]: q [B, T, H*d] plus each bias [H, d], summed in
    float32 and rounded to q's dtype."""
    qh = _split_heads(q, num_heads).float()
    return ((qh + bias_u.float()[None, :, None]).to(q.dtype),
            (qh + bias_v.float()[None, :, None]).to(q.dtype))


def _hm_scores(qu, qv, k, p, sm_scale, band_widths):
    """Head-major operands [B, H, T, d] -> (masked f32 scores [B, H, T, T],
    band mask or None)."""
    from transformer4sed_tpu_torch.models.xl import build_band_mask

    content = torch.matmul(qu.float(), k.float().transpose(-1, -2))
    position = rel_shift(torch.matmul(qv.float(), p.float().transpose(-1, -2)[None]))
    scores = (content + position) * sm_scale
    mask = None
    if band_widths is not None:
        mask = torch.as_tensor(build_band_mask(qu.shape[2], list(band_widths)),
                               device=qu.device)
        scores = scores.masked_fill(mask[None], _NEG_INF)
    return scores, mask


def flash_xl_attention_reference(qu, qv, k, v, p, sm_scale: float,
                                 band_widths: Optional[Sequence[int]] = None):
    """Plain PyTorch XL attention on head-major operands [B, H, T, d]: full
    position scores [B, H, T, 2T-1], skewed (the reference's
    ``_xla_xl_attention``), with scores and softmax in float32."""
    scores, _ = _hm_scores(qu, qv, k, p, sm_scale, band_widths)
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


def flash_xl_attention_lse_reference(qu, qv, k, v, p, sm_scale: float,
                                     band_widths: Optional[Sequence[int]] = None):
    """Plain version of the head-major LSE forward: (out [B, H, T, d], lse
    f32 [B, H, T])."""
    scores, _ = _hm_scores(qu, qv, k, p, sm_scale, band_widths)
    lse = torch.logsumexp(scores, dim=-1)
    return torch.matmul(torch.exp(scores - lse[..., None]).to(v.dtype), v), lse


def flash_xl_attention_backward_reference(qu, qv, k, v, p, o, lse, do, sm_scale: float,
                                          band_widths: Optional[Sequence[int]] = None):
    """Plain version of the head-major backward from the saved (o, lse): the
    formulas of ``_xl_bwd_dq_kernel``, in float32, with A and dS rounded to
    v's dtype before their products, as the kernels round them. Returns
    float32 (dqu, dqv, dk, dv, dp); :class:`XLAttention` casts them to the
    primals' dtypes."""
    scores, mask = _hm_scores(qu, qv, k, p, sm_scale, band_widths)
    a = torch.exp(scores - lse[..., None])
    if mask is not None:
        a = a.masked_fill(mask[None], 0.0)
    delta = (do.float() * o.float()).sum(-1)
    ds = a * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None])
    lo = v.dtype
    a_lo, ds_lo = a.to(lo).float(), ds.to(lo).float()
    dv = torch.matmul(a_lo.transpose(-1, -2), do.float())
    dk = torch.matmul(ds_lo.transpose(-1, -2), qu.float()) * sm_scale
    dqu = torch.matmul(ds_lo, k.float()) * sm_scale
    skew = rel_unshift(ds_lo)  # [B, H, T, 2T-1]
    dqv = torch.matmul(skew, p.float()[None]) * sm_scale
    dp = torch.matmul(skew.transpose(-1, -2), qv.float()).sum(0) * sm_scale
    return dqu, dqv, dk, dv, dp


def xl_attention_nhd_reference(q, k, v, bias_u, bias_v, p, num_heads: int,
                               sm_scale: float, band_widths: Optional[Sequence[int]] = None):
    """Plain PyTorch XL attention in the [B, T, H*d] layout: full position
    scores [B, H, T, 2T-1], skewed (the reference's ``_rel_position_scores``
    counterpart), with scores and softmax in float32."""
    qu, qv = add_pos_bias(q, bias_u, bias_v, num_heads)
    return _merge_heads(flash_xl_attention_reference(
        qu, qv, _split_heads(k, num_heads), _split_heads(v, num_heads), p, sm_scale, band_widths))


def xl_attention_nhd_lse_reference(q, k, v, bias_u, bias_v, p, num_heads: int,
                                   sm_scale: float, band_widths: Optional[Sequence[int]] = None):
    """Plain version of the LSE forward: (out [B, T, H*d], lse f32 [B, H, T])."""
    qu, qv = add_pos_bias(q, bias_u, bias_v, num_heads)
    out, lse = flash_xl_attention_lse_reference(
        qu, qv, _split_heads(k, num_heads), _split_heads(v, num_heads), p, sm_scale, band_widths)
    return _merge_heads(out), lse


def xl_attention_nhd_backward_reference(q, k, v, bias_u, bias_v, p, o, lse, do, num_heads: int,
                                        sm_scale: float,
                                        band_widths: Optional[Sequence[int]] = None):
    """Plain version of the backward from the saved (o, lse): the formulas
    of ``_xl_bwd_nhd_kernel``, in float32, with q+u and q+v rounded to q's
    dtype and A and dS to v's dtype before their products, as the kernels
    round them. Returns float32 (dq, dk, dv, dbu, dbv, dp);
    :class:`XLAttentionNHD` casts them to the primals' dtypes."""
    qu, qv = add_pos_bias(q, bias_u, bias_v, num_heads)
    kh, vh, oh, doh = (_split_heads(x, num_heads) for x in (k, v, o, do))
    dqu, dqv, dk, dv, dp = flash_xl_attention_backward_reference(
        qu, qv, kh, vh, p, oh, lse, doh, sm_scale, band_widths)
    return (_merge_heads(dqu + dqv), _merge_heads(dk), _merge_heads(dv), dqu.sum((0, 2)),
            dqv.sum((0, 2)), dp)


def _band_tensor(band_widths, num_heads: int, device) -> Optional[torch.Tensor]:
    if band_widths is None:
        return None
    widths = [int(w) for w in band_widths]
    if len(widths) != num_heads:
        raise ValueError(f"{len(widths)} band widths for {num_heads} heads")
    return torch.tensor(widths, dtype=torch.int32, device=device)


def _check(what, q, k, v, bias_u, bias_v, p, num_heads):
    """Shapes and operands the XL kernels take; returns the f32 biases."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    b, t, c = q.shape
    d = c // num_heads
    if (k.shape != q.shape or v.shape != q.shape or c % num_heads or d != 64
            or tuple(p.shape) != (num_heads, 2 * t - 1, d)
            or tuple(bias_u.shape) != (num_heads, d) or tuple(bias_v.shape) != (num_heads, d)):
        raise ValueError(
            f"{what}: unsupported shapes q {tuple(q.shape)}, p {tuple(p.shape)}, "
            f"bias {tuple(bias_u.shape)}, {num_heads} heads"
        )
    check_cuda_operands(what, q, k, v, p)
    return tuple(x.detach().to(device=q.device, dtype=torch.float32).contiguous()
                 for x in (bias_u, bias_v))


def _forward_kernel(q, k, v, bias_u, bias_v, p, num_heads, sm_scale, band_widths,
                    with_lse: bool):
    what = "flash_xl_attention_nhd_lse" if with_lse else "flash_xl_attention_nhd"
    bu, bv = _check(what, q, k, v, bias_u, bias_v, p, num_heads)
    b, t, c = q.shape
    band = _band_tensor(band_widths, num_heads, q.device)
    out = torch.empty((b, t, c), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, t), dtype=torch.float32, device=q.device) if with_lse else None
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bu.data_ptr(), bv.data_ptr(), p.data_ptr(),
            None if band is None else band.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    symbol = "t4s_xl_nhd_fwd_lse" if with_lse else "t4s_xl_nhd_fwd"
    with torch.cuda.device(q.device):
        status = _build.function("xl_attention", symbol, len(ptrs), 10)(
            *ptrs, b, t, num_heads, c // num_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            p.stride(0), p.stride(1), out.stride(0), out.stride(1),
            float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    return out, lse


def flash_xl_attention_nhd_lse(q, k, v, bias_u, bias_v, p, num_heads: int, sm_scale: float,
                               band_widths: Optional[Sequence[int]] = None):
    """(out [B, T, H*d], lse f32 [B, H, T]): the LSE forward kernel for
    CUDA tensors, its plain version for CPU tensors."""
    if q.device.type == "cpu":
        return xl_attention_nhd_lse_reference(q, k, v, bias_u, bias_v, p, num_heads, sm_scale,
                                              band_widths)
    out, lse = _forward_kernel(q, k, v, bias_u, bias_v, p, num_heads, sm_scale, band_widths,
                               with_lse=True)
    flash_xl_attention_nhd_lse.launches += 1
    return out, lse


def flash_xl_attention_nhd_backward(q, k, v, bias_u, bias_v, p, o, lse, do, num_heads: int,
                                    sm_scale: float,
                                    band_widths: Optional[Sequence[int]] = None):
    """(dq, dk, dv, dbu, dbv, dp) from the saved (o, lse): the backward
    kernel for CUDA tensors (each result in its primal's dtype), its plain
    version for CPU tensors (float32). dq = dQu + dQv and the bias
    gradients (sums of dQu and dQv over batch and time) are formed here in
    float32."""
    if q.device.type == "cpu":
        return xl_attention_nhd_backward_reference(q, k, v, bias_u, bias_v, p, o, lse, do,
                                                   num_heads, sm_scale, band_widths)
    what = "flash_xl_attention_nhd_backward"
    bu, bv = _check(what, q, k, v, bias_u, bias_v, p, num_heads)
    b, t, c = q.shape
    d = c // num_heads
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} / do {tuple(do.shape)} vs q {tuple(q.shape)}")
    check_cuda_operands(what, o, do)
    check_f32_rows(what, lse, (b, num_heads, t))
    band = _band_tensor(band_widths, num_heads, q.device)
    delta = row_delta(o, do, num_heads)
    f32 = dict(dtype=torch.float32, device=q.device)
    dqu, dqv = torch.zeros((b, t, c), **f32), torch.zeros((b, t, c), **f32)
    dp = torch.zeros((num_heads, 2 * t - 1, d), **f32)
    dk = torch.empty((b, t, c), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, c), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _build.function("xl_attention_bwd", "t4s_xl_nhd_bwd", 15, 14)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bu.data_ptr(),
            bv.data_ptr(), p.data_ptr(), None if band is None else band.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqu.data_ptr(), dqv.data_ptr(), dp.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, t, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1), p.stride(0), p.stride(1),
            dk.stride(0), dk.stride(1), dv.stride(0), dv.stride(1),
            float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_xl_attention_nhd_backward.launches += 1
    return ((dqu + dqv).to(q.dtype), dk, dv,
            dqu.reshape(b, t, num_heads, d).sum((0, 1)).to(bias_u.dtype),
            dqv.reshape(b, t, num_heads, d).sum((0, 1)).to(bias_v.dtype), dp.to(p.dtype))


class XLAttentionNHD(torch.autograd.Function):
    """The differentiated path: LSE forward, then the fused backward from
    the saved operands, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, bias_u, bias_v, p, num_heads: int, sm_scale: float, band_widths):
        out, lse = flash_xl_attention_nhd_lse(q, k, v, bias_u, bias_v, p, num_heads, sm_scale,
                                              band_widths)
        ctx.save_for_backward(q, k, v, bias_u, bias_v, p, out, lse)
        ctx.num_heads, ctx.sm_scale, ctx.band_widths = num_heads, sm_scale, band_widths
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_u, bias_v, p, out, lse = ctx.saved_tensors
        primals = (q, k, v, bias_u, bias_v, p)
        grads = flash_xl_attention_nhd_backward(
            *primals, out, lse, do.to(q.dtype).contiguous(), ctx.num_heads, ctx.sm_scale,
            ctx.band_widths)
        return (*(g.to(x.dtype) for g, x in zip(grads, primals)), None, None, None)


# -- the head-major family: qu and qv given, any strides, head dims 32 and 64 -----

HM_HEAD_DIMS = (32, 64)  # the head dims csrc/xl_attention_hm*.cu build


def _check_hm(what, qu, qv, k, v, p):
    """Shapes and operands the head-major kernels take."""
    if qu.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qu.device}")
    if qu.dim() != 4:
        raise ValueError(f"{what}: qu must be [B, H, T, d], got {tuple(qu.shape)}")
    b, h, t, d = qu.shape
    if (qv.shape != qu.shape or k.shape != qu.shape or v.shape != qu.shape
            or d not in HM_HEAD_DIMS or tuple(p.shape) != (h, 2 * t - 1, d)):
        raise ValueError(
            f"{what}: unsupported shapes qu {tuple(qu.shape)}, qv {tuple(qv.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, p {tuple(p.shape)} "
            f"(head dims {HM_HEAD_DIMS})")
    check_cuda_operands(what, qu, qv, k, v, p)


def _hm_strides(*tensors):
    return [s for x in tensors for s in x.stride()[:3]]


def _hm_empty(shape, dtype, device, zero: bool = False):
    """A [B, H, T, d] view of a fresh [B, T, H, d] buffer, so that merging
    the heads of a result back to [B, T, H*d] is a reshape without a copy."""
    b, h, t, d = shape
    make = torch.zeros if zero else torch.empty
    return make((b, t, h, d), dtype=dtype, device=device).permute(0, 2, 1, 3)


def _hm_forward_kernel(qu, qv, k, v, p, sm_scale, band_widths, with_lse: bool):
    what = "flash_xl_attention_lse" if with_lse else "flash_xl_attention"
    _check_hm(what, qu, qv, k, v, p)
    b, h, t, d = qu.shape
    band = _band_tensor(band_widths, h, qu.device)
    out = _hm_empty(qu.shape, qu.dtype, qu.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=qu.device) if with_lse else None
    ptrs = [qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            None if band is None else band.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    symbol = "t4s_xl_hm_fwd_lse" if with_lse else "t4s_xl_hm_fwd"
    with torch.cuda.device(qu.device):
        status = _build.function("xl_attention_hm", symbol, len(ptrs), 17)(
            *ptrs, b, t, h, d, *_hm_strides(qu, qv, k, v), p.stride(0), p.stride(1),
            *_hm_strides(out), float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    return out, lse


def flash_xl_attention_lse(qu, qv, k, v, p, sm_scale: float,
                           band_widths: Optional[Sequence[int]] = None):
    """(out [B, H, T, d], lse f32 [B, H, T]): the head-major LSE forward
    kernel for CUDA tensors, its plain version for CPU tensors."""
    if qu.device.type == "cpu":
        return flash_xl_attention_lse_reference(qu, qv, k, v, p, sm_scale, band_widths)
    out, lse = _hm_forward_kernel(qu, qv, k, v, p, sm_scale, band_widths, with_lse=True)
    flash_xl_attention_lse.launches += 1
    return out, lse


def flash_xl_attention_backward(qu, qv, k, v, p, o, lse, do, sm_scale: float,
                                band_widths: Optional[Sequence[int]] = None):
    """(dqu, dqv, dk, dv, dp) from the saved (o, lse): the head-major backward
    kernel for CUDA tensors (each result in its primal's dtype; dqu, dqv and
    dp are summed in float32 and rounded once), its plain version for CPU
    tensors (float32)."""
    if qu.device.type == "cpu":
        return flash_xl_attention_backward_reference(qu, qv, k, v, p, o, lse, do, sm_scale,
                                                     band_widths)
    what = "flash_xl_attention_backward"
    _check_hm(what, qu, qv, k, v, p)
    b, h, t, d = qu.shape
    if o.shape != qu.shape or do.shape != qu.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} / do {tuple(do.shape)} vs qu "
                         f"{tuple(qu.shape)}")
    check_cuda_operands(what, o, do)
    check_f32_rows(what, lse, (b, h, t))
    band = _band_tensor(band_widths, h, qu.device)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dqu = _hm_empty(qu.shape, torch.float32, qu.device, zero=True)
    dqv = _hm_empty(qu.shape, torch.float32, qu.device, zero=True)
    dp = torch.zeros((h, 2 * t - 1, d), dtype=torch.float32, device=qu.device)
    dk = _hm_empty(qu.shape, k.dtype, qu.device)
    dv = _hm_empty(qu.shape, v.dtype, qu.device)
    with torch.cuda.device(qu.device):
        status = _build.function("xl_attention_hm_bwd", "t4s_xl_hm_bwd", 14, 26)(
            qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            p.data_ptr(), None if band is None else band.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dqu.data_ptr(), dqv.data_ptr(), dp.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, d, *_hm_strides(qu, qv, k, v, do), p.stride(0),
            p.stride(1), *_hm_strides(dqu, dk, dv), float(sm_scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_xl_attention_backward.launches += 1
    return dqu.to(qu.dtype), dqv.to(qv.dtype), dk, dv, dp.to(p.dtype)


def _aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in place, else a packed copy."""
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        return x.contiguous()
    return x


class XLAttention(torch.autograd.Function):
    """The differentiated head-major path: LSE forward, then the fused
    backward from the saved operands, output and log-sum-exp; each gradient
    comes back in its primal's dtype."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, p, sm_scale: float, band_widths):
        out, lse = flash_xl_attention_lse(qu, qv, k, v, p, sm_scale, band_widths)
        ctx.save_for_backward(qu, qv, k, v, p, out, lse)
        ctx.sm_scale, ctx.band_widths = sm_scale, band_widths
        return out

    @staticmethod
    def backward(ctx, do):
        qu, qv, k, v, p, out, lse = ctx.saved_tensors
        primals = (qu, qv, k, v, p)
        grads = flash_xl_attention_backward(
            *primals, out, lse, _aligned_rows(do.to(qu.dtype)), ctx.sm_scale, ctx.band_widths)
        return (*(g.to(x.dtype) for g, x in zip(grads, primals)), None, None)


def flash_xl_attention(qu, qv, k, v, p, sm_scale: float,
                       band_widths: Optional[Sequence[int]] = None):
    """Fused XL attention on head-major operands: qu, qv (the query already
    summed with ``pos_bias_u`` / ``pos_bias_v``), k, v [B, H, T, d] with any
    batch, head and row strides, p [H, 2T-1, d] -> [B, H, T, d] (a view of a
    [B, T, H, d] buffer).

    Differentiated calls run :class:`XLAttention`; others launch the forward
    kernel for CUDA tensors (bf16, head dim 32 or 64) and take the plain
    version for CPU tensors. Any other case raises.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qu, qv, k, v, p)):
        return XLAttention.apply(qu, qv, k, v, p, sm_scale, band_widths)
    if qu.device.type == "cpu":
        return flash_xl_attention_reference(qu, qv, k, v, p, sm_scale, band_widths)
    out, _ = _hm_forward_kernel(qu, qv, k, v, p, sm_scale, band_widths, with_lse=False)
    flash_xl_attention.launches += 1
    return out


def flash_xl_attention_nhd(q, k, v, bias_u, bias_v, p, num_heads: int, sm_scale: float,
                           band_widths: Optional[Sequence[int]] = None):
    """Fused XL attention, q/k/v [B, T, H*d], bias_u/v [H, d], p [H, 2T-1, d]
    -> [B, T, H*d].

    At head dim 64, differentiated calls run :class:`XLAttentionNHD`; others
    launch the forward kernel for CUDA tensors (bf16 q/k/v/p) and take the
    plain version for CPU tensors. Any other head dim takes the head-major
    family, as the JAX package's fall-back does: q + bias_u and q + bias_v in
    float32 rounded to q's dtype, strided head-major views of k and v (no
    copy), :func:`flash_xl_attention`, and the heads merged back (a reshape
    of the kernel's [B, T, H, d] buffer). Autograd then forms dq = dqu + dqv
    and the bias gradients (sums over batch and time) in float32. What
    neither family takes raises.
    """
    if q.shape[-1] // num_heads != 64:
        qu, qv = add_pos_bias(q, bias_u, bias_v, num_heads)
        out = flash_xl_attention(qu, qv, _split_heads(k, num_heads), _split_heads(v, num_heads),
                                 p, sm_scale, band_widths)
        return _merge_heads(out)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, bias_u, bias_v, p)):
        return XLAttentionNHD.apply(q, k, v, bias_u, bias_v, p, num_heads, sm_scale, band_widths)
    if q.device.type == "cpu":
        return xl_attention_nhd_reference(q, k, v, bias_u, bias_v, p, num_heads, sm_scale,
                                          band_widths)
    out, _ = _forward_kernel(q, k, v, bias_u, bias_v, p, num_heads, sm_scale, band_widths,
                             with_lse=False)
    flash_xl_attention_nhd.launches += 1
    return out


flash_xl_attention_nhd.launches = 0
flash_xl_attention.launches = 0
flash_xl_attention_lse.launches = 0
flash_xl_attention_backward.launches = 0
flash_xl_attention_nhd_lse.launches = 0
flash_xl_attention_nhd_backward.launches = 0
