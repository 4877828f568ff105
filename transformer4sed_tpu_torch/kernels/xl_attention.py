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
    ``csrc/xl_attention_bwd.cu`` ``t4s_xl_bwd`` for ``_xl_nhd_backward``
    (dq, dk, dv, d``pos_bias_u``, d``pos_bias_v`` and dP);
  * head major, head dims 32 and 64 (qu, qv, k, v as [B, H, T, d] views with
    any batch, head and row strides; qu and qv given, dqu and dqv returned
    apart): ``csrc/xl_attention_hm.cu`` ``t4s_xl_hm_fwd`` for ``_xl_forward``,
    ``t4s_xl_hm_fwd_lse`` for ``_xl_forward_lse`` and
    ``csrc/xl_attention_bwd.cu`` ``t4s_xl_bwd`` for ``_xl_backward``
    (:func:`flash_xl_attention`, :class:`XLAttention`).

All four forwards run one body, ``csrc/xl_fwd.cuh`` (wgmma on TMA tiles,
the rel-shift as index arithmetic on a position strip loaded in 128-row TMA
tiles, the skew in registers by quad shuffles), in two modes: q + the
biases formed in the kernel (heads in lanes), or qu and qv given (head
major). Both backwards run one body
(``csrc/xl_bwd.cuh``: wgmma on TMA tiles, the strip loaded by TMA, dQ and
dP added by TMA reductions) between two passes of their own, in
``csrc/xl_attention_bwd.cu``, where the JAX wrappers run XLA code:
:func:`flash_xl_bwd_prepass` (delta = rowsum(dO * O) and the log-sum-exp
in base 2 into one side buffer, the float32 workspaces zeroed, and for row
13 qu = q + u and qv = q + v formed once) and :func:`flash_xl_bwd_postpass`
(dq, or dqu and dqv, and dP in bf16 in the caller's layout, and for row 13
the bias gradients). Each has a plain version and a launch counter. The
plain versions compute the full position scores and skew them
(:func:`rel_shift`, and its adjoint :func:`rel_unshift` in the backward).
:func:`flash_xl_attention_nhd` dispatches like the JAX ``custom_vjp``: at
head dim 64 differentiated calls run :class:`XLAttentionNHD` and others the
plain forward kernel, through the custom op ``t4s::xl_nhd_fwd`` (row 9's
no-grad calls go through ``t4s::xl_hm_fwd``); any other head dim goes, as
in the JAX package's fall-back, through strided head-major views to
:func:`flash_xl_attention`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels.flash_attention import (
    _merge_heads,
    _split_heads,
    aligned_rows,
    bwd_padded_rows,
    check_cuda_operands,
    check_f32_rows,
    flash_bwd_prepass_reference,
    hm_empty,
    hm_strides,
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


# planted faults of the XL forwards (csrc/xl_fwd.cuh: XfFault), for the kernel
# check only; round_u only where the kernel adds the biases (heads in lanes)
XF_FAULTS = {"clamp_strip": 1, "stale_tile": 2, "skew": 3, "round_u": 4}


def _forward_kernel(q, k, v, bias_u, bias_v, p, num_heads, sm_scale, band_widths,
                    with_lse: bool, fault: int = 0):
    """The launch of row 12 (``with_lse``) or row 2; ``fault`` plants one of
    ``XF_FAULTS``: 0 on every real path."""
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
        status = _build.function("xl_attention", symbol, len(ptrs), 10, n_ints=5)(
            *ptrs, b, t, num_heads, c // num_heads, fault,
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
                                    band_widths: Optional[Sequence[int]] = None, fault: int = 0):
    """(dq, dk, dv, dbu, dbv, dp) from the saved (o, lse): for CUDA tensors
    the pre-pass (delta, qu = q + u and qv = q + v, zeroed workspaces), the
    backward kernel and the post-pass (dq, dP and the bias gradients from
    float32 sums, each result in its primal's dtype), for CPU tensors the
    plain version (float32). ``fault`` plants one of ``XB_FAULTS``: 0 on
    every real path."""
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
    heads = lambda x: _split_heads(x, num_heads)  # noqa: E731  [B, H, T, d] views
    side, dq_acc, dp_acc, qu, qv = flash_xl_bwd_prepass(heads(o), heads(do), lse, d, heads(q), bu,
                                                        bv)
    colsum = torch.empty((b, num_heads, -(-t // XB_KEYS), 2, d), dtype=torch.float32,
                         device=q.device)
    dq, dk, dv = (torch.empty((b, t, c), dtype=x.dtype, device=q.device) for x in (q, k, v))
    dp = torch.empty(p.shape, dtype=p.dtype, device=q.device)
    xl_backward_kernel(qu, qv, heads(k), heads(v), heads(do), p, band, side, dq_acc, dp_acc,
                       colsum, heads(dk), heads(dv), sm_scale, fault)
    flash_xl_attention_nhd_backward.launches += 1
    _, _, _, dbias = flash_xl_bwd_postpass(dq_acc, dp_acc, colsum, sm_scale, heads(dq), None, dp)
    return dq, dk, dv, dbias[0].to(bias_u.dtype), dbias[1].to(bias_v.dtype), dp


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


def _hm_forward_kernel(qu, qv, k, v, p, sm_scale, band_widths, with_lse: bool,
                       fault: int = 0):
    """The launch of row 10 (``with_lse``) or row 9; ``fault`` plants one of
    ``XF_FAULTS`` but ``round_u``: 0 on every real path."""
    what = "flash_xl_attention_lse" if with_lse else "flash_xl_attention"
    _check_hm(what, qu, qv, k, v, p)
    b, h, t, d = qu.shape
    band = _band_tensor(band_widths, h, qu.device)
    out = hm_empty(qu.shape, qu.dtype, qu.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=qu.device) if with_lse else None
    ptrs = [qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            None if band is None else band.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    symbol = "t4s_xl_hm_fwd_lse" if with_lse else "t4s_xl_hm_fwd"
    with torch.cuda.device(qu.device):
        status = _build.function("xl_attention_hm", symbol, len(ptrs), 17, n_ints=5)(
            *ptrs, b, t, h, d, fault, *hm_strides(qu, qv, k, v), p.stride(0), p.stride(1),
            *hm_strides(out), float(sm_scale), torch.cuda.current_stream().cuda_stream,
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
                                band_widths: Optional[Sequence[int]] = None, fault: int = 0):
    """(dqu, dqv, dk, dv, dp) from the saved (o, lse): for CUDA tensors the
    pre-pass, the head-major backward kernel and the post-pass (each result in
    its primal's dtype; dqu, dqv and dp summed in float32 and rounded once),
    for CPU tensors the plain version (float32). ``fault`` as in
    :func:`flash_xl_attention_nhd_backward`."""
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
    side, dq_acc, dp_acc, _, _ = flash_xl_bwd_prepass(o, do, lse, 2 * d)
    dqu, dqv, dk, dv = (hm_empty(qu.shape, x.dtype, qu.device) for x in (qu, qv, k, v))
    dp = torch.empty(p.shape, dtype=p.dtype, device=qu.device)
    xl_backward_kernel(qu, qv, k, v, do, p, band, side, dq_acc, dp_acc, None, dk, dv, sm_scale,
                       fault)
    flash_xl_attention_backward.launches += 1
    flash_xl_bwd_postpass(dq_acc, dp_acc, None, sm_scale, dqu, dqv, dp)
    return dqu, dqv, dk, dv, dp


def xl_backward_kernel(qu, qv, k, v, do, p, band, side, dq_acc, dp_acc, colsum, dk, dv,
                       scale: float, fault: int = 0) -> None:
    """The launch of row 13's kernel (``colsum`` given: dQu + dQv summed) or
    row 11's (``colsum`` None) alone, between the passes, on [B, H, T, d]
    operands the wrapper checked (the timing phase of ``chip_smoke.py`` times
    it apart)."""
    b, h, t, d = qu.shape
    with torch.cuda.device(qu.device):
        status = _build.function("xl_attention_bwd", "t4s_xl_bwd", 13, 23, n_ints=5)(
            qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            p.data_ptr(), None if band is None else band.data_ptr(), side.data_ptr(),
            dq_acc.data_ptr(), dp_acc.data_ptr(), None if colsum is None else colsum.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, t, h, d, fault, *hm_strides(qu, qv, k, v, do),
            p.stride(0), p.stride(1), *hm_strides(dk, dv), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "t4s_xl_bwd")


# -- the two passes around both XL backward kernels (csrc/xl_attention_bwd.cu) ---------

XB_KEYS = 128  # keys a block of the XL backward (csrc/xl_bwd.cuh: XB_KEYS)
XB_PAD = 64  # dP workspace rows before P row 0 (csrc/xl_bwd.cuh: XB_PAD)
# planted faults of the XL backward kernel (csrc/xl_bwd.cuh: XbFault), for the
# kernel check only
XB_FAULTS = {"skip_dq_tile": 1, "clamp_strip": 2, "no_flush": 3}


def xl_bwd_dp_rows(t: int) -> int:
    """Rows per head of the dP workspace: every P row a strip piece of any
    block reaches, -64 .. 2T + 191."""
    return 2 * t + 256


def flash_xl_bwd_prepass_reference(o, do, lse, ws_cols: int, q=None, bias_u=None, bias_v=None):
    """Plain version of the XL backward's pre-pass on [B, H, T, d] views: the
    side rows of :func:`flash_bwd_prepass_reference` ((L * log2 e, delta) per
    row), the zeroed float32 workspaces dq_acc [B, H, T_pad, ws_cols] and
    dp_acc [H, 2T + 256, d], and with q ([B, H, T, d]) and the biases [H, d]
    qu = q + u and qv = q + v summed in float32 and rounded to q's dtype."""
    b, h, t, d = o.shape
    side, _ = flash_bwd_prepass_reference(o, do, lse)
    f32 = dict(dtype=torch.float32, device=o.device)
    dq_acc = torch.zeros((b, h, bwd_padded_rows(t), ws_cols), **f32)
    dp_acc = torch.zeros((h, xl_bwd_dp_rows(t), d), **f32)
    qu = qv = None
    if q is not None:
        qf = q.float()
        qu, qv = ((qf + x.float()[None, :, None]).to(q.dtype) for x in (bias_u, bias_v))
    return side, dq_acc, dp_acc, qu, qv


def flash_xl_bwd_prepass(o, do, lse, ws_cols: int, q=None, bias_u=None, bias_v=None,
                         ws: Optional[torch.Tensor] = None):
    """(side, dq_acc, dp_acc, qu, qv) for the XL backward kernels from o, do
    [B, H, T, d] (any batch, head and row strides) and lse f32 [B, H, T]:
    the pre-pass kernel for CUDA tensors (bf16, head dim 32 or 64; with q,
    head dim 64 and f32 biases), its plain version for CPU tensors.
    ``ws_cols`` is d (row 13: dQu + dQv) or 2d (row 11: dQu, dQv); qu and qv
    are None without q. ``ws`` is a flat f32 buffer to zero and split into
    the two workspaces in place of a fresh one."""
    if o.device.type == "cpu":
        return flash_xl_bwd_prepass_reference(o, do, lse, ws_cols, q, bias_u, bias_v)
    what = "flash_xl_bwd_prepass"
    b, h, t, d = o.shape
    if (do.shape != o.shape or d not in HM_HEAD_DIMS or ws_cols not in (d, 2 * d)
            or (q is not None and (q.shape != o.shape or d != 64))):
        raise ValueError(f"{what}: unsupported o {tuple(o.shape)} / do {tuple(do.shape)}, "
                         f"{ws_cols} workspace columns, q {None if q is None else tuple(q.shape)}")
    check_cuda_operands(what, o, do, *(() if q is None else (q,)))
    check_f32_rows(what, lse, (b, h, t))
    if q is not None:
        for x in (bias_u, bias_v):
            check_f32_rows(what, x, (h, d))
    tp = bwd_padded_rows(t)
    n_dq, n_dp = b * h * tp * ws_cols, h * xl_bwd_dp_rows(t) * d
    f32 = dict(dtype=torch.float32, device=o.device)
    side = torch.empty((b, h, tp, 2), **f32)
    if ws is None:
        ws = torch.empty(n_dq + n_dp, **f32)
    check_f32_rows(what, ws, (n_dq + n_dp,))
    qu = qv = None
    if q is not None:
        qu, qv = (torch.empty((b, h, t, d), dtype=q.dtype, device=o.device) for _ in range(2))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(o.device):
        status = _build.function("xl_attention_bwd", "t4s_xl_bwd_prepass", 10, 9, n_ints=5,
                                 n_floats=0)(
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), side.data_ptr(), ws.data_ptr(), ptr(q),
            ptr(bias_u if q is not None else None), ptr(bias_v if q is not None else None),
            ptr(qu), ptr(qv), b, t, h, d, ws_cols, *hm_strides(o, do),
            *(hm_strides(q) if q is not None else (0, 0, 0)),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_xl_bwd_prepass.launches += 1
    return (side, ws[:n_dq].view(b, h, tp, ws_cols), ws[n_dq:].view(h, xl_bwd_dp_rows(t), d),
            qu, qv)


def flash_xl_bwd_postpass_reference(dq_acc, dp_acc, colsum, scale: float, dq, dqv, dp):
    """Plain version of the post-pass: with ``colsum`` (row 13), ``dq`` =
    scale * dq_acc[:, :, :T] and dbias [2, H, d] = scale * colsum [B, H,
    n_kt, 2, d] summed over batch and key tiles; without (row 11), ``dq`` and
    ``dqv`` = scale * each column half. ``dp`` = scale * the dP workspace's
    rows of P rows 0 .. 2T-2. Returns (dq, dqv, dp, dbias or None)."""
    t, d = dq.shape[2], dq.shape[3]
    dq.copy_(dq_acc[:, :, :t, :d] * scale)
    if colsum is None:
        dqv.copy_(dq_acc[:, :, :t, d:] * scale)
    dp.copy_(dp_acc[:, XB_PAD:XB_PAD + 2 * t - 1] * scale)
    dbias = None if colsum is None else colsum.sum((0, 2)).transpose(0, 1) * scale
    return dq, dqv, dp, dbias


def flash_xl_bwd_postpass(dq_acc, dp_acc, colsum, scale: float, dq, dqv, dp):
    """dq (and dqv), dp and the bias gradients from the f32 workspaces, as
    :func:`flash_xl_bwd_postpass_reference` says: the post-pass kernel for
    CUDA tensors (bf16 [B, H, T, d] views dq, dqv and a bf16 [H, 2T-1, d]
    view dp, of any strides), its plain version for CPU tensors."""
    if dq.device.type == "cpu":
        return flash_xl_bwd_postpass_reference(dq_acc, dp_acc, colsum, scale, dq, dqv, dp)
    what = "flash_xl_bwd_postpass"
    b, h, t, d = dq.shape
    if d not in HM_HEAD_DIMS or tuple(dp.shape) != (h, 2 * t - 1, d):
        raise ValueError(f"{what}: unsupported dq {tuple(dq.shape)}, dp {tuple(dp.shape)}")
    check_cuda_operands(what, dq, dp, *(() if dqv is None else (dqv,)))
    check_f32_rows(what, dq_acc, (b, h, bwd_padded_rows(t), d if colsum is not None else 2 * d))
    check_f32_rows(what, dp_acc, (h, xl_bwd_dp_rows(t), d))
    dbias = None
    if colsum is not None:
        check_f32_rows(what, colsum, (b, h, -(-t // XB_KEYS), 2, d))
        dbias = torch.empty((2, h, d), dtype=torch.float32, device=dq.device)
    strides_v = hm_strides(dqv) if dqv is not None else (0, 0, 0)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dq.device):
        status = _build.function("xl_attention_bwd", "t4s_xl_bwd_postpass", 7, 8)(
            dq_acc.data_ptr(), dp_acc.data_ptr(), ptr(colsum), dq.data_ptr(), ptr(dqv),
            dp.data_ptr(), ptr(dbias), b, t, h, d, *hm_strides(dq), *strides_v, dp.stride(0),
            dp.stride(1), float(scale), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_xl_bwd_postpass.launches += 1
    return dq, dqv, dp, dbias


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
            *primals, out, lse, aligned_rows(do.to(qu.dtype)), ctx.sm_scale, ctx.band_widths)
        return (*(g.to(x.dtype) for g, x in zip(grads, primals)), None, None)


def flash_xl_attention(qu, qv, k, v, p, sm_scale: float,
                       band_widths: Optional[Sequence[int]] = None):
    """Fused XL attention on head-major operands: qu, qv (the query already
    summed with ``pos_bias_u`` / ``pos_bias_v``), k, v [B, H, T, d] with any
    batch, head and row strides, p [H, 2T-1, d] -> [B, H, T, d] (a view of a
    [B, T, H, d] buffer).

    Differentiated calls run :class:`XLAttention`; others call the op
    ``t4s::xl_hm_fwd``, which launches the forward kernel for CUDA tensors
    (bf16, head dim 32 or 64) and takes the plain version for CPU tensors.
    Any other case raises.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qu, qv, k, v, p)):
        return XLAttention.apply(qu, qv, k, v, p, sm_scale, band_widths)
    return xl_hm_fwd(qu, qv, k, v, p, float(sm_scale), _band_list(band_widths))


def flash_xl_attention_nhd(q, k, v, bias_u, bias_v, p, num_heads: int, sm_scale: float,
                           band_widths: Optional[Sequence[int]] = None):
    """Fused XL attention, q/k/v [B, T, H*d], bias_u/v [H, d], p [H, 2T-1, d]
    -> [B, T, H*d].

    At head dim 64, differentiated calls run :class:`XLAttentionNHD`; others
    call the op ``t4s::xl_nhd_fwd``, which launches the forward kernel for
    CUDA tensors (bf16 q/k/v/p) and takes the plain version for CPU tensors.
    Any other head dim takes the head-major family, as the JAX package's
    fall-back does: q + bias_u and q + bias_v in
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
    return xl_nhd_fwd(q, k, v, bias_u, bias_v, p, num_heads, float(sm_scale),
                      _band_list(band_widths))


# -- rows 2 and 9 as custom ops (the no-grad calls of the two wrappers) --------------


def _band_list(band_widths) -> Optional[list]:
    """Band widths as the ops' ``int[]?`` argument."""
    return None if band_widths is None else [int(w) for w in band_widths]


def _nhd_fwd_cuda(q, k, v, bias_u, bias_v, p, num_heads: int, sm_scale: float, band_widths):
    out, _ = _forward_kernel(q, k, v, bias_u, bias_v, p, num_heads, sm_scale, band_widths,
                             with_lse=False)
    flash_xl_attention_nhd.launches += 1
    return out


def _hm_fwd_cpu(qu, qv, k, v, p, sm_scale: float, band_widths):
    """The plain version in the kernel's layout (a view of a [B, T, H, d]
    buffer), as the op's fake implementation gives it."""
    out = hm_empty(qu.shape, qu.dtype, qu.device)
    return out.copy_(flash_xl_attention_reference(qu, qv, k, v, p, sm_scale, band_widths))


def _hm_fwd_cuda(qu, qv, k, v, p, sm_scale: float, band_widths):
    out, _ = _hm_forward_kernel(qu, qv, k, v, p, sm_scale, band_widths, with_lse=False)
    flash_xl_attention.launches += 1
    return out


xl_nhd_fwd = _build.define_op(
    "xl_nhd_fwd", "(Tensor q, Tensor k, Tensor v, Tensor bias_u, Tensor bias_v, Tensor p, "
    "int num_heads, float sm_scale, int[]? band_widths) -> Tensor",
    cpu=xl_attention_nhd_reference, cuda=_nhd_fwd_cuda,
    fake=lambda q, *args: q.new_empty(q.shape))
xl_hm_fwd = _build.define_op(
    "xl_hm_fwd", "(Tensor qu, Tensor qv, Tensor k, Tensor v, Tensor p, float sm_scale, "
    "int[]? band_widths) -> Tensor",
    cpu=_hm_fwd_cpu, cuda=_hm_fwd_cuda,
    fake=lambda qu, *args: hm_empty(qu.shape, qu.dtype, qu.device))


flash_xl_attention_nhd.launches = 0
flash_xl_attention.launches = 0
flash_xl_attention_lse.launches = 0
flash_xl_attention_backward.launches = 0
flash_xl_attention_nhd_lse.launches = 0
flash_xl_attention_nhd_backward.launches = 0
flash_xl_bwd_prepass.launches = 0
flash_xl_bwd_postpass.launches = 0
