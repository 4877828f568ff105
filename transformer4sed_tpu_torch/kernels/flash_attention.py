"""Flash attention: the CUDA kernels and their plain versions.

Port of ``transformer4sed_tpu/kernels/flash_attention.py``: softmax
attention with no mask, in two layouts, each read by stride so no head
transpose is made.

Heads in lanes (the PaSST backbone's attention, ``models/vit.py:113-122``),
q/k/v given as [B, N, H*d] lane slices of the qkv projection, head dim 64:

  * ``csrc/flash_attention.cu`` ``t4s_flash_nhd_fwd`` for
    ``_flash_nhd_forward`` (no-grad calls: serving, the mean teacher);
  * the same source's ``t4s_flash_nhd_fwd_lse`` for
    ``_flash_nhd_forward_lse`` (output and row log-sum-exp);
  * ``csrc/flash_attention_bwd.cu`` ``t4s_flash_nhd_bwd`` for
    ``_flash_nhd_backward`` (dq, dk, dv from the saved output and
    log-sum-exp; wgmma on TMA tiles, ``csrc/flash_bwd.cuh``).

Head major (head-parallel attention, ``parallel/partition.py``, and the
head-dim fall-back of :func:`flash_attention_nhd`), q/k/v given as
[B, H, T, d] tensors of any batch, head and row strides, head dims 32 and 64:

  * ``csrc/flash_attention_hm.cu`` ``t4s_flash_hm_fwd`` for
    ``_flash_forward`` and ``t4s_flash_hm_fwd_lse`` for
    ``_flash_forward_lse``;
  * ``csrc/flash_attention_hm_bwd.cu`` for ``_flash_backward`` (one kernel
    where the TPU runs two, the same device code as the heads-in-lanes one);
  * ``csrc/flash_attention_bias.cu`` for ``_flash_bias_forward``: the same
    forward with an additive float32 score bias [B, H, T, T] of any batch,
    head and row strides (:func:`flash_attention_bias`, the XL attention's
    explicitly masked branch). Its backward, like the JAX custom VJP's, is
    autograd through the plain version (:class:`FlashAttentionBias`).

Both backward kernels run between two passes of their own, in
``csrc/flash_attention_bwd.cu``, where the JAX wrappers run XLA code:
:func:`flash_bwd_prepass` (``t4s_flash_bwd_prepass``) computes delta =
rowsum(dO * O) in float32 from the bf16 operands and their strides, with the
log-sum-exp in base 2, into one side buffer, and zeroes the float32 dQ
workspace in the same launch; :func:`flash_bwd_postpass`
(``t4s_flash_bwd_postpass``) writes dQ = scale * workspace in bf16 in the
caller's layout. Each has a plain version and a launch counter.

:func:`flash_attention_nhd` and :func:`flash_attention` dispatch like the
JAX ``custom_vjp``: with autograd recording and an operand that requires
grad they run their autograd Function (LSE forward, saved-O/LSE backward),
otherwise the plain forward kernel. :func:`flash_attention_nhd` sends any
head dim other than 64 through strided head-major views to
:func:`flash_attention`, as the JAX package does. Each wrapper launches its
kernel for CUDA tensors and uses its plain version only for tensors on the
CPU.
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
                                 sm_scale: Optional[float] = None, skip_dq_tile: int = -1):
    """(dq, dk, dv) from the saved (o, lse): for CUDA tensors the pre-pass,
    the backward kernel and the post-pass (bf16 results; dq summed in float32
    and rounded once), for CPU tensors the plain version (float32).
    ``skip_dq_tile`` leaves one 128-key tile's dQ partial out: a planted
    fault's switch, -1 (none) on every real path."""
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
    side, dq_acc = flash_bwd_prepass(_split_heads(o, num_heads), _split_heads(do, num_heads), lse)
    dq, dk, dv = (torch.empty((b, n, c), dtype=x.dtype, device=q.device) for x in (q, k, v))
    nhd_backward_kernel(q, k, v, do, side, dq_acc, dk, dv, num_heads, scale, skip_dq_tile)
    flash_attention_nhd_backward.launches += 1
    flash_bwd_postpass(dq_acc, _split_heads(dq, num_heads), scale)
    return dq, dk, dv


def nhd_backward_kernel(q, k, v, do, side, dq_acc, dk, dv, num_heads: int, scale: float,
                        skip_dq_tile: int = -1) -> None:
    """The launch of row 8's kernel alone, between the passes, on operands
    the wrapper checked (the timing phase of ``chip_smoke.py`` times it
    apart)."""
    b, n, c = q.shape
    with torch.cuda.device(q.device):
        status = _build.function("flash_attention_bwd", "t4s_flash_nhd_bwd", 8, 12, n_ints=5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), side.data_ptr(),
            dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, num_heads, c // num_heads,
            skip_dq_tile, *_strides(q, k, v, do, dk, dv), scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "flash_attention_nhd_backward")


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

    At head dim 64, differentiated calls run :class:`FlashAttentionNHD`;
    others launch the forward kernel for CUDA tensors (bf16) and take the
    plain version for CPU tensors. Any other head dim goes, as in the JAX
    package's fall-back, through strided [B, H, N, d] views (no copy) to
    :func:`flash_attention`, and the heads are merged back (a reshape of the
    kernel's [B, N, H, d] buffer). What neither family takes raises.
    """
    scale = _scale(q, num_heads, sm_scale)
    if q.shape[-1] // num_heads != 64:
        return _merge_heads(flash_attention(*(_split_heads(x, num_heads) for x in (q, k, v)),
                                            scale))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionNHD.apply(q, k, v, num_heads, scale)
    if q.device.type == "cpu":
        return flash_attention_nhd_reference(q, k, v, num_heads, scale)
    out, _ = _forward_kernel(q, k, v, num_heads, scale, with_lse=False)
    flash_attention_nhd.launches += 1
    return out


# -- the head-major family: any strides, head dims 32 and 64 ----------------------

HM_HEAD_DIMS = (32, 64)  # the head dims csrc/flash_attention_hm*.cu build


def _hm_scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _hm_scores(q, k, scale):
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_attention_reference(q, k, v, sm_scale: Optional[float] = None):
    """Plain PyTorch softmax attention on [B, H, T, d]; scores and softmax in
    float32 (the reference's ``_xla_attention``)."""
    s = _hm_scores(q, k, _hm_scale(q, sm_scale))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def flash_attention_lse_reference(q, k, v, sm_scale: Optional[float] = None):
    """Plain version of the head-major LSE forward: (out [B, H, T, d], lse
    f32 [B, H, T])."""
    s = _hm_scores(q, k, _hm_scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]).to(v.dtype), v), lse


def flash_attention_backward_reference(q, k, v, o, lse, do, sm_scale: Optional[float] = None):
    """Plain version of the head-major backward from the saved (o, lse): the
    formulas of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, in float32, with
    P and dS rounded to v's dtype before their products as the kernels round
    them. Returns float32 (dq, dk, dv)."""
    scale = _hm_scale(q, sm_scale)
    p = torch.exp(_hm_scores(q, k, scale) - lse[..., None])
    delta = (do.float() * o.float()).sum(-1)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None])
    lo = v.dtype
    p_lo, ds_lo = p.to(lo).float(), ds.to(lo).float()
    dv = torch.matmul(p_lo.transpose(-1, -2), do.float())
    dk = torch.matmul(ds_lo.transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(ds_lo, k.float()) * scale
    return dq, dk, dv


def hm_empty(shape, dtype, device, zero: bool = False) -> torch.Tensor:
    """A [B, H, T, d] view of a fresh [B, T, H, d] buffer, so that merging
    the heads of a result back to [B, T, H*d] is a reshape without a copy."""
    b, h, t, d = shape
    make = torch.zeros if zero else torch.empty
    return make((b, t, h, d), dtype=dtype, device=device).permute(0, 2, 1, 3)


def hm_strides(*tensors):
    """Batch, head and row strides of each [B, H, T, d] operand, in order."""
    return [s for x in tensors for s in x.stride()[:3]]


def aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in place, else a packed copy."""
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        return x.contiguous()
    return x


# -- the two passes around both backward kernels (csrc/flash_attention_bwd.cu) --------

LOG2E = 1.4426950408889634
BWD_ROWS = 64  # query rows of one backward stage (csrc/flash_bwd.cuh: FB_QROWS)


def bwd_padded_rows(t: int) -> int:
    """T rounded up to whole query tiles: the rows of the pre-pass's buffers."""
    return -(-t // BWD_ROWS) * BWD_ROWS


def flash_bwd_prepass_reference(o, do, lse):
    """Plain version of the backward's pre-pass on [B, H, T, d] views: the
    side rows [B, H, T_pad, 2] in float32, (L * log2 e, delta = rowsum(dO *
    O)) per row (+inf and 0 past T, +inf where L is -inf: such a row weighs
    0), and a zeroed float32 dQ workspace [B, H, T_pad, d]."""
    b, h, t, d = o.shape
    tp = bwd_padded_rows(t)
    side = torch.zeros((b, h, tp, 2), dtype=torch.float32, device=o.device)
    side[..., 0] = math.inf
    side[..., :t, 0] = torch.where(lse == -math.inf, math.inf, lse.float() * LOG2E)
    side[..., :t, 1] = (do.float() * o.float()).sum(-1)
    return side, torch.zeros((b, h, tp, d), dtype=torch.float32, device=o.device)


def flash_bwd_prepass(o, do, lse, dq_acc: Optional[torch.Tensor] = None):
    """(side, dq_acc) for the backward kernels from o, do [B, H, T, d] (any
    batch, head and row strides) and lse f32 [B, H, T]: the pre-pass kernel
    for CUDA tensors (bf16, head dim 32 or 64), its plain version for CPU
    tensors. ``dq_acc`` is a workspace to zero in place of a fresh one."""
    if o.device.type == "cpu":
        return flash_bwd_prepass_reference(o, do, lse)
    what = "flash_bwd_prepass"
    b, h, t, d = o.shape
    if o.device.type != "cuda" or do.shape != o.shape or d not in HM_HEAD_DIMS:
        raise ValueError(f"{what}: unsupported o {tuple(o.shape)} / do {tuple(do.shape)} on "
                         f"{o.device} (head dims {HM_HEAD_DIMS})")
    check_cuda_operands(what, o, do)
    check_f32_rows(what, lse, (b, h, t))
    tp = bwd_padded_rows(t)
    side = torch.empty((b, h, tp, 2), dtype=torch.float32, device=o.device)
    if dq_acc is None:
        dq_acc = torch.empty((b, h, tp, d), dtype=torch.float32, device=o.device)
    check_f32_rows(what, dq_acc, (b, h, tp, d))
    with torch.cuda.device(o.device):
        status = _build.function("flash_attention_bwd", "t4s_flash_bwd_prepass", 5, 6,
                                 n_floats=0)(
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), side.data_ptr(), dq_acc.data_ptr(),
            b, t, h, d, *hm_strides(o, do), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_bwd_prepass.launches += 1
    return side, dq_acc


def flash_bwd_postpass_reference(dq_acc, out, scale: float):
    """Plain version of the post-pass: ``out`` = scale * dq_acc[:, :, :T] in
    out's dtype."""
    return out.copy_(dq_acc[:, :, :out.shape[2]] * scale)


def flash_bwd_postpass(dq_acc, out, scale: float):
    """dq into ``out`` (a [B, H, T, d] view of any batch, head and row
    strides) from the f32 workspace [B, H, T_pad, d]: the post-pass kernel
    for CUDA tensors (bf16 out), its plain version for CPU tensors."""
    if out.device.type == "cpu":
        return flash_bwd_postpass_reference(dq_acc, out, scale)
    what = "flash_bwd_postpass"
    b, h, t, d = out.shape
    if out.device.type != "cuda" or d not in HM_HEAD_DIMS:
        raise ValueError(f"{what}: unsupported out {tuple(out.shape)} on {out.device}")
    check_cuda_operands(what, out)
    check_f32_rows(what, dq_acc, (b, h, bwd_padded_rows(t), d))
    with torch.cuda.device(out.device):
        status = _build.function("flash_attention_bwd", "t4s_flash_bwd_postpass", 2, 3)(
            dq_acc.data_ptr(), out.data_ptr(), b, t, h, d, *hm_strides(out), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_bwd_postpass.launches += 1
    return out


def _check_hm(what, q, k, v):
    """Shapes and operands the head-major kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] not in HM_HEAD_DIMS:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (head dims {HM_HEAD_DIMS})")
    check_cuda_operands(what, q, k, v)


def _hm_forward_kernel(q, k, v, scale, with_lse: bool):
    what = "flash_attention_lse" if with_lse else "flash_attention"
    _check_hm(what, q, k, v)
    b, h, t, d = q.shape
    out = hm_empty(q.shape, q.dtype, q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    symbol = "t4s_flash_hm_fwd_lse" if with_lse else "t4s_flash_hm_fwd"
    with torch.cuda.device(q.device):
        status = _build.function("flash_attention_hm", symbol, len(ptrs), 12)(
            *ptrs, b, t, h, d, *hm_strides(q, k, v, out), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    return out, lse


def flash_attention_lse(q, k, v, sm_scale: Optional[float] = None):
    """(out [B, H, T, d], lse f32 [B, H, T]): the head-major LSE forward
    kernel for CUDA tensors (bf16, head dim 32 or 64), its plain version for
    CPU tensors."""
    scale = _hm_scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, scale)
    out, lse = _hm_forward_kernel(q, k, v, scale, with_lse=True)
    flash_attention_lse.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do, sm_scale: Optional[float] = None,
                             skip_dq_tile: int = -1):
    """(dq, dk, dv) from the saved (o, lse): for CUDA tensors the pre-pass,
    the head-major backward kernel and the post-pass (bf16 results; dq summed
    in float32 and rounded once), for CPU tensors the plain version
    (float32). ``skip_dq_tile`` as in :func:`flash_attention_nhd_backward`."""
    scale = _hm_scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    what = "flash_attention_backward"
    _check_hm(what, q, k, v)
    b, h, t, d = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} / do {tuple(do.shape)} vs q {tuple(q.shape)}")
    check_cuda_operands(what, o, do)
    check_f32_rows(what, lse, (b, h, t))
    side, dq_acc = flash_bwd_prepass(o, do, lse)
    dq, dk, dv = (hm_empty(q.shape, x.dtype, q.device) for x in (q, k, v))
    hm_backward_kernel(q, k, v, do, side, dq_acc, dk, dv, scale, skip_dq_tile)
    flash_attention_backward.launches += 1
    flash_bwd_postpass(dq_acc, dq, scale)
    return dq, dk, dv


def hm_backward_kernel(q, k, v, do, side, dq_acc, dk, dv, scale: float,
                       skip_dq_tile: int = -1) -> None:
    """The launch of row 6's kernel alone, between the passes, on operands
    the wrapper checked (the timing phase of ``chip_smoke.py`` times it
    apart)."""
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        status = _build.function("flash_attention_hm_bwd", "t4s_flash_hm_bwd", 8, 18, n_ints=5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), side.data_ptr(),
            dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d, skip_dq_tile,
            *hm_strides(q, k, v, do, dk, dv), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "flash_attention_backward")


class FlashAttention(torch.autograd.Function):
    """The differentiated head-major path: LSE forward, then the fused
    backward from the saved q, k, v, output and log-sum-exp; each gradient
    comes back in its primal's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward(q, k, v, out, lse, aligned_rows(do.to(q.dtype)),
                                         ctx.scale)
        return (*(g.to(x.dtype) for g, x in zip(grads, (q, k, v))), None)


def flash_attention(q, k, v, sm_scale: Optional[float] = None):
    """softmax(scale * Q K^T) V on head-major q/k/v [B, H, T, d] with any
    batch, head and row strides -> [B, H, T, d] (on the card a view of a
    [B, T, H, d] buffer); the scale defaults to 1/sqrt(d).

    Differentiated calls run :class:`FlashAttention`; others launch the
    forward kernel for CUDA tensors (bf16, head dim 32 or 64) and take the
    plain version for CPU tensors. Any other case raises.
    """
    scale = _hm_scale(q, sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    out, _ = _hm_forward_kernel(q, k, v, scale, with_lse=False)
    flash_attention.launches += 1
    return out


# -- row 4: the head-major forward with an additive score bias --------------------------


def flash_attention_bias_reference(q, k, v, bias, sm_scale: float):
    """Plain PyTorch attention with an additive score bias (the reference's
    ``_xla_attention_bias``): f32 scores plus the bias, softmax, the product
    with the probabilities rounded to v's dtype; q/k/v [B, H, T, d], bias
    [B, H, T, T] (or any shape that broadcasts to it)."""
    s = _hm_scores(q, k, sm_scale) + bias.float()
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def _check_bias(what, q, bias):
    b, h, t, _ = q.shape
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, h, t, t):
        raise ValueError(f"{what}: expected a float32 bias {(b, h, t, t)}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if bias.device != q.device or bias.stride(-1) != 1:
        raise ValueError(f"{what}: the bias needs unit column stride on {q.device}, got strides "
                         f"{bias.stride()} on {bias.device}")


def _bias_forward(q, k, v, bias, scale):
    """The row-4 kernel for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cpu":
        return flash_attention_bias_reference(q, k, v, bias, scale)
    what = "flash_attention_bias"
    _check_hm(what, q, k, v)
    _check_bias(what, q, bias)
    b, h, t, d = q.shape
    out = hm_empty(q.shape, q.dtype, q.device)
    with torch.cuda.device(q.device):
        status = _build.function("flash_attention_bias", "t4s_flash_bias_fwd", 5, 15)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, t, h, d, *hm_strides(q, k, v, bias, out), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    flash_attention_bias.launches += 1
    return out


class FlashAttentionBias(torch.autograd.Function):
    """Row 4 differentiated as the JAX package does it (``_bias_bwd``, no
    backward kernel): the forward kernel (the plain version on the CPU), then
    the gradients of the plain version, recomputed under autograd, for the
    cotangent cast to the output's dtype: dq, dk, dv and dbias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _bias_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        primals = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_bias_reference(*primals, ctx.scale)
            grads = torch.autograd.grad(out, primals, do.to(out.dtype))
        return (*grads, None)


def flash_attention_bias(q, k, v, bias, sm_scale: float = 1.0):
    """softmax(scale * Q K^T + bias) V on head-major q/k/v [B, H, T, d] (any
    batch, head and row strides) with a float32 bias [B, H, T, T] (any batch,
    head and row strides, 0 for an expanded axis) -> [B, H, T, d] (on the card
    a view of a [B, T, H, d] buffer). A blocked score is -1e30, not -inf: a
    row blocked everywhere attends every key alike, as in JAX.

    Differentiated calls run :class:`FlashAttentionBias`; others launch the
    kernel for CUDA tensors (bf16, head dim 32 or 64) and take the plain
    version for CPU tensors.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, bias)):
        return FlashAttentionBias.apply(q, k, v, bias, sm_scale)
    return _bias_forward(q, k, v, bias, sm_scale)


flash_attention_nhd.launches = 0
flash_attention_nhd_lse.launches = 0
flash_attention_nhd_backward.launches = 0
flash_attention.launches = 0
flash_attention_lse.launches = 0
flash_attention_backward.launches = 0
flash_attention_bias.launches = 0
flash_bwd_prepass.launches = 0
flash_bwd_postpass.launches = 0
