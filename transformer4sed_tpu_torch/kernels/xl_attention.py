"""Fused heads-in-lanes Transformer-XL attention: the CUDA kernel and its
plain version.

Port of ``transformer4sed_tpu/kernels/xl_attention.py:_xl_nhd_forward``
(the MAT-SED decoder's attention, ``models/xl.py:182-197``):

    softmax(scale * ((q+u) K^T + relshift((q+v) P^T))) V

with q/k/v as [B, T, H*d] lane slices, u/v = ``pos_bias_u``/``pos_bias_v``
[H, d] added in float32 and rounded to q's dtype, P the projected
position table [H, 2T-1, d] in offset order T-1 ... -(T-1), and an
optional per-head band (row i attends [i - w//2, i + w//2) plus i).
The kernel (``csrc/xl_attention.cu``) does the rel-shift as index
arithmetic on a position strip in shared memory; the plain version
below computes the full position scores and skews them.

Forward only: the backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels.flash_attention import (
    _merge_heads,
    _split_heads,
    check_cuda_operands,
    forbid_grad,
)

_NEG_INF = -1e30
_FN = None


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T-1] position scores -> [..., T, T] with
    out[..., i, j] = x[..., i, (T-1) - i + j] (pad/reshape skew)."""
    *lead, t, n = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(*lead, 2 * t, t)[..., 1:, :]
    return x.reshape(*lead, t, n)[..., :t]


def xl_attention_nhd_reference(q, k, v, bias_u, bias_v, p, num_heads: int,
                               sm_scale: float, band_widths: Optional[Sequence[int]] = None):
    """Plain PyTorch XL attention in the [B, T, H*d] layout: full position
    scores [B, H, T, 2T-1], skewed (the reference's ``_rel_position_scores``
    counterpart), with scores and softmax in float32."""
    from transformer4sed_tpu_torch.models.xl import build_band_mask

    t = q.shape[1]
    qh = _split_heads(q, num_heads)
    qu = (qh.float() + bias_u.float()[None, :, None]).to(q.dtype)
    qv = (qh.float() + bias_v.float()[None, :, None]).to(q.dtype)
    kh, vh = _split_heads(k, num_heads), _split_heads(v, num_heads)
    content = torch.matmul(qu.float(), kh.float().transpose(-1, -2))
    position = rel_shift(torch.matmul(qv.float(), p.float().transpose(-1, -2)[None]))
    scores = (content + position) * sm_scale
    if band_widths is not None:
        mask = torch.as_tensor(build_band_mask(t, list(band_widths)), device=q.device)
        scores = scores.masked_fill(mask[None], _NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    return _merge_heads(torch.matmul(attn.to(v.dtype), vh))


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("xl_attention").t4s_xl_nhd_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _band_tensor(band_widths, num_heads: int, device) -> Optional[torch.Tensor]:
    if band_widths is None:
        return None
    widths = [int(w) for w in band_widths]
    if len(widths) != num_heads:
        raise ValueError(f"{len(widths)} band widths for {num_heads} heads")
    return torch.tensor(widths, dtype=torch.int32, device=device)


def flash_xl_attention_nhd(q, k, v, bias_u, bias_v, p, num_heads: int, sm_scale: float,
                           band_widths: Optional[Sequence[int]] = None):
    """Fused XL attention, q/k/v [B, T, H*d], bias_u/v [H, d], p [H, 2T-1, d]
    -> [B, T, H*d].

    CUDA tensors (bf16 q/k/v/p, head dim 64) launch the hand-written
    kernel; CPU tensors take the plain version. Any other case raises.
    """
    b, t, c = q.shape
    d = c // num_heads
    if q.device.type == "cpu":
        return xl_attention_nhd_reference(q, k, v, bias_u, bias_v, p, num_heads, sm_scale,
                                          band_widths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_xl_attention_nhd: no kernel for device {q.device}")
    if (k.shape != q.shape or v.shape != q.shape or c % num_heads or d != 64
            or tuple(p.shape) != (num_heads, 2 * t - 1, d)
            or tuple(bias_u.shape) != (num_heads, d) or tuple(bias_v.shape) != (num_heads, d)):
        raise ValueError(
            f"flash_xl_attention_nhd: unsupported shapes q {tuple(q.shape)}, p {tuple(p.shape)}, "
            f"bias {tuple(bias_u.shape)}, {num_heads} heads"
        )
    check_cuda_operands("flash_xl_attention_nhd", q, k, v, p)
    forbid_grad("flash_xl_attention_nhd", bias_u, bias_v)
    bu = bias_u.detach().to(device=q.device, dtype=torch.float32).contiguous()
    bv = bias_v.detach().to(device=q.device, dtype=torch.float32).contiguous()
    band = _band_tensor(band_widths, num_heads, q.device)
    out = torch.empty((b, t, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bu.data_ptr(), bv.data_ptr(),
            p.data_ptr(), None if band is None else band.data_ptr(), out.data_ptr(),
            b, t, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            p.stride(0), p.stride(1), out.stride(0), out.stride(1),
            float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "flash_xl_attention_nhd")
    flash_xl_attention_nhd.launches += 1
    return out


flash_xl_attention_nhd.launches = 0
