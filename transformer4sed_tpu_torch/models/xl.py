"""Transformer-XL context network (port of the XL parts of ``models/xl.py``).

  * ``rel_positional_encoding``: sinusoidal table over offsets
    [T-1 .. 0 .. -(T-1)] (``src/models/transformer/transformerXL.py:40-127``);
    built for ``decoder_pos_emd_len`` and sliced about its centre.
  * ``RelPositionMultiheadAttention``: (q + u)·k content plus (q + v)·P
    position scores, rel-shifted, through the fused XL kernel, with optional
    per-head band widths (local attention, the band built in the kernel).
    With an explicit ``mask`` (bool, True = blocked) it takes the JAX
    package's masked branch instead (``models/xl.py:200-221``): the
    rel-shifted position scores of q + v in float32, scaled, -1e30 where
    blocked, as an additive [B, H, T, T] bias to the flash attention of
    q + u, k and v (:func:`flash_attention_bias`, row 4 of the kernel table;
    its backward recomputes through the plain version, as the JAX custom VJP
    does). Once ``parallel.shard_params`` has sharded it (``tp`` set),
    ``in_proj`` and ``out_proj`` hold this rank's heads, ``pos_bias_u``,
    ``pos_bias_v`` and ``linear_pos`` (replicated) are read for those heads
    only, as are the band widths and a mask's head axis, and the kernels run
    on the local heads.
  * ``build_band_mask``: the band-diagonal local-attention mask, which the
    XL kernel's plain version uses (the kernel builds it per element).
  * ``TransformerXLBlock`` keeps the reference's residual wiring
    ``x = norm1(x); x = x + attn(x); x = x + mlp(norm2(x))``; its MLP is
    ``mlp_ratio`` times as wide as the block (``decoder_expand_rate``).
  * ``TransformerXLDecoder(window_len=...)`` turns an int or per-head window
    length into band widths for every block, as the JAX decoder does under
    ``use_flash`` (:289-296).

The port has one XL attention. The JAX package builds PaSST_SED's decoder
with ``use_flash`` (the fused kernel) and HTSAT_CNN's without it (the
unfused scores, ``models/htsat_heads.py:66-72``); the two compute the same
function, so both families run the fused kernels here on the card (rows 2,
12 and 13 of the kernel table) and their plain versions on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels.flash_attention import (
    _merge_heads,
    _split_heads,
    flash_attention_bias,
)
from transformer4sed_tpu_torch.kernels.xl_attention import (
    add_pos_bias,
    flash_xl_attention_nhd,
    rel_shift,
)
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.vit import Mlp


def diagonal_mask(seq_len: int, mask_width: int) -> np.ndarray:
    """Boolean [L, L] band mask, True = blocked: row i allows columns
    [i - w//2, i + w//2) and always i (reference ``mask.py:7-23``)."""
    i = np.arange(seq_len)[:, None]
    j = np.arange(seq_len)[None, :]
    half = mask_width // 2
    allowed = ((j >= i - half) & (j < i + half)) | (j == i)
    return ~allowed


def build_band_mask(seq_len: int, window_len) -> Optional[np.ndarray]:
    """None | int | per-head sequence -> None | [L, L] | [H, L, L] bool mask."""
    if window_len is None:
        return None
    if isinstance(window_len, int):
        return diagonal_mask(seq_len, window_len)
    return np.stack([diagonal_mask(seq_len, w) for w in window_len])


def rel_positional_encoding(seq_len: int, d_model: int) -> np.ndarray:
    """[1, 2*seq_len - 1, d] sinusoidal table for offsets [T-1 .. -(T-1)]."""
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((seq_len, d_model))
    pe_neg = np.zeros((seq_len, d_model))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return pe[None].astype(np.float32)


class RelPositionMultiheadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.in_proj = Dense(dim, 3 * dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)
        self.linear_pos = Dense(dim, dim, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, hd))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, hd))
        self.tp = None  # parallel.partition.TPShard once in_proj / out_proj are sharded

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, mask: Optional[torch.Tensor] = None,
                band_widths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """x: [B, T, D] (already scaled by sqrt(D)); pos_emb: [1, 2T-1, D];
        mask: bool [T, T] | [H, T, T] | [B, H, T, T], True = blocked (the band
        widths are then unused, as in JAX); band_widths: one per head."""
        qkv = self.in_proj(x)
        d = qkv.shape[-1] // 3  # this rank's width under tensor parallelism
        bias_u, bias_v = self.pos_bias_u, self.pos_bias_v
        if self.tp is None:
            h = self.num_heads
            p = self.linear_pos(pos_emb)[0]  # [2T-1, D]
        else:
            h = self.tp.heads
            bias_u, bias_v = self.tp.local(bias_u, 0), self.tp.local(bias_v, 0)
            lin = self.linear_pos
            dt = lin.compute_dtype or torch.promote_types(pos_emb.dtype, lin.weight.dtype)
            p = F.linear(pos_emb.to(dt), self.tp.local(lin.weight, 0, d // h).to(dt))[0]
            heads = slice(self.tp.head0, self.tp.head0 + h)
            if band_widths is not None:
                band_widths = tuple(band_widths)[heads]
            if mask is not None and mask.ndim > 2:
                mask = mask[..., heads, :, :]
        p = p.reshape(p.shape[0], h, d // h).transpose(0, 1)  # [H, 2T-1, hd] view
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        scale = (d // h) ** -0.5
        if mask is None:
            out = flash_xl_attention_nhd(q, k, v, bias_u, bias_v, p, h, scale, band_widths)
        else:
            qu, qv = add_pos_bias(q, bias_u, bias_v, h)  # [B, H, T, hd] in q's dtype
            position = rel_shift(torch.matmul(qv.float(), p.float().transpose(-1, -2)))
            bias = torch.where(torch.as_tensor(mask, device=x.device), -1e30, position * scale)
            out = _merge_heads(flash_attention_bias(qu, _split_heads(k, h), _split_heads(v, h),
                                                    bias, scale))
        return self.out_proj(out)


class TransformerXLBlock(nn.Module):
    """XL block with the reference's residual wiring."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = RelPositionMultiheadAttention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, pos_emb, mask=None, band_widths=None):
        x = self.norm1(x)
        x = x + self.attn(x, pos_emb, mask=mask, band_widths=band_widths)
        return x + self.mlp(self.norm2(x))


class TransformerXLDecoder(nn.Module):
    """Stack of XL blocks over the frame sequence; ``window_len`` (an int, or
    one per head) makes every block's attention local."""

    def __init__(self, dim: int, decoder_layer_num: int = 2, num_heads: int = 12,
                 seq_len: int = 1000, mlp_ratio: float = 1.0, window_len=None,
                 dtype=torch.float32):
        super().__init__()
        self.seq_len = seq_len
        self.band_widths = band_widths(window_len, num_heads)
        self.encoder_blocks = nn.ModuleList(
            TransformerXLBlock(dim, num_heads, mlp_ratio, dtype=dtype)
            for _ in range(decoder_layer_num)
        )
        self.register_buffer(
            "pe", torch.from_numpy(rel_positional_encoding(seq_len, dim)), persistent=False
        )

    def pos_emb(self, t: int) -> torch.Tensor:
        """[1, 2t-1, D]: the position table's rows for offsets t-1 .. -(t-1)."""
        if t > self.seq_len:
            raise ValueError(f"{t} frames exceed the position table's {self.seq_len}")
        center = self.pe.shape[1] // 2
        return self.pe[:, center - t + 1:center + t]

    def forward(self, x: torch.Tensor, upto: Optional[int] = None) -> torch.Tensor:
        """The decoded frames; ``upto`` = k stops after block k and returns its
        output (the PMAM tokenizer's ``transformer_k`` tap)."""
        if upto is not None and not 0 <= upto < len(self.encoder_blocks):
            raise ValueError(f"no decoder block {upto}: the decoder has "
                             f"{len(self.encoder_blocks)}")
        pos_emb = self.pos_emb(x.shape[1])
        x = x * math.sqrt(x.shape[-1])
        for i, blk in enumerate(self.encoder_blocks):
            x = blk(x, pos_emb, band_widths=self.band_widths)
            if i == upto:
                break
        return x


def band_widths(window_len, num_heads: int) -> Optional[Tuple[int, ...]]:
    """None | int | per-head sequence -> None | one band width per head."""
    if window_len is None:
        return None
    if isinstance(window_len, int):
        return (int(window_len),) * num_heads
    widths = tuple(int(w) for w in window_len)
    if len(widths) != num_heads:
        raise ValueError(f"{len(widths)} window lengths for {num_heads} heads")
    return widths
