"""Transformer-XL context network (port of the XL parts of ``models/xl.py``).

  * ``rel_positional_encoding``: sinusoidal table over offsets
    [T-1 .. 0 .. -(T-1)] (``src/models/transformer/transformerXL.py:40-127``);
    built for ``decoder_pos_emd_len`` and sliced about its centre.
  * ``RelPositionMultiheadAttention``: (q + u)·k content plus (q + v)·P
    position scores, rel-shifted, through the fused XL kernel. Once
    ``parallel.shard_params`` has sharded it (``tp`` set), ``in_proj`` and
    ``out_proj`` hold this rank's heads, ``pos_bias_u``, ``pos_bias_v`` and
    ``linear_pos`` (replicated) are read for those heads only, and the XL
    kernels run on the local heads.
  * ``build_band_mask``: the band-diagonal local-attention mask, which the
    XL kernel's plain version uses (the kernel builds it per element).
  * ``TransformerXLBlock`` keeps the reference's residual wiring
    ``x = norm1(x); x = x + attn(x); x = x + mlp(norm2(x))``; its MLP is
    ``mlp_ratio`` times as wide as the block (``decoder_expand_rate``).

The port has one XL attention. The JAX package builds PaSST_SED's decoder
with ``use_flash`` (the fused kernel) and HTSAT_CNN's without it (the
unfused scores, ``models/htsat_heads.py:66-72``); the two compute the same
function, so both families run the fused kernels here on the card (rows 2,
12 and 13 of the kernel table) and their plain versions on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels.xl_attention import flash_xl_attention_nhd
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

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor) -> torch.Tensor:
        """x: [B, T, D] (already scaled by sqrt(D)); pos_emb: [1, 2T-1, D]."""
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
        p = p.reshape(p.shape[0], h, d // h).transpose(0, 1)  # [H, 2T-1, hd] view
        out = flash_xl_attention_nhd(
            qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
            bias_u, bias_v, p, h, (d // h) ** -0.5,
        )
        return self.out_proj(out)


class TransformerXLBlock(nn.Module):
    """XL block with the reference's residual wiring."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = RelPositionMultiheadAttention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, pos_emb):
        x = self.norm1(x)
        x = x + self.attn(x, pos_emb)
        return x + self.mlp(self.norm2(x))


class TransformerXLDecoder(nn.Module):
    """Stack of XL blocks over the frame sequence."""

    def __init__(self, dim: int, decoder_layer_num: int = 2, num_heads: int = 12,
                 seq_len: int = 1000, mlp_ratio: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.seq_len = seq_len
        self.encoder_blocks = nn.ModuleList(
            TransformerXLBlock(dim, num_heads, mlp_ratio, dtype=dtype)
            for _ in range(decoder_layer_num)
        )
        self.register_buffer(
            "pe", torch.from_numpy(rel_positional_encoding(seq_len, dim)), persistent=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        if t > self.seq_len:
            raise ValueError(f"{t} frames exceed the position table's {self.seq_len}")
        center = self.pe.shape[1] // 2
        pos_emb = self.pe[:, center - t + 1:center + t]
        x = x * math.sqrt(d)
        for blk in self.encoder_blocks:
            x = blk(x, pos_emb)
        return x
