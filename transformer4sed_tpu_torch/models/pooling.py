"""Attention pooling (port of ``AttentionPooling`` in ``models/pooling.py``).

A learned query token cross-attends a token sequence through standard
multi-head attention with the semantics of flax
``MultiHeadDotProductAttention`` (:func:`dot_product_attention`, which
DASM's AT decoder shares): q/k/v projections in ``dtype``, the query
scaled by 1/sqrt(head_dim) before the score product, softmax, output
projection. The params keep torch ``nn.MultiheadAttention``'s
names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), which is how
upstream checkpoints store them. It is plain matmuls and a softmax.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def dot_product_attention(att: nn.MultiheadAttention, query: torch.Tensor,
                          key_value: torch.Tensor, num_heads: int, dtype,
                          blocked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention`` on ``att``'s params: query [N, L,
    D] attends key_value [N, S, D]; ``blocked`` (bool [L, S], True = blocked)
    takes the dtype's lowest value before the softmax, as flax's mask does.
    Plain matmuls and a softmax in ``dtype``."""
    n, l, d = query.shape
    s = key_value.shape[1]
    h, hd = num_heads, d // num_heads
    wq, wk, wv = att.in_proj_weight.to(dtype).chunk(3)
    bq, bk, bv = att.in_proj_bias.to(dtype).chunk(3)
    q = F.linear(query.to(dtype), wq, bq).reshape(n, l, h, hd).transpose(1, 2)
    k = F.linear(key_value.to(dtype), wk, bk).reshape(n, s, h, hd).transpose(1, 2)
    v = F.linear(key_value.to(dtype), wv, bv).reshape(n, s, h, hd).transpose(1, 2)
    q = q / torch.tensor(math.sqrt(hd), dtype=dtype)
    scores = torch.matmul(q, k.transpose(-1, -2))  # [N, H, L, S]
    if blocked is not None:
        scores = scores.masked_fill(blocked, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(n, l, d)
    return F.linear(out, att.out_proj.weight.to(dtype), att.out_proj.bias.to(dtype))


class AttentionPooling(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.f_att_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.frequency_att = nn.MultiheadAttention(dim, num_heads, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, S, D] -> [N, D]."""
        query = self.f_att_token.expand(x.shape[0], 1, x.shape[2])
        return dot_product_attention(self.frequency_att, query, x, self.num_heads,
                                     self.dtype)[:, 0, :]
