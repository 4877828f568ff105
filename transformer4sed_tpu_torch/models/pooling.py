"""Attention pooling (port of ``AttentionPooling`` in ``models/pooling.py``).

A learned query token cross-attends a token sequence through standard
multi-head attention with the semantics of flax
``MultiHeadDotProductAttention``: q/k/v projections in ``dtype``, the
query scaled by 1/sqrt(head_dim) before the score product, softmax,
output projection. The params keep torch ``nn.MultiheadAttention``'s
names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), which is how
upstream checkpoints store them. It is plain matmuls and a softmax.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class AttentionPooling(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.f_att_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.frequency_att = nn.MultiheadAttention(dim, num_heads, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, S, D] -> [N, D]."""
        n, s, d = x.shape
        h, hd = self.num_heads, d // self.num_heads
        dt = self.dtype
        att = self.frequency_att
        wq, wk, wv = att.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = att.in_proj_bias.to(dt).chunk(3)
        query = self.f_att_token.expand(n, 1, d)
        q = F.linear(query.to(dt), wq, bq).reshape(n, 1, h, hd)
        k = F.linear(x.to(dt), wk, bk).reshape(n, s, h, hd)
        v = F.linear(x.to(dt), wv, bv).reshape(n, s, h, hd)
        q = q / torch.tensor(math.sqrt(hd), dtype=dt)
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k)
        attn = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, 1, d)
        out = F.linear(out, att.out_proj.weight.to(dt), att.out_proj.bias.to(dt))
        return out[:, 0, :]
