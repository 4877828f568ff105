"""ViT building blocks (port of ``models/vit.py``).

timm-style blocks the PaSST backbone is built from: Mlp, Attention,
pre-norm Block, PatchEmbed. Attention runs the heads-in-lanes flash
kernels on the lane slices of the [B, N, 3C] qkv output, as the
reference's maskless path does (``models/vit.py:113-122``), through their
autograd Function when gradients are recorded. Dropout and DropPath are
zero in the flagship and not ported yet (ROADMAP.md, queue 1, item 1). Matmuls run
in ``dtype`` (bf16 on the flagship) with f32 params and f32 layer norms.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels.flash_attention import flash_attention_nhd
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU in f32; the tanh form when the activation is bf16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_features: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(fast_gelu(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention, no mask (the only path the slice runs)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        raw = self.qkv(x)
        out = flash_attention_nhd(raw[..., :c], raw[..., c:2 * c], raw[..., 2 * c:], self.num_heads)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm transformer block (timm Block parity; PaSST's LayerNorm eps
    1e-6, MLP ratio 4)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Overlapping conv patch embedding ([B, 1, F, T] -> [B, D, F', T']):
    16x16 patches at stride 10."""

    PATCH, STRIDE = (16, 16), (10, 10)

    def __init__(self, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, kernel_size=self.PATCH, stride=self.STRIDE)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt),
                        stride=self.proj.stride)
