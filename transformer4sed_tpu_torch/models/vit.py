"""ViT building blocks (port of ``models/vit.py``).

timm-style blocks the PaSST backbone is built from: Mlp, Attention,
pre-norm Block, PatchEmbed. Attention runs the heads-in-lanes flash
kernels on the lane slices of the [B, N, 3C] qkv output, as the
reference's maskless path does (``models/vit.py:113-122``), through their
autograd Function when gradients are recorded. Once ``parallel.shard_params``
has sharded a block (``tp`` set), its attention runs this rank's heads,
strided [B, H/tp, N, d] views of the local qkv, through
``parallel.tp_flash_attention`` (the head-major kernels). Dropout (after fc1, fc2 and
the attention projection) and DropPath (on both residual branches) are zero
in every shipped model; in training a non-zero rate draws its scaled keep
mask from the ``torch.Generator`` passed to ``forward`` (:func:`dropout`: a
draw step, ``models/cnn.py:draw_dropout``, and an apply step,
:func:`apply_dropout`); in a data-parallel step, for the global batch, of
which ``rows`` are this rank's. Matmuls run in ``dtype`` (bf16 on the flagship) with
f32 params and f32 layer norms. With ``lora_rank`` > 0 (PMAM's post-pretraining,
``src/models/passt/passt_lora.py``) ``qkv``, ``proj``, ``fc1`` and ``fc2`` are
``models/lora.py:LoRADense`` layers under the same names: the low-rank delta
adds to the full [B, N, 3C] qkv output before it is sliced into the
heads-in-lanes q, k and v, so the kernels' inputs keep their layout.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from typing import Optional

from transformer4sed_tpu_torch.kernels.flash_attention import (
    _merge_heads,
    _split_heads,
    flash_attention_nhd,
)
from transformer4sed_tpu_torch.models.cnn import BatchRows, device_generator, draw_dropout
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.lora import LoRADense


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU in f32; the tanh form when the activation is bf16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def apply_dropout(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x`` times a scaled keep mask (1 / keep where kept, 0 where dropped);
    a mask of shape [B, 1, ...] drops whole samples (DropPath)."""
    return x * mask.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator],
            per_sample: bool = False, rows: Optional[BatchRows] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` (or, ``per_sample``, the reference's DropPath) in
    training; the identity in eval or at rate 0. With ``rows`` (a
    data-parallel step), ``x`` holds this rank's rows of the global batch and
    the mask is drawn for the global batch (:func:`models.cnn.draw_dropout`)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    shape = (x.shape[0],) + (1,) * (x.dim() - 1) if per_sample else x.shape
    gen = device_generator(generator, x.device)
    return apply_dropout(x, draw_dropout(gen, shape, rate, x.device, rows))


def dense(in_features: int, out_features: int, dtype, lora_rank: int = 0,
          lora_alpha: float = 1.0) -> Dense:
    """A Dense layer, or a LoRA one under the same name when ``lora_rank`` > 0."""
    if lora_rank > 0:
        return LoRADense(in_features, out_features, rank=lora_rank, alpha=lora_alpha,
                         dtype=dtype)
    return Dense(in_features, out_features, dtype=dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_features: int, drop: float = 0.0, dtype=torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.drop = drop
        self.fc1 = dense(dim, hidden_features, dtype, lora_rank, lora_alpha)
        self.fc2 = dense(hidden_features, dim, dtype, lora_rank, lora_alpha)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[BatchRows] = None) -> torch.Tensor:
        x = dropout(fast_gelu(self.fc1(x)), self.drop, train, generator, rows=rows)
        return dropout(self.fc2(x), self.drop, train, generator, rows=rows)


class Attention(nn.Module):
    """Multi-head self-attention, no mask (the only path the slice runs)."""

    def __init__(self, dim: int, num_heads: int, proj_drop: float = 0.0, dtype=torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.num_heads = num_heads
        self.proj_drop = proj_drop
        self.qkv = dense(dim, 3 * dim, dtype, lora_rank, lora_alpha)
        self.proj = dense(dim, dim, dtype, lora_rank, lora_alpha)
        self.tp = None  # parallel.partition.TPShard once the block is sharded

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[BatchRows] = None) -> torch.Tensor:
        raw = self.qkv(x)
        c = raw.shape[-1] // 3  # this rank's width under tensor parallelism
        q, k, v = raw[..., :c], raw[..., c:2 * c], raw[..., 2 * c:]
        if self.tp is None:
            out = flash_attention_nhd(q, k, v, self.num_heads)
        else:
            from transformer4sed_tpu_torch.parallel.partition import tp_flash_attention

            h = self.tp.heads
            out = _merge_heads(tp_flash_attention(*(_split_heads(t, h) for t in (q, k, v)),
                                                  self.tp.mesh))
        return dropout(self.proj(out), self.proj_drop, train, generator, rows=rows)


class Block(nn.Module):
    """Pre-norm transformer block (timm Block parity; PaSST's LayerNorm eps
    1e-6, MLP ratio 4)."""

    def __init__(self, dim: int, num_heads: int, drop: float = 0.0, drop_path: float = 0.0,
                 dtype=torch.float32, lora_rank: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.drop_path = drop_path
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, proj_drop=drop, dtype=dtype, **lora)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, drop=drop, dtype=dtype, **lora)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[BatchRows] = None) -> torch.Tensor:
        h = self.attn(self.norm1(x), train, generator, rows)
        x = x + dropout(h, self.drop_path, train, generator, per_sample=True, rows=rows)
        h = self.mlp(self.norm2(x), train, generator, rows)
        return x + dropout(h, self.drop_path, train, generator, per_sample=True, rows=rows)


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
