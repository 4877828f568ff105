"""Dense and LayerNorm with the JAX package's precision rules.

A flax ``Dense(dtype=bf16)`` casts its input, kernel and bias to bf16
and returns bf16; with no dtype it promotes input and params (bf16 input
with f32 params -> f32). A flax ``LayerNorm`` without a dtype promotes
to the f32 of its params, so it returns f32 whatever it is given
(``docs/PRECISION.md``). Params stay f32 in both; state-dict names are
torch's (``weight``, ``bias``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (None: promote input and params)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that computes and returns float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
