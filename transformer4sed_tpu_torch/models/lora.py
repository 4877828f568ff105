"""LoRA: low-rank adaptation as drop-in layers and state-dict transforms
(port of ``models/lora.py``).

The layers keep upstream loralib's names and layouts
(``src/models/lora/layers.py``): a Dense layer's ``weight`` [out, in] is
joined by ``lora_A`` [r, in] and ``lora_B`` [out, r], and the output is
``x W^T + b + (alpha / r) (x A^T) B^T``, so an upstream ``.pt`` loads with
``load_state_dict``. As in the JAX package there is no train/eval
merge-unmerge state machine: the low-rank path is computed on the fly, the
stored ``weight`` is the raw pretrained one (unmerged), and
:func:`merge_lora` folds the deltas into a dense state dict for export.
:func:`lora_label_fn` is the functional ``mark_only_lora_as_trainable``
(labels, not ``requires_grad`` flags) and :func:`lora_params` the
``lora_state_dict`` filter.

Initial values follow the JAX package: ``lora_A`` N(0, 0.02) and ``lora_B``
zero (the embedding's the other way round), so a fresh adapter adds nothing.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.models.layers import Dense

_LORA_LEAF = re.compile(r"lora_[AB](_g\d+)?")


def is_lora_factor(name: str) -> bool:
    """Whether the param or state-dict key ``name`` is a LoRA factor: its last
    component is ``lora_A`` or ``lora_B``, or a flax merged layer's
    ``lora_A_g{i}`` / ``lora_B_g{i}``. The one test of the port's modules,
    optimizer and scripts."""
    return _LORA_LEAF.fullmatch(name.rsplit(".", 1)[-1]) is not None


class LoRADense(Dense):
    """Dense with an additive low-rank path: y = x W^T + b + (alpha / r) x A^T B^T,
    every product in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, rank: int = 4, alpha: float = 1.0,
                 bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.rank, self.alpha = rank, alpha
        self.scale = alpha / rank
        self.lora_A = nn.Parameter(torch.randn(rank, in_features) * 0.02)
        self.lora_B = nn.Parameter(torch.zeros(out_features, rank))

    def delta_of(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(alpha / r) B A: [out, in], in f32."""
        return self.scale * (b.float() @ a.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        dt = y.dtype
        low = F.linear(F.linear(x.to(dt), self.lora_A.to(dt)), self.lora_B.to(dt))
        return y + self.scale * low


class LoRAMergedDense(Dense):
    """Fused Dense (e.g. qkv) with LoRA on a subset of its equal output groups
    (upstream ``MergedLinear``): ``enable_lora`` has one bool per group. The
    factors are upstream's stacked ones, ``lora_A`` [r * G, in] and ``lora_B``
    [out / len(enable_lora) * G, r] for G enabled groups; enabled group j's
    delta is ``lora_B[j-th slice] @ lora_A[j-th slice]`` (upstream's grouped
    conv1d)."""

    def __init__(self, in_features: int, out_features: int,
                 enable_lora: Sequence[bool] = (True, True, True), rank: int = 4,
                 alpha: float = 1.0, bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        if out_features % len(enable_lora):
            raise ValueError("out_features must split evenly over enable_lora")
        self.enable_lora = tuple(bool(e) for e in enable_lora)
        self.rank, self.alpha = rank, alpha
        self.scale = alpha / rank
        self.group_size = out_features // len(enable_lora)
        g = sum(self.enable_lora)
        self.lora_A = nn.Parameter(torch.randn(rank * g, in_features) * 0.02)
        self.lora_B = nn.Parameter(torch.zeros(self.group_size * g, rank))

    def _groups(self):
        """(output slice, A rows, B rows) of each enabled group."""
        r, gs, j = self.rank, self.group_size, 0
        for i, on in enumerate(self.enable_lora):
            if on:
                yield (slice(i * gs, (i + 1) * gs), slice(j * r, (j + 1) * r),
                       slice(j * gs, (j + 1) * gs))
                j += 1

    def delta_of(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        delta = torch.zeros(self.weight.shape, dtype=torch.float32, device=a.device)
        for out, rows_a, rows_b in self._groups():
            delta[out] = self.scale * (b[rows_b].float() @ a[rows_a].float())
        return delta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        dt = y.dtype
        groups, parts = self._groups(), []
        for on in self.enable_lora:
            if on:
                _, a, b = next(groups)
                low = F.linear(F.linear(x.to(dt), self.lora_A[a].to(dt)), self.lora_B[b].to(dt))
                parts.append(self.scale * low)
            else:
                parts.append(y.new_zeros(y.shape[:-1] + (self.group_size,)))
        return y + torch.cat(parts, dim=-1)


class LoRAEmbedding(nn.Embedding):
    """Embedding with an additive low-rank delta (upstream ``lora.Embedding``:
    ``lora_A`` [r, num] starts at zero, ``lora_B`` [dim, r] normal)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, rank: int = 4,
                 alpha: float = 1.0, dtype=None):
        super().__init__(num_embeddings, embedding_dim)
        nn.init.normal_(self.weight, std=0.02)
        self.rank, self.alpha = rank, alpha
        self.scale = alpha / rank
        self.compute_dtype = dtype
        self.lora_A = nn.Parameter(torch.zeros(rank, num_embeddings))
        self.lora_B = nn.Parameter(torch.randn(embedding_dim, rank) * 0.02)

    def delta_of(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.scale * (a.float().T @ b.float().T)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.embedding(ids, self.weight).to(dt)
        after_a = F.embedding(ids, self.lora_A.T).to(dt)
        return y + self.scale * F.linear(after_a, self.lora_B.to(dt))


class LoRAConv(nn.Conv2d):
    """2-D convolution whose kernel carries a rank-``rank`` additive delta.
    As in the JAX package (a documented deviation from upstream ``ConvLoRA``,
    which factorizes the (out, in*k*k) matricization at rank r*k), the
    flattened-HWIO kernel [kh*kw*cin, cout] is factorized at rank ``rank``:
    ``lora_A`` [r, kh*kw*cin] and ``lora_B`` [cout, r] (the JAX factors
    transposed); padding 'SAME' at stride 1 as the JAX layer's default."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3), stride=(1, 1),
                 padding="same", rank: int = 4, alpha: float = 1.0, bias: bool = True, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         bias=bias)
        self.rank, self.alpha = rank, alpha
        self.scale = alpha / rank
        self.compute_dtype = dtype
        kh, kw = self.kernel_size
        self.lora_A = nn.Parameter(torch.randn(rank, kh * kw * in_channels) * 0.02)
        self.lora_B = nn.Parameter(torch.zeros(out_channels, rank))

    def delta_of(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The delta of the OIHW ``weight``: the HWIO product reshaped and permuted."""
        kh, kw = self.kernel_size
        hwio = (a.float().T @ b.float().T).reshape(
            kh, kw, self.in_channels, self.out_channels)
        return self.scale * hwio.permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        kernel = self.weight.to(dt) + delta_weight(self).to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), kernel, bias, self.stride, self.padding)


LORA_LAYERS = (LoRADense, LoRAMergedDense, LoRAEmbedding, LoRAConv)


def delta_weight(m: nn.Module) -> torch.Tensor:
    """A LoRA layer's delta of its base ``weight``, in f32."""
    return m.delta_of(m.lora_A, m.lora_B)


def lora_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """The model's LoRA layers by name."""
    return {name: m for name, m in model.named_modules() if isinstance(m, LORA_LAYERS)}


@torch.no_grad()
def merge_lora(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every LoRA delta folded into its base
    ``weight`` and the factors removed: the dense weights of the same
    network, which a model built without LoRA loads (the reference's merged
    saves). Each layer's own alpha / r scales its delta (the JAX function
    takes that scale as an argument; a port layer knows it)."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()
          if not is_lora_factor(k)}
    for name, m in lora_modules(model).items():
        key = f"{name}.weight" if name else "weight"
        sd[key] = (m.weight.float() + delta_weight(m)).to(m.weight.dtype)
    return sd


def lora_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The LoRA factors of a state dict (``lora_state_dict``)."""
    return {k: v for k, v in state_dict.items() if is_lora_factor(k)}


def lora_label_fn(names: Iterable[str], trainable_extra: Sequence[str] = ()) -> Dict[str, str]:
    """'lora' for the LoRA factors (and names containing any of
    ``trainable_extra``), 'frozen' otherwise: the functional
    ``mark_only_lora_as_trainable``."""
    return {n: "lora" if is_lora_factor(n) or any(e in n for e in trainable_extra) else "frozen"
            for n in names}


@torch.no_grad()
def unmerge_lora_checkpoint(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """An upstream LoRA checkpoint whose weights carry the merged delta (the
    reference's published saves) made unmerged for ``model``: for each LoRA
    layer of ``model`` whose factors the checkpoint holds, (alpha / r) B A
    is subtracted from the checkpoint's weight in f32 (loralib's unmerge,
    the JAX package's ``utils/torch_import.py:_dense``), since the layer
    adds it again at run time. Other entries pass through."""
    out = dict(state_dict)
    for name, m in lora_modules(model).items():
        keys = [f"{name}.{leaf}" for leaf in ("weight", "lora_A", "lora_B")]
        if not all(k in out for k in keys):
            continue
        w, a, b = (out[k] for k in keys)
        out[keys[0]] = (w.float() - m.delta_of(a, b)).to(w.dtype)
    return out
