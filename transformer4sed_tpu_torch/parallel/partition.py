"""Tensor-parallel partitioning over the ``model`` axis (port of
``parallel/partition.py``).

The JAX package maps flax param paths to ``PartitionSpec``s and lets GSPMD
place the collectives with global semantics. The port computes locally, so
:func:`shard_params` replaces each matched ``Linear`` with one that holds
only this rank's shard, Megatron style:

  * column parallel (qkv / in_proj / fc1): the output features are split, the
    input passes through :func:`copy_to_group` (its gradient is summed over
    the ``model`` group), no collective on the forward;
  * row parallel (proj / out_proj / fc2): the input features are split, the
    partial products are summed over the ``model`` group (in float32) and the
    bias, replicated, is added once after the sum.

A packed qkv projection is split by heads, not by contiguous columns: each
rank holds the q, k and v rows of its own heads, in [q | k | v] order, so the
attention modules slice their local qkv as before. (JAX's ``P(None,
'model')`` on ``qkv/kernel`` is right only because GSPMD reshards.) A block
whose heads (or features) do not divide over the axis stays replicated, as
JAX's ``shard_params`` replicates a leaf that does not divide.

Attention is parallel over heads with no collective: a sharded attention
module runs its local heads through :func:`tp_flash_attention` (ViT), the
window kernels (Swin) or the XL kernels (the decoder), and reads only its
heads' slice of the replicated per-head parameters through
:func:`copy_to_group`.

:data:`TP_RULES` are JAX's rules on the port's (upstream cai525) state-dict
names. The XL and Conformer attention rules are anchored on the block's
``attn`` module: torch's ``nn.MultiheadAttention`` in the AT adapter and the
f-pool names its projections ``in_proj_weight`` / ``out_proj`` too, and JAX
shards neither (their flax names are ``query``/``key``/``value``/``out``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.kernels.flash_attention import flash_attention
from transformer4sed_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group
from transformer4sed_tpu_torch.parallel.mesh import Mesh

COLUMN, ROW = "column", "row"

# (state-dict name regex, spec) — first match wins; the port's counterpart of
# JAX's flax-path rules (P(None, 'model') on a kernel or P('model') on its bias
# is COLUMN, P('model', None) is ROW)
TP_RULES: Tuple[Tuple[str, str], ...] = (
    # ViT / PaSST / Swin blocks
    (r".*\.attn\.qkv\.weight$", COLUMN),
    (r".*\.attn\.qkv\.bias$", COLUMN),
    (r".*\.attn\.proj\.weight$", ROW),
    (r".*\.mlp\.fc1\.weight$", COLUMN),
    (r".*\.mlp\.fc1\.bias$", COLUMN),
    (r".*\.mlp\.fc2\.weight$", ROW),
    # TransformerXL / Conformer attention
    (r".*\.attn\.in_proj\.weight$", COLUMN),
    (r".*\.attn\.in_proj\.bias$", COLUMN),
    (r".*\.attn\.out_proj\.weight$", ROW),
    # Conformer macaron FFNs
    (r".*\.(feed_forward|feed_forward_macaron)_1\.weight$", COLUMN),
    (r".*\.(feed_forward|feed_forward_macaron)_1\.bias$", COLUMN),
    (r".*\.(feed_forward|feed_forward_macaron)_2\.weight$", ROW),
)

# the Linear children that are packed [q | k | v] projections, split by heads
_PACKED = ("qkv", "in_proj")


def partition_specs(model: nn.Module,
                    rules: Sequence[Tuple[str, str]] = TP_RULES) -> Dict[str, Optional[str]]:
    """Param name -> COLUMN, ROW or None (replicated), by the first matching
    rule."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    specs = {}
    for name, _ in model.named_parameters():
        specs[name] = next((spec for pat, spec in compiled if pat.match(name)), None)
    return specs


class TPShard:
    """What a sharded attention module needs: the mesh, and its heads
    [head0, head0 + heads) of ``total_heads``."""

    def __init__(self, mesh: Mesh, total_heads: int):
        self.mesh = mesh
        self.heads = total_heads // mesh.model
        self.head0 = mesh.model_index * self.heads

    def local(self, x: torch.Tensor, dim: int, per_head: int = 1) -> torch.Tensor:
        """This rank's heads' slice along ``dim`` of a replicated tensor (each
        head ``per_head`` wide), with its gradient summed over the group."""
        x = copy_to_group(x, self.mesh.model_group)
        return x.narrow(dim, self.head0 * per_head, self.heads * per_head)


def _column_index(out_features: int, mesh: Mesh, packed_heads: Optional[int]) -> torch.Tensor:
    """Output-feature rows of this rank: its heads' q, k and v rows for a
    packed projection, else a contiguous block."""
    r, tp = mesh.model_index, mesh.model
    if packed_heads is None:
        share = out_features // tp
        return torch.arange(r * share, (r + 1) * share)
    c = out_features // 3
    width = c // tp
    return torch.cat([torch.arange(p * c + r * width, p * c + (r + 1) * width) for p in range(3)])


class ColumnParallelDense(nn.Module):
    """A ``Dense`` holding output-feature rows ``index`` of its weight and
    bias; computes like ``Dense`` (``compute_dtype``, or promotion)."""

    spec, sharded = COLUMN, ("weight", "bias")

    def __init__(self, dense: nn.Linear, mesh: Mesh, index: torch.Tensor):
        super().__init__()
        self.mesh = mesh
        self.compute_dtype = getattr(dense, "compute_dtype", None)
        self.full_shape = tuple(dense.weight.shape)
        self.register_buffer("index", index.to(dense.weight.device), persistent=False)
        self.weight = nn.Parameter(dense.weight.detach()[self.index].clone())
        self.bias = (None if dense.bias is None
                     else nn.Parameter(dense.bias.detach()[self.index].clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.mesh.model_group)
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class RowParallelDense(nn.Module):
    """A ``Dense`` holding input-feature columns ``index`` of its weight;
    the partial products are summed over the ``model`` group in float32, then
    the replicated bias is added once and the result cast to the compute
    dtype."""

    spec, sharded = ROW, ("weight",)

    def __init__(self, dense: nn.Linear, mesh: Mesh, index: torch.Tensor):
        super().__init__()
        self.mesh = mesh
        self.compute_dtype = getattr(dense, "compute_dtype", None)
        self.full_shape = tuple(dense.weight.shape)
        self.register_buffer("index", index.to(dense.weight.device), persistent=False)
        self.weight = nn.Parameter(dense.weight.detach()[:, self.index].clone())
        self.bias = None if dense.bias is None else nn.Parameter(dense.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)).float(),
                              self.mesh.model_group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dt)


def _parent(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def shard_params(model: nn.Module, mesh: Mesh,
                 rules: Sequence[Tuple[str, str]] = TP_RULES) -> nn.Module:
    """Replace every ``Linear`` whose weight a rule matches with its column-
    or row-parallel shard for this rank, in place; returns ``model``. The
    whole model must hold the same (seeded or loaded) values on every rank.
    Blocks whose heads or features do not divide over the ``model`` axis
    stay replicated. Build the optimizer (the trainer) after this."""
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    specs = partition_specs(model, rules)
    plans: Dict[int, Tuple[nn.Module, list]] = {}
    for name, spec in specs.items():
        if spec is None or not name.endswith(".weight"):
            continue
        parent, leaf = _parent(model, name[:-len(".weight")])
        plans.setdefault(id(parent), (parent, []))[1].append((leaf, spec))
    tp = mesh.model
    for parent, children in plans.values():
        heads = getattr(parent, "num_heads", None)
        ok = True
        for leaf, spec in children:
            lin = getattr(parent, leaf)
            if hasattr(lin, "lora_A"):  # its factors would be dropped, not sharded
                raise ValueError(f"shard_params does not shard a LoRA layer ({leaf})")
            width = lin.weight.shape[0] if spec == COLUMN else lin.weight.shape[1]
            packed = leaf in _PACKED
            if packed and (heads is None or heads % tp):
                ok = False
            if width % (3 * tp if packed else tp):
                ok = False
        if not ok:
            continue
        for leaf, spec in children:
            lin = getattr(parent, leaf)
            if spec == COLUMN:
                index = _column_index(lin.weight.shape[0], mesh,
                                      heads if leaf in _PACKED else None)
                setattr(parent, leaf, ColumnParallelDense(lin, mesh, index))
            else:
                share = lin.weight.shape[1] // tp
                index = torch.arange(mesh.model_index * share, (mesh.model_index + 1) * share)
                setattr(parent, leaf, RowParallelDense(lin, mesh, index))
        if heads is not None and hasattr(parent, "tp"):
            parent.tp = TPShard(mesh, heads)
    return model


def sharded_params(model: nn.Module) -> Dict[str, Tuple[nn.Module, torch.Tensor]]:
    """State-dict name -> (parallel module, param) of every param that holds
    a shard (a row-parallel bias is replicated)."""
    out = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, (ColumnParallelDense, RowParallelDense)):
            for leaf in mod.sharded:
                p = getattr(mod, leaf)
                if p is not None:
                    out[f"{mod_name}.{leaf}" if mod_name else leaf] = (mod, p)
    return out


def sharded_param_ids(model: nn.Module) -> frozenset:
    """``id`` of every param of ``model`` that holds a shard (empty before
    :func:`shard_params`)."""
    return frozenset(id(p) for _, p in sharded_params(model).values())


def gather_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The unsharded ``state_dict`` of a model after :func:`shard_params`:
    every shard all-gathered over the ``model`` group and put back at its
    rows (column) or columns (row). Same keys and shapes as before sharding,
    on every rank of the group."""
    out = {}
    shards = sharded_params(model)
    for key, val in model.state_dict().items():
        if key not in shards:
            out[key] = val.detach().clone()
            continue
        mod, p = shards[key]
        parts = [torch.empty_like(p) for _ in range(mesh.model)]
        dist.all_gather(parts, p.detach().contiguous(), group=mesh.model_group)
        idx = [torch.empty_like(mod.index) for _ in range(mesh.model)]
        dist.all_gather(idx, mod.index.contiguous(), group=mesh.model_group)
        if mod.spec == COLUMN:
            full = p.new_empty((mod.full_shape[0],) + tuple(p.shape[1:]))
            for part, ix in zip(parts, idx):
                full[ix] = part
        else:
            full = p.new_empty(mod.full_shape)
            for part, ix in zip(parts, idx):
                full[:, ix] = part
        out[key] = full
    return out


def tp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on this rank's heads of a ``model``-sharded head axis:
    q/k/v [B, H/tp, T, d] (any strides) -> [B, H/tp, T, d]. Attention is
    parallel over heads, so no collective is needed; the head-major kernels
    (``kernels/flash_attention.py``: forward, LSE forward and backward) run
    on the local heads."""
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    return flash_attention(q, k, v, sm_scale)
