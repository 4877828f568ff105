"""Weights across the two packages, and a seeded init.

:func:`load_jax_params` fills a port model (:class:`PaSST_SED`,
:class:`PaSST_CNN`, :class:`HTSAT_CNN`) from the JAX package's variables, given as nested
dicts of arrays (numpy, or anything ``np.asarray`` takes): a param tree,
or ``{'params': ..., 'batch_stats': ...}`` for a model with BatchNorm. It
is the inverse of the JAX package's ``utils/torch_import.py``
(``convert_passt_sed``, ``convert_passt_cnn``, ``convert_htsat_cnn``):

  * Dense ``kernel [in, out]`` -> ``weight [out, in]``;
  * Conv ``kernel`` HWIO -> ``weight`` OIHW;
  * LayerNorm ``scale`` -> ``weight``;
  * flax MHA ``query/key/value.kernel [D, H, hd]`` -> ``in_proj_weight
    [3D, D]`` and ``out.kernel [H, hd, D]`` -> ``out_proj.weight``;
  * ``blocks_3`` -> ``blocks.3``; ``decoder_module`` -> ``decoder``;
    ``at_pool``/``at_head`` -> ``at_adpater.0``/``at_adpater.1``;
    ``mlm_fc1``/``mlm_fc2`` -> ``mlm_mlp.0``/``mlm_mlp.2``;
  * HTSAT: ``layers_1_blocks_0`` -> ``layers.1.blocks.0``,
    ``layers_1_downsample`` -> ``layers.1.downsample``,
    ``patch_embed_proj``/``patch_embed_norm`` -> ``patch_embed.proj``/
    ``patch_embed.norm``;
  * the CNN branch: ``cnn/conv0`` -> ``cnn.cnn.conv0``, ``cnn/norm0`` ->
    ``cnn.cnn.batchnorm0`` (or ``layernorm0``), ``cnn/act0`` ->
    ``cnn.cnn.cg0`` (or ``glu0``), whichever the model has;
  * BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and the
    ``batch_stats`` leaves ``mean``/``var`` -> ``running_mean``/
    ``running_var``.

A missing or an extra key raises. Buffers that are counters or are
computed from the configuration (``num_batches_tracked``,
``relative_position_index``, ``attn_mask``) keep the model's own values.
"""

from __future__ import annotations

import re
from typing import Collection, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from transformer4sed_tpu_torch.models.norm import RefBatchNorm

_TOP = {"decoder_module": "decoder", "at_pool": "at_adpater.0", "at_head": "at_adpater.1",
        "mlm_fc1": "mlm_mlp.0", "mlm_fc2": "mlm_mlp.2"}
_MHA_PARTS = ("query", "key", "value", "out")
_RENAMES = (
    (re.compile(r"(blocks|encoder_blocks)_(\d+)"), r"\1.\2"),
    (re.compile(r"layers_(\d+)_blocks_(\d+)"), r"layers.\1.blocks.\2"),
    (re.compile(r"layers_(\d+)_downsample"), r"layers.\1.downsample"),
    (re.compile(r"patch_embed_(proj|norm)"), r"patch_embed.\1"),
)
# upstream names of the CNN branch's per-layer modules, by the flax stem
_CNN_STEMS = {"norm": ("batchnorm", "layernorm"), "act": ("cg", "glu")}
_STATS = {"mean": "running_mean", "var": "running_var"}
# buffers with no counterpart in a JAX tree: counters and constants of the configuration
_DERIVED = ("num_batches_tracked", "relative_position_index", "attn_mask")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _torch_name(path: Tuple[str, ...], names: Optional[Collection[str]] = None) -> list:
    """Upstream name parts of a JAX path. The CNN branch's ``norm{i}`` and
    ``act{i}`` have two upstream names each: the one found among ``names``
    (the model's state-dict keys) is taken, else the first."""
    parts = []
    in_cnn = path[0] == "cnn"
    for i, p in enumerate(path):
        if i == 0 and p in _TOP:
            parts.append(_TOP[p])
            continue
        if in_cnn and i == 1:
            parts.append("cnn")  # upstream wraps the layers in a Sequential named cnn
            m = re.fullmatch(r"(norm|act)(\d+)", p)
            if m:
                stems = _CNN_STEMS[m.group(1)]
                prefix = ".".join(parts)
                found = [st for st in stems if names is not None and any(
                    n.startswith(f"{prefix}.{st}{m.group(2)}.") for n in names)]
                p = f"{(found or stems)[0]}{m.group(2)}"
        for pattern, repl in _RENAMES:
            if pattern.fullmatch(p):
                p = pattern.sub(repl, p)
                break
        parts.append(p)
    return parts


def _split_variables(tree: Mapping) -> Tuple[Mapping, Mapping]:
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        return tree["params"], tree.get("batch_stats") or {}
    return tree, {}


def jax_params_to_state_dict(variables: Mapping,
                             names: Optional[Collection[str]] = None) -> Dict[str, np.ndarray]:
    """JAX variables (a param tree, or ``{'params', 'batch_stats'}``) ->
    upstream-named state dict (numpy). ``names``: see :func:`_torch_name`."""
    params, batch_stats = _split_variables(variables)
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(batch_stats).items():
        if path[-1] not in _STATS:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[".".join(_torch_name(path[:-1], names) + [_STATS[path[-1]]])] = val
    mha: Dict[str, Dict[Tuple[str, str], np.ndarray]] = {}
    for path, val in _flatten(params).items():
        if len(path) >= 3 and path[-3] == "frequency_att" and path[-2] in _MHA_PARTS:
            prefix = ".".join(_torch_name(path[:-2]))
            mha.setdefault(prefix, {})[(path[-2], path[-1])] = val
            continue
        parts = _torch_name(path, names)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if val.ndim == 2:
                val = val.T
            elif val.ndim == 4:
                val = np.transpose(val, (3, 2, 0, 1))
            else:
                raise ValueError(f"unexpected {val.ndim}-d kernel at {'/'.join(path)}")
        elif parts[-1] == "scale":
            parts[-1] = "weight"
        sd[".".join(parts)] = val
    for prefix, m in mha.items():
        expected = {(p, leaf) for p in _MHA_PARTS for leaf in ("kernel", "bias")}
        if set(m) != expected:
            raise KeyError(f"{prefix}: attention params {sorted(m)} are not {sorted(expected)}")
        d = m[("query", "kernel")].shape[0]
        sd[f"{prefix}.in_proj_weight"] = np.concatenate(
            [m[(p, "kernel")].reshape(d, d).T for p in _MHA_PARTS[:3]])
        sd[f"{prefix}.in_proj_bias"] = np.concatenate(
            [m[(p, "bias")].reshape(d) for p in _MHA_PARTS[:3]])
        sd[f"{prefix}.out_proj.weight"] = m[("out", "kernel")].reshape(d, d).T
        sd[f"{prefix}.out_proj.bias"] = m[("out", "bias")]
    return sd


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy JAX variables (a param tree, or ``{'params', 'batch_stats'}``)
    into ``model``; raises on a missing or extra key and on a shape
    mismatch."""
    own = model.state_dict()
    sd = jax_params_to_state_dict(params, names=own.keys())
    derived = {k: v for k, v in own.items() if k.rsplit(".", 1)[-1] in _DERIVED}
    missing = sorted(set(own) - set(sd) - set(derived))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing {missing}, extra {extra}")
    loaded = {k: torch.from_numpy(np.ascontiguousarray(v)).to(own[k].dtype)
              for k, v in sd.items()}
    model.load_state_dict({**derived, **loaded})
    return model


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every param from ``seed`` (same values on any device): linear
    and conv weights N(0, 1/fan_in) clipped at 2 sigma, biases N(0, 0.02),
    norm scales (LayerNorm, BatchNorm, GroupNorm) 1 + N(0, 0.02), tokens,
    position embeddings and relative-position bias tables N(0, 0.02), XL
    position biases N(0, 0.1), ``merge_weight`` 0.5 + N(0, 0.02); then the
    BatchNorm running means N(0, 0.1) and variances 1 + U(0, 0.2). For
    tests and smoke runs with random weights (the JAX package's
    truncated-normal init is not ported)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, std):
        return torch.randn(p.shape, generator=gen) * std

    norm_types = (nn.LayerNorm, nn.GroupNorm, RefBatchNorm)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, norm_types)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in norms:
            val = 1.0 + normal(p, 0.02)
        elif leaf in ("weight", "in_proj_weight") and p.ndim >= 2:
            fan_in = p[0].numel()
            val = torch.clamp(normal(p, 1.0), -2.0, 2.0) / fan_in ** 0.5
        elif leaf in ("pos_bias_u", "pos_bias_v"):
            val = normal(p, 0.1)
        elif leaf == "merge_weight":
            val = 0.5 + normal(p, 0.02)
        else:
            val = normal(p, 0.02)
        p.copy_(val.to(p.dtype))
    for m in model.modules():
        if isinstance(m, RefBatchNorm):
            m.running_mean.copy_(normal(m.running_mean, 0.1))
            m.running_var.copy_(1.0 + 0.2 * torch.rand(m.running_var.shape, generator=gen))
    return model
