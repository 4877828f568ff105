"""Weights across the two packages, and a seeded init.

:func:`load_jax_params` fills a port :class:`PaSST_SED` from the JAX
package's param tree, given as nested dicts of arrays (numpy, or
anything ``np.asarray`` takes). It is the inverse of the JAX package's
``utils/torch_import.py:convert_passt_sed``:

  * Dense ``kernel [in, out]`` -> ``weight [out, in]``;
  * Conv ``kernel`` HWIO -> ``weight`` OIHW;
  * LayerNorm ``scale`` -> ``weight``;
  * flax MHA ``query/key/value.kernel [D, H, hd]`` -> ``in_proj_weight
    [3D, D]`` and ``out.kernel [H, hd, D]`` -> ``out_proj.weight``;
  * ``blocks_3`` -> ``blocks.3``; ``decoder_module`` -> ``decoder``;
    ``at_pool``/``at_head`` -> ``at_adpater.0``/``at_adpater.1``.

A missing or an extra key raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_TOP = {"decoder_module": "decoder", "at_pool": "at_adpater.0", "at_head": "at_adpater.1"}
_MHA_PARTS = ("query", "key", "value", "out")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _torch_name(path: Tuple[str, ...]) -> list:
    parts = []
    for i, p in enumerate(path):
        if i == 0 and p in _TOP:
            parts.append(_TOP[p])
            continue
        m = re.fullmatch(r"(blocks|encoder_blocks)_(\d+)", p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    return parts


def jax_params_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX PaSST_SED param tree -> upstream-named state dict (numpy)."""
    sd: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[Tuple[str, str], np.ndarray]] = {}
    for path, val in _flatten(params).items():
        if len(path) >= 3 and path[-3] == "frequency_att" and path[-2] in _MHA_PARTS:
            prefix = ".".join(_torch_name(path[:-2]))
            mha.setdefault(prefix, {})[(path[-2], path[-1])] = val
            continue
        parts = _torch_name(path)
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
    """Copy a JAX param tree into ``model``; raises on a missing or extra
    key and on a shape mismatch."""
    own = model.state_dict()
    sd = jax_params_to_state_dict(params)
    missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing {missing}, extra {extra}")
    model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)).to(own[k].dtype) for k, v in sd.items()}
    )
    return model


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every param from ``seed`` (same values on any device): linear
    and conv weights N(0, 1/fan_in) clipped at 2 sigma, biases N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.02), tokens and position embeddings
    N(0, 0.02), XL position biases N(0, 0.1). For tests and smoke runs
    with random weights (the JAX package's truncated-normal init is not ported)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, std):
        return torch.randn(p.shape, generator=gen) * std

    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in norms:
            val = 1.0 + normal(p, 0.02)
        elif leaf in ("weight", "in_proj_weight") and p.ndim >= 2:
            fan_in = p[0].numel()
            val = torch.clamp(normal(p, 1.0), -2.0, 2.0) / fan_in ** 0.5
        elif leaf in ("pos_bias_u", "pos_bias_v"):
            val = normal(p, 0.1)
        else:
            val = normal(p, 0.02)
        p.copy_(val.to(p.dtype))
    return model
