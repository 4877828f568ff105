"""Weights across the two packages, and a seeded init.

:func:`load_jax_params` fills a port model (:class:`PaSST_SED`,
:class:`PaSST_CNN`, :class:`HTSAT_CNN`, :class:`DASM`, :class:`CLAP_SED`,
:class:`DASM_HTSAT`) from the JAX package's variables, given as nested
dicts of arrays (numpy, or anything ``np.asarray`` takes): a param tree,
or ``{'params': ..., 'batch_stats': ...}`` for a model with BatchNorm. It
is the inverse of the JAX package's ``utils/torch_import.py``
(``convert_passt_sed``, ``convert_passt_cnn``, ``convert_htsat_cnn``,
``convert_dasm``, ``convert_clap_sed``):

  * Dense ``kernel [in, out]`` -> ``weight [out, in]``;
  * Conv ``kernel`` HWIO -> ``weight`` OIHW;
  * LayerNorm ``scale`` -> ``weight``;
  * flax MHA ``query/key/value.kernel [D, H, hd]`` -> ``in_proj_weight
    [3D, D]`` and ``out.kernel [H, hd, D]`` -> ``out_proj.weight`` (the
    f-pool's ``frequency_att``, DASM's ``multihead_attn`` and ``self_attn``);
  * DASM and DASM_HTSAT: ``at_decoder/layers_1`` ->
    ``at_decoder.decoder.layers.1``, ``query_projector`` ->
    ``query_projector.0``, ``query_projector_1`` -> ``query_projector.1.0``,
    ``mask_embedding_layer/layers_0`` -> ``mask_embedding_layer.layers.0``,
    and its ``at_head`` MLP keeps its name; CLAP_SED's
    ``audio_projector/layers_0`` -> ``audio_projector.layers.0`` (and
    ``text_projector``), ``text_query`` as it is;
  * ``blocks_3`` -> ``blocks.3``; ``decoder_module`` -> ``decoder``;
    ``at_pool``/``at_head`` -> ``at_adpater.0``/``at_adpater.1``;
    ``mlm_fc1``/``mlm_fc2`` -> ``mlm_mlp.0``/``mlm_mlp.2``;
  * HTSAT (HTSAT_CNN, CLAP_SED, DASM_HTSAT): ``layers_1_blocks_0`` ->
    ``layers.1.blocks.0``, ``layers_1_downsample`` -> ``layers.1.downsample``,
    ``patch_embed_proj``/``patch_embed_norm`` -> ``patch_embed.proj``/
    ``patch_embed.norm``, and ``bn0``'s ``batch_stats``;
  * the CNN branch: ``cnn/conv0`` -> ``cnn.cnn.conv0``, ``cnn/norm0`` ->
    ``cnn.cnn.batchnorm0`` (or ``layernorm0``), ``cnn/act0`` ->
    ``cnn.cnn.cg0`` (or ``glu0``), whichever the model has;
  * BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and the
    ``batch_stats`` leaves ``mean``/``var`` -> ``running_mean``/
    ``running_var``;
  * LoRA factors ``lora_A [in, r]`` / ``lora_B [r, out]`` -> upstream
    loralib's ``lora_A [r, in]`` / ``lora_B [out, r]`` (``models/lora.py``),
    and a merged Dense's per-group ``lora_A_g{i}`` / ``lora_B_g{i}`` ->
    upstream ``MergedLinear``'s stacked ``lora_A`` / ``lora_B``, enabled
    groups in order. Both packages keep the factors unmerged.

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
        "mlm_fc1": "mlm_mlp.0", "mlm_fc2": "mlm_mlp.2", "query_projector": "query_projector.0"}
# the flax attention modules whose query/key/value/out Dense params become
# one torch nn.MultiheadAttention's
_MHA_MODULES = ("frequency_att", "multihead_attn", "self_attn")
_MHA_PARTS = ("query", "key", "value", "out")
_RENAMES = (
    (re.compile(r"(blocks|encoder_blocks|layers)_(\d+)"), r"\1.\2"),
    (re.compile(r"query_projector_(\d+)"), r"query_projector.\1.0"),
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


def _own_top(name: str, names: Optional[Collection[str]]) -> bool:
    """Whether the model names its module ``name`` as the JAX package does
    (DASM's ``at_head`` MLP, where PaSST_SED's ``at_head`` is upstream's
    ``at_adpater.1``)."""
    return name == "at_head" and names is not None and any(
        n.startswith("at_head.layers.") for n in names)


def _torch_name(path: Tuple[str, ...], names: Optional[Collection[str]] = None) -> list:
    """Upstream name parts of a JAX path. The CNN branch's ``norm{i}`` and
    ``act{i}`` have two upstream names each: the one found among ``names``
    (the model's state-dict keys) is taken, else the first."""
    parts = []
    in_cnn = path[0] == "cnn"
    for i, p in enumerate(path):
        if i == 0 and p in _TOP and not _own_top(p, names):
            parts.append(_TOP[p])
            continue
        if i == 1 and path[0] == "at_decoder":
            parts.append("decoder")  # upstream wraps DASM's AT layers in a TransformerDecoder
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


_TOP_INV = {v: k for k, v in _TOP.items() if k != "query_projector"}
_RENAMES_INV = (
    (re.compile(r"layers\.(\d+)\.blocks\.(\d+)"), r"layers_\1_blocks_\2"),
    (re.compile(r"layers\.(\d+)\.downsample"), r"layers_\1_downsample"),
    (re.compile(r"at_decoder\.decoder\."), r"at_decoder."),
    (re.compile(r"query_projector\.(\d+)\.0\."), r"query_projector_\1."),
    (re.compile(r"query_projector\.0\.(?=weight|bias)"), r"query_projector."),
    (re.compile(r"(blocks|encoder_blocks|layers)\.(\d+)"), r"\1_\2"),
    (re.compile(r"patch_embed\.(proj|norm)"), r"patch_embed_\1"),
)
_CNN_INV = {"batchnorm": "norm", "layernorm": "norm", "cg": "act", "glu": "act"}


def jax_style_path(name: str, ndim: int = 2) -> str:
    """The JAX package's ``/``-joined path of the port key ``name`` (the
    inverse of :func:`_torch_name`; ``ndim``, the tensor's rank, tells a
    kernel from a norm scale): ``at_adpater.1.weight`` ->
    ``at_head/kernel``, ``backbone.blocks.3.attn.qkv.bias`` ->
    ``backbone/blocks_3/attn/qkv/bias``. The configs' ``warm_start_drop``
    regexes are matched against it."""
    for torch_top, jax_top in _TOP_INV.items():
        if name.startswith(torch_top + "."):
            name = jax_top + name[len(torch_top):]
            break
    for pattern, repl in _RENAMES_INV:
        name = pattern.sub(repl, name)
    parts = name.split(".")
    if parts[0] == "cnn" and len(parts) > 2 and parts[1] == "cnn":
        m = re.fullmatch(r"(batchnorm|layernorm|cg|glu)(\d+)", parts[2])
        parts = ["cnn"] + ([f"{_CNN_INV[m.group(1)]}{m.group(2)}"] if m else [parts[2]]) + parts[3:]
    leaf = parts[-1]
    if leaf == "weight":
        parts[-1] = "kernel" if ndim >= 2 else "scale"
    elif leaf in ("running_mean", "running_var"):
        parts[-1] = leaf.split("_")[1]
    return "/".join(parts)


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
    lora_groups: Dict[str, list] = {}
    for path, val in _flatten(params).items():
        if len(path) >= 3 and path[-3] in _MHA_MODULES and path[-2] in _MHA_PARTS:
            prefix = ".".join(_torch_name(path[:-2], names))
            mha.setdefault(prefix, {})[(path[-2], path[-1])] = val
            continue
        parts = _torch_name(path, names)
        group = re.fullmatch(r"(lora_[AB])_g(\d+)", parts[-1])
        if group:  # a merged Dense's per-group factor: stacked below
            key = ".".join(parts[:-1] + [group.group(1)])
            lora_groups.setdefault(key, []).append((int(group.group(2)), val.T))
            continue
        if parts[-1] in ("lora_A", "lora_B"):
            val = val.T
        elif parts[-1] == "kernel":
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
    for key, parts in lora_groups.items():
        sd[key] = np.concatenate([v for _, v in sorted(parts, key=lambda p: p[0])])
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
