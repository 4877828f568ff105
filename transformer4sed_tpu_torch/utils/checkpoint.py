"""Checkpointing: whole train states and warm starts (port of
``utils/checkpoint.py``).

The JAX package writes orbax directories; the port writes one
``torch.save`` file per checkpoint, at the same paths (``best/best_student``,
``best/last_state``, ...). Model weights are state dicts under the upstream
key names, so ``load_state_dict`` and upstream tools read them. A train
state (:func:`save_checkpoint`) holds what a resumed run needs: student,
teacher, the AdamW state, the LR scheduler, the applied-step count and the
gradient-accumulation buffers (a trainer's ``state_dict``). The JAX
package's write is asynchronous (orbax's ``AsyncCheckpointer``); here it
is synchronous, written to a temporary name and moved into place with
``os.replace``, so a preemption never leaves a half-written file.

:func:`load_partial` is the reference's ``strict=False`` stage hand-off:
the configs' ``warm_start_drop`` regexes name JAX paths
(``classifier``, ``at_head``, ``at_pool``, ``mlm_fc1`` ...), so each port key
is matched through its JAX-style path (:func:`utils.weights.jax_style_path`,
the inverse of the name mapping of ``load_jax_params``), and one YAML drops
the same leaves in both packages.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Sequence

import torch

from transformer4sed_tpu_torch.utils.weights import jax_style_path


def _to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _atomic_save(obj: Any, path: str) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Save a model's state dict (best-model flushes); params and buffers,
    so BatchNorm statistics travel with their weights."""
    return _atomic_save(_to_cpu(dict(state_dict)), path)


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """A state dict saved by :func:`save_params`, or an upstream ``.pt`` (a
    bare state dict, or one under ``state_dict`` / ``model``), on the CPU."""
    obj = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, Mapping) and isinstance(obj.get(key), Mapping):
            obj = obj[key]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path} holds no state dict")
    return dict(obj)


def save_checkpoint(path: str, state: Mapping[str, Any]) -> str:
    """Save a whole train state (a trainer's ``state_dict()``). An existing
    checkpoint at ``path`` is first renamed to ``path + '.prev'``, the resume
    point if this write is lost. Synchronous (the JAX package's write runs on
    a background thread)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    return _atomic_save(_to_cpu(dict(state)), path)


def restore_checkpoint(path: str, trainer) -> Any:
    """Load the train state at ``path`` into ``trainer`` (its
    ``load_state_dict``); returns the trainer."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    trainer.load_state_dict(state)
    return trainer


def load_partial(params: Mapping[str, torch.Tensor], restored: Mapping[str, torch.Tensor],
                 drop_patterns: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Warm start: ``params`` (a model's state dict) with each entry of
    ``restored`` copied in, except one missing from ``params``, one whose
    shape differs, and one whose JAX-style path matches (``re.search``) a
    regex of ``drop_patterns``. The copies keep ``params``' dtypes."""
    dropped = set(dropped_keys(params, restored, drop_patterns))
    out = dict(params)
    for name, value in restored.items():
        if (name in params and tuple(value.shape) == tuple(params[name].shape)
                and name not in dropped):
            out[name] = value.to(params[name].dtype)
    return out


def dropped_keys(params: Mapping[str, torch.Tensor], restored: Mapping[str, torch.Tensor],
                 drop_patterns: Sequence[str]) -> list:
    """The keys that :func:`load_partial` leaves out by ``drop_patterns``
    alone: present in both, of one shape, matched by a pattern."""
    compiled = [re.compile(p) for p in drop_patterns]
    return sorted(
        n for n, v in restored.items()
        if n in params and tuple(v.shape) == tuple(params[n].shape)
        and any(c.search(jax_style_path(n, v.dim())) for c in compiled))
