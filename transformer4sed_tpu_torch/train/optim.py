"""Optimizer construction: per-module param groups (port of ``train/optim.py``).

The reference recipes' optimisation policy
(``recipes/desed/finetune/passt/setting.py:28-103`` and
``recipes/desed/setting.py:254-278``), as the JAX package labels it, on
torch ``state_dict`` names:

  * 'encoder' (backbone) with optional step-LR: the top-N blocks and the
    final backbone norm train at 2x the encoder LR;
  * 'decoder' (decoder / f-pool / projector modules);
  * 'cnn' (the CNN branch, when the config gives it its own group;
    otherwise it falls to 'head');
  * 'head' (everything else);
  * lr <= 0 or freeze_layer -> 'frozen': left out of the optimizer.

Each live group is ``torch.optim.AdamW`` (betas (0.9, 0.999), eps 1e-8) at
its own base LR, all scaled by one ``LambdaLR`` schedule. Global-norm
clipping (:func:`clip_by_global_norm`) runs before the step over the live
params only, and with optax's arithmetic. Under the parallel layouts the
global norm is taken after the ``data`` average: the squares of sharded
gradients are summed over the ``model`` group, replicated ones count once.
AdamW and the EMA then work on each rank's shards as they are. The hierarchical HTSAT backbone
names its blocks ``layers.{i}.blocks.{j}`` (``layers_{i}_blocks_{j}`` in
the JAX package): ``freeze_layer`` and ``step_lr`` count them in depth
order over the whole network.

Gradient accumulation (``training.accum_steps``, :class:`GradientAccumulator`)
works as ``optax.MultiSteps`` does in the JAX package: the k micro-batch
gradients are averaged as a running mean, and every k-th call applies them;
clipping runs on the averaged gradient inside that update, and the schedule
(and, in the trainers, the EMA and the step counter) advance only then
(:func:`apply_gradients`). With ``lora_trainable`` (PMAM's post-pretraining,
``opt.lora_trainable``; upstream's ``mark_only_lora_as_trainable``) the LoRA
factors take the decoder group wherever they sit, so they train inside a
backbone that the encoder's lr 0 freezes, as the JAX package labels them.
The AudioSet policies' own groups, when the config gives them: 'at_decoder'
(DASM's AT decoder, labelled before the generic 'decoder' keyword, which its
name also holds) and 'query' (DASM's learnable ``at_query`` bank); without
them those params fall to 'decoder' and 'head' as in the JAX package.
``child_tuning``, which no recipe or config calls, is not ported yet
(ROADMAP.md, queue 1, item 13).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Collection, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from transformer4sed_tpu_torch.models.lora import is_lora_factor


@dataclass(frozen=True)
class GroupSpec:
    lr: float = 1e-4
    weight_decay: float = 1e-8
    step_lr: int = 0  # encoder only: top-N blocks at 2x lr
    freeze_layer: int = 0  # encoder only: freeze blocks [0, k)


@dataclass(frozen=True)
class ParamGroupConfig:
    encoder: GroupSpec = field(default_factory=GroupSpec)
    decoder: GroupSpec = field(default_factory=GroupSpec)
    head: GroupSpec = field(default_factory=GroupSpec)
    # a separate LR for the CNN branch (the AudioSet recipes' policy); None
    # folds it into decoder / head as before
    cnn: Optional[GroupSpec] = None
    # DASM's AT decoder and learnable query bank (the AudioSet policies' groups)
    at_decoder: Optional[GroupSpec] = None
    query: Optional[GroupSpec] = None
    backbone_depth: int = 12
    clip_grad: float = 20.0
    # PMAM/LoRA mode: the LoRA factors train at the decoder group's rate
    lora_trainable: bool = False


# union of the reference's decoder-group keyword lists (DESED cnn_trans
# `cnn_trans/setting.py:21`, AudioSet DASM `lr_set.py:41-51`)
_DECODER_KEYWORDS = (
    "decoder", "f_pool_module", "transformer_projector", "cnn_projector",
    "at_projector", "merge_weight", "norm_before_pool", "norm_after_merge",
)


def _in_backbone(name: str) -> bool:
    return name.startswith("backbone.") or ".backbone." in name


def _backbone_block_key(name: str):
    """(layer, block) sort key of a backbone param name, or None: flat ViT
    blocks ``blocks.{i}``, hierarchical ``layers.{i}.blocks.{j}``."""
    m = re.search(r"(?:layers[._](\d+)[._])?blocks[._](\d+)", name)
    if m is None:
        return None
    return (int(m.group(1)) if m.group(1) is not None else -1, int(m.group(2)))


def label_params(names: Iterable[str], cfg: ParamGroupConfig) -> Dict[str, str]:
    """Group label of each param name, following the reference policy."""
    names = list(names)
    block_keys = sorted({k for n in names if _in_backbone(n)
                         for k in [_backbone_block_key(n)] if k is not None})
    global_block_idx = {k: i for i, k in enumerate(block_keys)}

    def label_of(name: str) -> str:
        if cfg.lora_trainable and is_lora_factor(name):
            return "decoder"
        if _in_backbone(name):
            bk = _backbone_block_key(name)
            block_idx = global_block_idx[bk] if bk is not None else None
            is_final_norm = re.search(r"backbone\.norm\.", name) is not None
            if cfg.encoder.lr <= 0:
                return "frozen"
            if cfg.encoder.freeze_layer > 0:
                trainable = ((block_idx is not None and block_idx + 1 > cfg.encoder.freeze_layer)
                             or is_final_norm)
                if not trainable:
                    return "frozen"
            if cfg.encoder.step_lr:
                depth = len(global_block_idx) or cfg.backbone_depth
                high = (block_idx is not None
                        and depth - block_idx <= cfg.encoder.step_lr) or is_final_norm
                return "encoder_high" if high else "encoder_low"
            return "encoder_low"
        # at_decoder before the generic 'decoder' keyword, which its name holds
        if cfg.at_decoder is not None and "at_decoder" in name:
            return "frozen" if cfg.at_decoder.lr <= 0 else "at_decoder"
        if cfg.query is not None and "at_query" in name:
            return "frozen" if cfg.query.lr <= 0 else "query"
        if cfg.cnn is not None and (name.startswith("cnn.") or ".cnn." in name):
            return "frozen" if cfg.cnn.lr <= 0 else "cnn"
        for kw in _DECODER_KEYWORDS:
            if kw in name:
                return "frozen" if cfg.decoder.lr <= 0 else "decoder"
        return "frozen" if cfg.head.lr <= 0 else "head"

    return {n: label_of(n) for n in names}


def _group_specs(cfg: ParamGroupConfig) -> Dict[str, Tuple[float, float]]:
    specs = {
        "encoder_low": (cfg.encoder.lr, cfg.encoder.weight_decay),
        "encoder_high": (cfg.encoder.lr * 2, cfg.encoder.weight_decay),
        "decoder": (cfg.decoder.lr, cfg.decoder.weight_decay),
        "head": (cfg.head.lr, cfg.head.weight_decay),
    }
    for label in ("cnn", "at_decoder", "query"):
        spec = getattr(cfg, label)
        if spec is not None:
            specs[label] = (spec.lr, spec.weight_decay)
    return specs


def build_optimizer(model: nn.Module, cfg: ParamGroupConfig,
                    schedule: Optional[Callable[[int], float]] = None):
    """(AdamW, LambdaLR, labels): one param group per live label, 'frozen'
    params left out. ``schedule`` maps the 0-based step to an LR scale
    (None: constant 1); the scheduler is stepped once per optimizer step."""
    named = dict(model.named_parameters())
    labels = label_params(named, cfg)
    groups = []
    for label, (lr, wd) in _group_specs(cfg).items():
        params = [p for n, p in named.items() if labels[n] == label]
        if params:
            groups.append({"params": params, "lr": lr, "weight_decay": wd, "label": label})
    opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule or (lambda step: 1.0))
    return opt, sched, labels


def live_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


@torch.no_grad()
def tensor_norm(tensors: Iterable[torch.Tensor], mesh=None,
                sharded: Collection[int] = frozenset()) -> torch.Tensor:
    """sqrt of the sum of squares of ``tensors``; under a mesh the squares of
    those whose ``id`` is in ``sharded`` (this rank's shards) are summed over
    the ``model`` group and the others (replicated) count once."""
    tensors = list(tensors)
    if mesh is None:
        sq = [t.float().square().sum() for t in tensors]
        return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())
    zero = torch.zeros((), device=mesh.device)
    part = {True: [zero], False: [zero]}
    for t, key in zip(tensors, (id(t) in sharded for t in tensors)):
        part[key].append(t.float().square().sum())
    local = torch.stack(part[True]).sum().reshape(1)
    dist.all_reduce(local, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return (local[0] + torch.stack(part[False]).sum()).sqrt()


@torch.no_grad()
def global_norm(params: Iterable[torch.Tensor], mesh=None,
                sharded: Collection[int] = frozenset()) -> torch.Tensor:
    """sqrt of the sum of squares of the params' gradients (None counts as
    0); ``mesh`` and ``sharded`` (ids of the params that hold a shard): see
    :func:`tensor_norm`."""
    grads, ids = [], set()
    for p in params:
        if p.grad is not None:
            grads.append(p.grad)
            if id(p) in sharded:
                ids.add(id(p.grad))
    return tensor_norm(grads, mesh, ids)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float, mesh=None,
                        sharded: Collection[int] = frozenset()) -> torch.Tensor:
    """optax ``clip_by_global_norm``: when the global norm g reaches
    ``max_norm``, every gradient becomes (grad / g) * max_norm, with no
    epsilon (``torch.nn.utils.clip_grad_norm_`` divides by g + 1e-6).
    Returns g."""
    params = [p for p in params if p.grad is not None]
    norm = global_norm(params, mesh, sharded)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        p.grad.mul_(scale.to(p.grad.dtype))
    return norm


class GradientAccumulator:
    """``optax.MultiSteps(every_k_schedule=k)`` on ``.grad``: :meth:`add`
    folds the params' gradients into a running mean (``acc + (g - acc) /
    (n + 1)``, optax's arithmetic) and, on the k-th call, puts the mean in
    their ``.grad`` and returns True."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"accum_steps must be at least 1, got {k}")
        self.k = k
        self.mini_step = 0
        self.acc: List[torch.Tensor] = []

    @torch.no_grad()
    def add(self, params: List[torch.Tensor]) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if not self.acc:
            self.acc = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g.float() - a) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step:
            return False
        for p, a in zip(params, self.acc):
            p.grad = a.to(p.dtype)
        self.acc = []
        return True

    def state_dict(self) -> Dict:
        return {"k": self.k, "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: Dict) -> None:
        if int(state["k"]) != self.k:
            raise ValueError(f"checkpoint accumulates {state['k']} micro-batches, this run {self.k}")
        self.mini_step = int(state["mini_step"])
        self.acc = [t.clone() for t in state["acc"]]


def apply_gradients(optimizer: torch.optim.Optimizer, scheduler, clip_grad: float,
                    accumulator: Optional[GradientAccumulator] = None, mesh=None,
                    sharded: Collection[int] = frozenset()) -> bool:
    """The optimizer update on the live params' ``.grad``: with an
    ``accumulator``, the gradient is first added to it and nothing more
    happens until its k-th call; then clip by the global norm
    (``clip_grad`` > 0), AdamW, one schedule step. Returns whether the
    update was applied."""
    params = live_params(optimizer)
    if accumulator is not None and not accumulator.add(params):
        return False
    if clip_grad:
        clip_by_global_norm(params, clip_grad, mesh, sharded)
    optimizer.step()
    scheduler.step()
    return True


def load_optimizer_state(trainer, state: Dict) -> None:
    """Restore a trainer's AdamW, scheduler, applied-step count and
    accumulation buffers from its ``state_dict()`` (moments onto the params'
    device)."""
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.scheduler.load_state_dict(state["scheduler"])
    trainer.step_count = int(state["step"])
    accum = state.get("accum")
    if (accum is None) != (trainer.accumulator is None):
        raise ValueError("the checkpoint and this run disagree on gradient accumulation")
    if accum is not None:
        trainer.accumulator.load_state_dict(
            {**accum, "acc": [t.to(trainer.device) for t in accum["acc"]]})
