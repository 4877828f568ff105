"""Process groups, per-process data feeding and host-object gathering
(port of ``parallel/multihost.py``).

The JAX package runs one process per host over ``jax.distributed``; the
port runs one process per rank over ``torch.distributed``. Every function
degenerates cleanly when no process group exists (one process), so the same
code runs from one card to many.

  * :func:`maybe_initialize` — ``init_process_group`` with ``env://`` (or the
    address given), NCCL when the process has a card and gloo on the CPU.
  * :func:`shard_batch_indices` / :class:`ProcessShardedBatchSampler` — the
    contiguous share of each global batch's index list that a process loads.
  * :func:`make_global_batch` — this rank's rows of a global batch (the row
    selection of :func:`parallel.mesh.put_batch`; there is no global array
    to assemble).
  * :func:`shard_eval_items` — strided split of an eval item list.
  * :func:`gather_objects` / :func:`gather_clip_scores` — host-object
    all-gather (``all_gather_object``), used to merge per-process scores.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from transformer4sed_tpu_torch.parallel.mesh import put_batch


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns logging / checkpoint / score writes."""
    return process_index() == 0


def maybe_initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> bool:
    """``torch.distributed.init_process_group`` when several processes are
    requested: any argument given, or ``WORLD_SIZE`` / ``T4S_MULTIHOST`` in
    the environment (``env://`` then reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``). The backend is NCCL when the process sees a
    card and gloo otherwise. Returns False (and does nothing) for a plain
    single-process run, True once a process group exists. A failure to
    initialise raises: nothing carries on without the group it asked for."""
    if dist.is_initialized():
        return True
    requested = (init_method is not None or world_size is not None or rank is not None
                 or os.environ.get("WORLD_SIZE") or os.environ.get("T4S_MULTIHOST"))
    if not requested:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return True


# -- per-process data feeding ------------------------------------------------------


def shard_batch_indices(indices: Sequence[int], pi: Optional[int] = None,
                        pc: Optional[int] = None) -> List[int]:
    """This process's contiguous chunk ``[pi * B/pc, (pi+1) * B/pc)`` of a
    global batch index list; the global batch size must divide evenly (batch
    sizes are global)."""
    pi = process_index() if pi is None else pi
    pc = process_count() if pc is None else pc
    if pc == 1:
        return list(indices)
    n = len(indices)
    if n % pc:
        raise ValueError(f"global batch size {n} not divisible by process_count {pc}; "
                         f"adjust training.batch_size (it is a GLOBAL size)")
    local = n // pc
    return list(indices[pi * local:(pi + 1) * local])


class ProcessShardedBatchSampler:
    """Wrap a deterministically seeded global batch sampler so that each
    process yields only its contiguous chunk of every global batch; the
    wrapped sampler must make the same index stream on every process."""

    def __init__(self, batch_sampler, pi: Optional[int] = None, pc: Optional[int] = None):
        self.batch_sampler = batch_sampler
        self._pi = pi
        self._pc = pc

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for indices in self.batch_sampler:
            yield shard_batch_indices(indices, self._pi, self._pc)


def shard_eval_items(items: Sequence, pi: Optional[int] = None,
                     pc: Optional[int] = None) -> List:
    """Strided split of an eval item list across processes (unequal shares
    are fine: per-clip scores merge through :func:`gather_clip_scores`)."""
    pi = process_index() if pi is None else pi
    pc = process_count() if pc is None else pc
    return list(items[pi::pc])


def make_global_batch(local_batch: Any, mesh) -> Any:
    """This rank's rows of a global batch: :func:`parallel.mesh.put_batch`.
    Each rank computes on its own rows, so no global array is assembled."""
    return put_batch(local_batch, mesh)


# -- host-object gathering (eval scores) ------------------------------------------


def gather_objects(obj: Any) -> List[Any]:
    """All-gather one picklable host object per process -> list of all, in
    rank order; ``[obj]`` without a process group."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_clip_scores(scores: Dict[str, Any]) -> Dict[str, Any]:
    """Merge per-process ``{clip_id: scores}`` shards into the full table on
    every process (clip ids are disjoint by :func:`shard_eval_items`;
    duplicates keep the first)."""
    merged: Dict[str, Any] = {}
    for part in gather_objects(scores):
        for k, v in part.items():
            merged.setdefault(k, v)
    return merged
