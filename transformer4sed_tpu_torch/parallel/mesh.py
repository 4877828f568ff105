"""The ('data', 'model') layout of the ranks, and the data-parallel step
(port of ``parallel/mesh.py`` and of ``make_2d_mesh`` in
``parallel/partition.py``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` and lets
GSPMD keep global semantics. The port runs one process per rank under
``torch.distributed`` and computes locally, so a :class:`Mesh` is what each
rank needs for that: the world group, the process group of its ``data`` axis
(the ranks that hold the same parameter shards) and of its ``model`` axis
(the ranks that split one replica's heads and features), its coordinates and
its device. The model axis is innermost, so a model group is consecutive
ranks, as in the JAX layout.

  * :func:`put_batch` keeps this rank's contiguous share of a global batch.
    For a batch made of subsets (the mean teacher's [strong | weak |
    unlabeled]) the trainers keep :meth:`Mesh.batch_rows`, an equal share of
    every subset, so that every mean-form loss is the mean of the ranks'
    local means, which is what averaging the gradients over the ``data``
    group computes.
  * :func:`shard_train_step` attaches the mesh to a trainer (the mean
    teacher, the supervised step, the MLM step). Its step then keeps the
    rank's rows after the augmentation, hands the model those rows
    (``models/cnn.py:BatchRows``), so that dropout, DropPath, token dropout
    and the MLM mask are drawn for the global batch, averages the gradients
    over the ``data`` group after the backward, clips by the global norm of
    the sharded and replicated gradients (``train/optim.py``), and reports
    the losses averaged over the ``data`` group. BatchNorm takes its
    statistics over the ``data`` group (``models/norm.py``).

``ensure_virtual_devices`` has no counterpart: the CPU runs launch gloo ranks
(``parallel/dryrun.py``). ``batch_sharding`` and ``replicated_sharding`` are
GSPMD's notions and have none either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


def require_devices(n_devices: int) -> List[int]:
    """The first ``n_devices`` ranks of the world; raises when the process
    group has fewer (silent truncation would make every later divisibility
    failure cryptic)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n_devices:
        raise ValueError(
            f"requested {n_devices} ranks, the process group has {world}: start one process "
            f"per rank (parallel.dryrun.launch, or torchrun) before building the mesh")
    return list(range(n_devices))


def _default_device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclass(eq=False)
class Mesh:
    """This rank's view of a data x model layout over ranks [0, data*model).

    A rank outside the layout has ``member`` False and no groups; it takes
    part in building the groups (every rank must) and in nothing else.
    """

    data: int
    model: int
    member: bool
    data_index: int
    model_index: int
    world_group: Any
    data_group: Any
    model_group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def __deepcopy__(self, memo):  # process groups are not copied with a module
        return self

    def batch_rows(self, sizes: Sequence[int]) -> torch.Tensor:
        """Global row indices this rank keeps of a batch made of subsets of
        ``sizes`` rows each (one subset: a contiguous block): an equal share of
        every subset, in subset order."""
        rows, start = [], 0
        for n in sizes:
            if n % self.data:
                raise ValueError(f"a subset of {n} rows does not split over {self.data} data ranks "
                                 f"(batch sizes are global)")
            share = n // self.data
            rows.append(torch.arange(start + self.data_index * share,
                                     start + (self.data_index + 1) * share))
            start += n
        return torch.cat(rows)

    def local_sizes(self, sizes: Sequence[int]) -> List[int]:
        return [n // self.data for n in sizes]

    def average_gradients(self, params: Iterable[torch.Tensor]) -> None:
        """Mean of every gradient over the ``data`` group, in one flat
        all-reduce per dtype."""
        grads = [p.grad for p in params if p.grad is not None]
        for dtype in sorted({g.dtype for g in grads}, key=str):
            same = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.data_group)
            flat.div_(self.data)
            offset = 0
            for g in same:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def gather_rows(self, x: torch.Tensor, rows: torch.Tensor, total: int) -> torch.Tensor:
        """The global [total, ...] tensor of which ``x`` holds this rank's
        ``rows``, summed over the ``data`` group from zeros elsewhere; its
        gradient is summed over the group, so each rank's rows receive every
        rank's cotangent (``collectives.all_reduce_sum``)."""
        from transformer4sed_tpu_torch.parallel.collectives import all_reduce_sum

        whole = x.new_zeros((total,) + tuple(x.shape[1:])).index_copy(0, rows.to(x.device), x)
        return all_reduce_sum(whole, self.data_group)

    def mean_metrics(self, metrics: dict) -> dict:
        """The tensor entries of ``metrics`` averaged over the ``data`` group
        (one all-reduce); other entries as they are."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        if not keys:
            return dict(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=self.data_group)
        vals = vals / self.data
        return {**metrics, **{k: vals[i] for i, k in enumerate(keys)}}


def build_mesh(data: int, model: int, first_rank: int = 0) -> Mesh:
    """The data x model layout of ranks [first_rank, first_rank + data*model),
    the model axis innermost. Every rank of the world must call it, in the
    same order (torch.distributed builds groups collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("the mesh needs a process group: call parallel.maybe_initialize "
                           "(or torch.distributed.init_process_group) first")
    n = data * model
    ranks = [first_rank + r for r in require_devices(first_rank + n)[:n]]
    base = first_rank
    world_group = dist.new_group(ranks)
    data_groups = [dist.new_group([base + d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([base + d * model + m for m in range(model)])
                    for d in range(data)]
    rank = dist.get_rank() - base
    member = 0 <= rank < n
    d_idx, m_idx = (rank // model, rank % model) if member else (-1, -1)
    return Mesh(data=data, model=model, member=member, data_index=d_idx, model_index=m_idx,
                world_group=world_group if member else None,
                data_group=data_groups[m_idx] if member else None,
                model_group=model_groups[d_idx] if member else None,
                device=_default_device())


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """All ``n_devices`` ranks (default: the world) on the ``data`` axis, a
    ``model`` axis of one. Fails loudly on a short world."""
    n = n_devices if n_devices is not None else dist.get_world_size()
    return build_mesh(n, 1)


def make_2d_mesh(n_devices: Optional[int] = None, model_parallel: int = 2) -> Mesh:
    """('data', 'model') layout of ``n_devices`` ranks (default: the world),
    the model axis innermost."""
    n = n_devices if n_devices is not None else dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    return build_mesh(n // model_parallel, model_parallel)


def put_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a tensor, or a dict / list /
    tuple of them, each with the batch leading): its contiguous share. A
    trainer whose batch is made of subsets keeps an equal share of each
    through :meth:`Mesh.batch_rows` itself."""

    def rows_of(x):
        return x.index_select(0, mesh.batch_rows((x.shape[0],)).to(x.device))

    return _tree_map(rows_of, batch)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(torch.as_tensor(tree))


def attach_mesh(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Give every BatchNorm of ``module`` the mesh whose ``data`` group its
    statistics are taken over (None: this process's rows only)."""
    from transformer4sed_tpu_torch.models.norm import RefBatchNorm

    for m in module.modules():
        if isinstance(m, RefBatchNorm):
            m.mesh = mesh


def shard_train_step(trainer, mesh: Mesh):
    """The data-parallel step of ``trainer`` (a ``MeanTeacherTrainer``, a
    ``SupervisedStep`` or an ``MLMTrainer``) over ``mesh``: returns its
    ``step``, which from now on keeps this rank's rows, draws every per-row
    draw for the global batch, averages the gradients over the ``data``
    group after the backward and reads BatchNorm statistics over that group.
    Shard the model's params (:func:`parallel.shard_params`) before building
    the trainer, so that its optimizer holds the shards."""
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    trainer.mesh = mesh
    for model in trainer.models():
        attach_mesh(model, mesh)
    return trainer.step


def device_prefetch(iterator, mesh: Optional[Mesh] = None, size: int = 2):
    """Batches moved ``size`` steps ahead to the mesh's device (without a
    mesh, the card), by non-blocking copies from pinned memory where that
    device is a card; with a mesh, this rank's rows only."""
    import collections
    import itertools

    dev = mesh.device if mesh is not None else torch.device("cuda")

    def put(batch):
        if mesh is not None:
            batch = put_batch(batch, mesh)
        return _tree_map(lambda x: (x.pin_memory() if dev.type == "cuda" else x).to(
            dev, non_blocking=True), batch)

    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        yield queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
