"""Threaded batch loader with prefetch (port of the JAX package's
``data/loader.py``).

The reference uses torch DataLoader with 6 worker processes
(``recipes/desed/setting.py``); here a thread pool decodes WAVs (the
native decoder and scipy release the GIL) and a prefetch queue overlaps
host decoding with the card's steps. Batches are dicts of stacked numpy
arrays matching the train-step contract. The process split reads the
port's ``parallel/multihost.py``: rank and world size from
``torch.distributed`` when a group exists, else one process.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

from transformer4sed_tpu_torch.data.sampler import SequentialSampler
from transformer4sed_tpu_torch.parallel import multihost


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack a list of sample dicts into a batch dict (strings -> lists)."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating, bool, np.bool_)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


class _ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        base = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - base]


class _ProcessSubset:
    """Strided per-process view of an eval dataset (items ``[pi::pc]``).

    Multi-host evaluation is embarrassingly parallel: each process
    scores its own clips on its own local devices and the per-clip
    score tables are merged host-side by
    ``parallel.multihost.gather_clip_scores``. Identity at
    ``process_count == 1``-built loaders (never constructed then)."""

    def __init__(self, dataset, pi: int, pc: int):
        self.dataset = dataset
        self.indices = list(range(len(dataset)))[pi::pc]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]


class DataLoader:
    """Batch iterator over (dataset | [datasets]) driven by a (batch) sampler.

    Args:
      dataset: one dataset or a list (concatenated, for ConcatBatchSampler).
      batch_sampler: yields lists of indices; or pass ``sampler`` +
        ``batch_size`` for the simple case.
      num_workers: decode threads (0 = inline).
      prefetch: number of batches prepared ahead.
      process_shard: multi-host TRAIN loaders — each process yields its
        contiguous chunk of every (identically-seeded) global batch for
        ``parallel.put_batch`` reassembly.
      process_shard_items: multi-host EVAL loaders — each process sees a
        strided subset of the items and evaluates them locally; scores
        are merged by ``multihost.gather_clip_scores``.
    """

    def __init__(
        self,
        dataset,
        batch_sampler=None,
        sampler=None,
        batch_size: int = 1,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        collate_fn: Callable = collate,
        process_shard: bool = False,
        process_shard_items: bool = False,
    ):
        self.dataset = _ConcatDataset(dataset) if isinstance(dataset, (list, tuple)) else dataset
        if process_shard_items:
            if batch_sampler is not None or sampler is not None:
                raise ValueError(
                    "process_shard_items splits the dataset itself; it only "
                    "composes with the default sequential batcher"
                )
            if multihost.process_count() > 1:
                self.dataset = _ProcessSubset(
                    self.dataset, multihost.process_index(), multihost.process_count()
                )
        if batch_sampler is None:
            sampler = sampler or SequentialSampler(len(self.dataset))
            batch_sampler = _FixedBatcher(sampler, batch_size, drop_last)
        if process_shard:
            # multi-host: configs give GLOBAL batch sizes; each process
            # loads only its contiguous chunk of every (deterministic,
            # identically-seeded) global batch and reassembles via
            # parallel.multihost.make_global_batch. No-op single-process.
            batch_sampler = multihost.ProcessShardedBatchSampler(batch_sampler)
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.collate_fn = collate_fn

    def __len__(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def _load_batch(self, indices: List[int]) -> Dict:
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[Dict]:
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._load_batch(indices)
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures: "queue.Queue" = queue.Queue()
            it = iter(self.batch_sampler)
            n_submitted = 0
            try:
                for _ in range(self.prefetch):
                    futures.put(pool.submit(self._load_batch, next(it)))
                    n_submitted += 1
            except StopIteration:
                pass
            while n_submitted:
                fut = futures.get()
                n_submitted -= 1
                try:
                    futures.put(pool.submit(self._load_batch, next(it)))
                    n_submitted += 1
                except StopIteration:
                    pass
                yield fut.result()


class _FixedBatcher:
    def __init__(self, sampler, batch_size: int, drop_last: bool):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch
