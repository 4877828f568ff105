"""Samplers: seeded shuffling, multi-source fixed-composition batches,
weighted sampling. Port of the JAX package's ``data/sampler.py``, on the
same numpy generators, so one seed gives the same index order.

``ConcatBatchSampler`` reproduces the reference's multi-source batch
contract (``src/preprocess/dataset.py:156-195``): each batch is the
concatenation of ``batch_sizes[i]`` indices from source ``i`` *in
source order*, so downstream loss masks are static slices; the epoch
length is the minimum source length divided by its per-batch quota.

``WeightedSampler`` matches ``get_weighted_sampler``
(``recipes/audioset_strong/setting.py:66-70``): per-clip weights, a
fixed number of draws per epoch, with replacement.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.n))

    def set_epoch(self, epoch: int):
        pass


class RandomSampler:
    """Seeded permutation, reshuffled per epoch via ``set_epoch``."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(hash((self.seed, self.epoch)) % (2**32))
        return iter(rng.permutation(self.n).tolist())


class WeightedSampler:
    """Weighted sampling with replacement, fixed draws per epoch."""

    def __init__(self, weights: Sequence[float], num_samples: int, seed: int = 0):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.weights = self.weights / self.weights.sum()
        self.num_samples = num_samples
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(hash((self.seed, self.epoch)) % (2**32))
        return iter(rng.choice(len(self.weights), size=self.num_samples, p=self.weights).tolist())


class ConcatBatchSampler:
    """Fixed per-source batch composition over concatenated datasets.

    Yields flat index lists into the concatenation of the sources, in
    source order: [s0 x batch_sizes[0], s1 x batch_sizes[1], ...].
    """

    def __init__(self, samplers: Sequence, batch_sizes: Sequence[int], epoch: int = 0):
        assert len(samplers) == len(batch_sizes)
        self.samplers = list(samplers)
        self.batch_sizes = list(batch_sizes)
        self.offsets = np.concatenate([[0], np.cumsum([len(s) for s in samplers])[:-1]]).tolist()
        self.set_epoch(epoch)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for s in self.samplers:
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch)

    def __len__(self):
        return min(len(s) // b for s, b in zip(self.samplers, self.batch_sizes))

    def __iter__(self) -> Iterator[List[int]]:
        iters = [iter(s) for s in self.samplers]
        for _ in range(len(self)):
            batch: List[int] = []
            for i, (it, b) in enumerate(zip(iters, self.batch_sizes)):
                for _ in range(b):
                    batch.append(self.offsets[i] + next(it))
            yield batch
