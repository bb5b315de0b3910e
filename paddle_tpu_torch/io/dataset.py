"""Datasets and samplers: the port of ``paddle_tpu/io/dataset.py``.

Same classes and semantics. Where the reference draws from numpy's global
stream (``RandomSampler``, ``WeightedRandomSampler``, ``random_split``), the
port draws from an explicit generator: the ``generator`` argument (the
port's ``framework.random.Generator`` or a CPU ``torch.Generator``), else the
port's default generator. ``DistributedBatchSampler`` shuffles with numpy
seeded by its epoch, as the reference.
"""
from __future__ import annotations

import bisect
import math

import numpy as np
import torch

from ..framework import random as random_mod

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler"]


def _cpu_generator(generator) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return (generator or random_mod.default_generator()).for_device("cpu")


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Samples ``tuple(t[idx] for t in tensors)`` of tensors or arrays that
    share their first dimension."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """The fields of several datasets' samples side by side."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, tuple):
                sample.extend(item)
            else:
                sample.append(item)
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        if ds_idx > 0:
            idx -= self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths over a random permutation
    drawn from ``generator``."""
    if sum(lengths) != len(dataset):
        raise ValueError("Sum of input lengths does not equal dataset length")
    indices = torch.randperm(len(dataset),
                             generator=_cpu_generator(generator)).tolist()
    out, offset = [], 0
    for ln in lengths:
        out.append(Subset(dataset, indices[offset:offset + ln]))
        offset += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A random permutation (or, with ``replacement``, independent draws)
    of the indices, from ``generator`` at each iteration."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = _cpu_generator(self.generator)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=g).tolist())
        return iter(torch.randperm(n, generator=g)[:self.num_samples]
                    .tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """Indices drawn with probability proportional to ``weights``."""

    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or (w < 0).any():
            raise ValueError("weights must be a 1-D non-negative list")
        if w.sum() == 0:
            raise ValueError("weights sum to zero — no index can be drawn")
        if not replacement and num_samples > w.size:
            raise ValueError(
                "num_samples cannot exceed len(weights) when drawing "
                "without replacement")
        self.weights = w
        self.num_samples = int(num_samples)
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        return iter(torch.multinomial(
            torch.from_numpy(self.weights), self.num_samples,
            self.replacement, generator=_cpu_generator(self.generator))
            .tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batches: rank ``rank`` of ``num_replicas`` takes every
    ``num_replicas``-th index of the (padded) index list, shuffled with
    numpy seeded by the epoch (``set_epoch``) when ``shuffle``. Without
    ``num_replicas``/``rank`` they come from ``torch.distributed`` when it
    is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if live else 1
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
