"""Datasets, samplers and the DataLoader of the port (``paddle_tpu/io``)."""
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .dataset import (BatchSampler, ChainDataset, ComposeDataset,
                      ConcatDataset, Dataset, DistributedBatchSampler,
                      IterableDataset, RandomSampler, Sampler,
                      SequenceSampler, Subset, TensorDataset,
                      WeightedRandomSampler, random_split)

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "Dataset", "DistributedBatchSampler", "IterableDataset",
           "RandomSampler", "Sampler", "SequenceSampler", "Subset",
           "TensorDataset", "WeightedRandomSampler", "random_split"]
