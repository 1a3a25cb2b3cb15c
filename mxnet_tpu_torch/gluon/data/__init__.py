"""Gluon data API: datasets, samplers and the DataLoader.

The PyTorch counterpart of ``mxnet_tpu/gluon/data/`` (reference:
python/mxnet/gluon/data/). Batches are host (CPU) NDArrays, as in
MXNet; ``pipeline.DeviceFeed`` stages them onto the card.
"""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_batchify_fn", "vision"]
