"""Vision datasets and transforms (reference:
python/mxnet/gluon/data/vision/)."""
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset", "transforms"]
