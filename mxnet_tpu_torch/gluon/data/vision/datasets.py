"""Vision datasets that read local files.

The PyTorch counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``
(reference: python/mxnet/gluon/data/vision/datasets.py). The port
downloads nothing: MNIST and FashionMNIST read the idx-ubyte files
(optionally gzipped) under ``root``, CIFAR10/100 the python pickle
batches under ``root/cifar-10-batches-py`` (``cifar-100-python``), and
``ImageFolderDataset`` one folder per class of jpg/png files, decoded
with Pillow at access. A missing file raises FileNotFoundError naming
it (the JAX package makes random data instead). Images are host uint8
NDArrays in HWC, labels numpy int32, as in the JAX package.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as onp

from ....base import MXNetError
from ....ndarray import NDArray
from ....ndarray.ndarray import host_tensor
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


def _host(arr):
    """A host NDArray holding a copy of ``arr`` (which may be a read-only
    view of a file's bytes)."""
    return NDArray(host_tensor(onp.array(arr)))


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">HBB", f.read(4))[2]
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(shape)


def _find(path):
    for suffix in ("", ".gz"):
        if os.path.exists(path + suffix):
            return path + suffix
    raise FileNotFoundError(
        f"{path} (or {path}.gz) not found: the port reads local dataset "
        "files and downloads nothing")


class MNIST(_DownloadedDataset):
    """Reference: datasets.py MNIST: (28, 28, 1) uint8 images."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        img_f, lbl_f = self._train_files if self._train else self._test_files
        data = _read_idx(_find(os.path.join(self._root, img_f)))
        label = _read_idx(_find(os.path.join(self._root, lbl_f)))
        self._data = _host(data.reshape(-1, 28, 28, 1))
        self._label = label.astype(onp.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """Reference: datasets.py CIFAR10: (32, 32, 3) uint8 images from the
    python pickle batches."""

    _folder = "cifar-10-batches-py"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _files(self):
        return [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]

    def _label_key(self, batch):
        return "labels" if "labels" in batch else "fine_labels"

    def _get_data(self):
        datas, labels = [], []
        for name in self._files():
            path = os.path.join(self._root, self._folder, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found: the port reads local dataset files "
                    "and downloads nothing")
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            datas.append(onp.asarray(batch["data"]).reshape(
                -1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.extend(batch[self._label_key(batch)])
        self._data = _host(onp.concatenate(datas).astype(onp.uint8))
        self._label = onp.asarray(labels, dtype=onp.int32)


class CIFAR100(CIFAR10):
    """CIFAR-100 (``cifar-100-python/train`` and ``test``); the fine labels
    with ``fine_label=True``, else the coarse ones."""

    _folder = "cifar-100-python"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _files(self):
        return ["train"] if self._train else ["test"]

    def _label_key(self, batch):
        return "fine_labels" if self._fine else "coarse_labels"


def _imread(path, flag=1):
    """An image file as a host uint8 NDArray: HWC RGB, or HW1 gray for
    ``flag=0`` (the JAX package's ``image.imread``)."""
    from PIL import Image

    with Image.open(path) as img:
        arr = onp.asarray(img.convert("L"))[:, :, None] if flag == 0 \
            else onp.asarray(img.convert("RGB"))
    return _host(arr)


class ImageFolderDataset(Dataset):
    """One folder per class under ``root``; each sample is (image, label)
    with the class's index in sorted folder order (reference:
    datasets.py ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((filename, label))

    def __getitem__(self, idx):
        img = _imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(Dataset):
    """Reference: datasets.py ImageRecordDataset over ``.rec`` files. Not
    ported yet: it needs ``recordio`` and ``io/image_record.py``."""

    def __init__(self, filename, flag=1, transform=None):
        raise MXNetError(
            "ImageRecordDataset needs mxnet_tpu_torch.recordio, which is "
            "not ported yet (it comes with io/image_record.py)")
