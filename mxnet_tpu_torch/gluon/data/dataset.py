"""Datasets (reference: python/mxnet/gluon/data/dataset.py; the JAX
package's ``gluon/data/dataset.py``)."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Reference: dataset.py Dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        """``fn`` over every sample: applied at each access (``lazy``),
        or once now into a :class:`SimpleDataset`."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` over the first element of every sample (the data, not
        the label)."""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)

        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    """A dataset over any sequence."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Samples drawn index by index from several arrays of one length
    (reference: dataset.py ArrayDataset): one array gives its items, more
    give tuples."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; 0-th has "
                    f"{self._length} while {i}-th has {len(data)}.")
            if isinstance(data, (list, tuple)) or hasattr(data, "shape"):
                self._data.append(data)
            else:
                self._data.append(list(data))

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """A dataset over a RecordIO ``.rec`` file (reference: dataset.py
    RecordFileDataset). Not ported yet: it needs ``recordio``."""

    def __init__(self, filename):
        raise MXNetError(
            "RecordFileDataset needs mxnet_tpu_torch.recordio, which is not "
            "ported yet (it comes with io/image_record.py)")
