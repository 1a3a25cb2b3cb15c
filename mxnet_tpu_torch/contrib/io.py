"""The legacy contrib IO (``mx.contrib.io``; reference:
python/mxnet/contrib/io.py): :class:`DataLoaderIter` gives a Gluon
``DataLoader`` the classic ``DataIter`` interface. The PyTorch
counterpart of ``mxnet_tpu/contrib/io.py``."""
from __future__ import annotations

from ..io.io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """A ``gluon.data.DataLoader`` as a ``DataIter`` (reference
    contrib/io.py:25): ``provide_data`` and ``provide_label`` come from
    the first batch, so ``Module.fit`` can bind; that batch is then the
    first ``next()``."""

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        super().__init__()
        self._loader = loader
        self._iter = iter(loader)
        self._peek = self._fetch()
        first = self._peek
        self.provide_data = [DataDesc(data_name, first.data[0].shape,
                                      str(first.data[0].dtype))]
        self.provide_label = [DataDesc(label_name, l.shape, str(l.dtype))
                              for l in first.label[:1]]
        self.batch_size = first.data[0].shape[0]

    def _fetch(self):
        batch = next(self._iter)  # StopIteration propagates
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return DataBatch(data=[batch[0]], label=[batch[1]], pad=0)
        return DataBatch(data=[batch], label=[], pad=0)

    def reset(self):
        self._iter = iter(self._loader)
        self._peek = None

    def next(self):
        if self._peek is not None:
            b, self._peek = self._peek, None
            return b
        return self._fetch()

    __next__ = next
