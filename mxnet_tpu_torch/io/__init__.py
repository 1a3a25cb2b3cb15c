"""Data iterators (reference: python/mxnet/io/io.py; the JAX package's
``io/``). ``ImageRecordIter`` and the other record-file iterators of
``io/image_record.py`` need ``recordio`` and are not ported yet."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, DevicePrefetchIter,
                 MNISTIter, NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter"]
