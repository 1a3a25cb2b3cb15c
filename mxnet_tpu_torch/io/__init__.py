"""Data iterators (reference: python/mxnet/io/io.py; the JAX package's
``io/``): the DataIter protocol and its array iterators, and the record
iterators of ``io/image_record.py``."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, DevicePrefetchIter,
                 MNISTIter, NDArrayIter, PrefetchingIter, ResizeIter)
from .image_record import ImageDetRecordIter, ImageRecordIter, LibSVMIter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter",
           "ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"]
