"""``mx.image`` (reference: python/mxnet/image/__init__.py): decode,
augmenters, ``ImageIter``, and the detection pipeline
(``image/detection.py``: the box-aware augmenters and ``ImageDetIter``)."""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from .detection import *  # noqa: F401,F403
from . import detection  # noqa: F401
