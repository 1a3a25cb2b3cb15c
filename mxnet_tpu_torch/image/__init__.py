"""``mx.image`` (reference: python/mxnet/image/__init__.py): decode,
augmenters and ``ImageIter``. ``image/detection.py`` comes with slice 11."""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
