"""The Gluon Fit API (``gluon.contrib.estimator``; reference:
python/mxnet/gluon/contrib/estimator/__init__.py), the PyTorch
counterpart of ``mxnet_tpu/gluon/contrib/estimator/``."""
from .estimator import Estimator
from .event_handler import *  # noqa: F401,F403
from .event_handler import __all__ as _eh_all

__all__ = ["Estimator"] + list(_eh_all)
