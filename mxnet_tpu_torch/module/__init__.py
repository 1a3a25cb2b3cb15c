"""The Module API (reference: python/mxnet/module/; the JAX package's
``module/``): symbolic training over bound executors, which capture
their forward and backward as CUDA graphs on the card."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
