"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module layout and
public names, built on PyTorch for an NVIDIA H100. Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand in CUDA C++ under ``csrc/``, built with ``nvcc``
at first use (``kernels/_build.py``). This slice covers stateful decode
serving of :class:`~.models.DecoderBlockLM`:

- ``mx.nd`` — NDArray over a ``torch.Tensor`` and the ops the decoder
  uses;
- ``mx.gluon`` — Block/HybridBlock as ``torch.nn.Module``s;
- ``mx.kernels`` — the decode-attention kernel K2 and its plain version;
- ``mx.serving`` — InferenceSession, SessionStateStore, DynamicBatcher;
- ``mx.convert`` — loading weights carried over as numpy arrays.

Entry points run on the card: the default context is ``gpu(0)``, and
with no CUDA device they raise :class:`MXNetError` unless the caller
passes ``ctx=mx.cpu()``. The package never imports ``jax`` or
``mxnet_tpu``.

Conventional import: ``import mxnet_tpu_torch as mx``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from . import autograd
from . import initializer
from . import initializer as init
from . import ndarray
from . import ndarray as nd
from . import random
from . import gluon
from . import kernels
from . import models
from . import serving
from . import convert

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "autograd", "initializer", "init", "ndarray", "nd",
           "random", "gluon", "kernels", "models", "serving", "convert"]
