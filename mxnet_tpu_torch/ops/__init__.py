"""Op-level entry points of hand-written kernels.

The PyTorch counterpart of ``mxnet_tpu/ops``: the kernels live in
``mxnet_tpu_torch.kernels``; this package keeps the op-level names the
JAX package exports from here.
"""
from .flash_attention import flash_attention  # noqa: F401

__all__ = ["flash_attention"]
