"""The op-level name of flash attention (K1).

The JAX package keeps this module as a shim over
``mxnet_tpu/kernels/flash_attention.py``; here it re-exports the port's
``kernels.flash_attention.flash_attention`` (K1, ``csrc/flash_attention.cu``
and ``csrc/flash_attention_sm90.cu`` on CUDA tensors, the plain version on
CPU tensors) and that plain version as ``_ref_attention``."""
from ..kernels.flash_attention import _flash_ref as _ref_attention  # noqa: F401
from ..kernels.flash_attention import flash_attention  # noqa: F401

__all__ = ["flash_attention", "_ref_attention"]
