"""Kernels: the hand-written CUDA kernels and the ops built on them.

``_build`` compiles ``csrc/*.cu`` at first use and counts launches;
``flash_attention`` holds the decode-attention kernel K2 and its plain
version; ``attention`` registers the decode ops the decoder calls.
"""
from . import _build, attention, flash_attention  # noqa: F401

__all__ = ["_build", "attention", "flash_attention"]
