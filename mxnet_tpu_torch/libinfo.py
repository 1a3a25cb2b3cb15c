"""Library discovery and version (reference: python/mxnet/libinfo.py).

The PyTorch counterpart of ``mxnet_tpu/libinfo.py``. The reference
locates ``libmxnet.so`` for its ctypes bridge; the port's native code is
its hand-written kernels, built by ``nvcc`` into shared libraries at
first use (``kernels/_build.py``), so :func:`find_lib_path` returns
those libraries and :func:`find_include_path` the kernels' sources.
"""
from __future__ import annotations

import os

__version__ = "0.1.0"

__all__ = ["find_lib_path", "find_include_path", "features", "__version__"]


def find_lib_path(prefix=""):
    """Paths of the built kernel libraries whose file name starts with
    ``prefix`` (none before a kernel's first build; nothing is built
    here)."""
    from .kernels import _build

    libdir = _build.library_dir()
    if not os.path.isdir(libdir):
        return []
    return sorted(os.path.join(libdir, f)
                  for f in os.listdir(libdir)
                  if f.endswith(".so") and f.startswith(prefix))


def find_include_path():
    """Directory of the kernels' CUDA C++ sources (``csrc``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def features():
    """Runtime feature flags (see :mod:`mxnet_tpu_torch.runtime`)."""
    from . import runtime

    return runtime.Features()
