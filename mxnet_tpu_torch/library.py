"""Dynamic operator libraries (reference: python/mxnet/library.py).

The PyTorch counterpart of ``mxnet_tpu/library.py``. The reference's
``mx.library.load("libmyop.so")`` dlopens a C++ library built against
``lib_api.h`` and registers its operators. Here an op library is a
Python module (``.py``) or a CPython extension (``.so``) that defines

    def register_ops(registry) -> None

and calls ``registry.register(...)`` on torch op bodies (the port's
``ndarray.registry``). Loaded ops appear under ``mx.nd`` and ``mx.sym``
like built-ins: both namespaces are populated after each load.
"""
from __future__ import annotations

import importlib.util
import logging
import os

from .base import MXNetError

__all__ = ["load", "loaded_libraries"]

_loaded = {}


def loaded_libraries():
    """Paths of every op library loaded this process, in load order."""
    return list(_loaded)


def load(path, verbose=True):
    """Load an operator library and register its ops
    (reference: library.py load / MXLoadLib)."""
    path = os.path.abspath(path)
    if path in _loaded:
        return _loaded[path]
    if not os.path.isfile(path):
        raise MXNetError(f"op library not found: {path}")
    ext = os.path.splitext(path)[1]
    if ext not in (".py", ".so"):
        raise MXNetError(
            f"op library must be a .py module or a CPython .so extension, "
            f"got '{ext}' ({path})")
    modname = "_mx_oplib_" + os.path.basename(path).split(".")[0]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise MXNetError(f"cannot load op library {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    hook = getattr(module, "register_ops", None)
    if hook is None:
        raise MXNetError(
            f"op library {path} does not define register_ops(registry)")
    from . import ndarray as _nd_mod
    from . import symbol as _sym_mod
    from .ndarray import registry

    before = set(registry.list_ops())
    hook(registry)
    added = sorted(set(registry.list_ops()) - before)
    # the new ops through the nd and sym namespaces, like built-ins
    _nd_mod._populate(added)
    _sym_mod._populate()
    if verbose and added:
        logging.info("loaded library %s: ops %s", path, ", ".join(added))
    _loaded[path] = module
    return module
