"""Process initialization: crash tracebacks and fork safety.

The PyTorch counterpart of ``mxnet_tpu/initialize.py`` (reference:
src/initialize.cc: a SIGSEGV handler printing a stack trace under
``MXNET_USE_SIGNAL_HANDLER``, and pthread atfork hooks that restart the
engine's workers, since threads never survive ``fork``):

- crash tracebacks through ``faulthandler`` (SIGSEGV, SIGFPE, SIGABRT
  and SIGBUS dump every thread's Python stack);
- ``os.register_at_fork`` drops the engine and storage singletons in a
  forked child, so the child builds fresh worker threads instead of
  waiting on the parent's dead ones.

A forked child of a process that holds a CUDA context cannot use CUDA:
the child's fresh engine runs host ops only, and the DataLoader's
process workers start from a forkserver and never touch the card.
Both install at import (``mxnet_tpu_torch/__init__``); the signal
handler honours ``MXNET_USE_SIGNAL_HANDLER`` (default on, as in the
reference's wheels).
"""
from __future__ import annotations

import faulthandler
import io
import os
import sys

from . import env as _env

__all__ = ["initialize", "install_signal_handlers", "install_fork_handlers",
           "installed"]

_installed = {"signals": False, "fork": False}


def installed():
    """``{"signals": bool, "fork": bool}``: what this process installed."""
    return dict(_installed)


def install_signal_handlers():
    """Enable crash tracebacks (reference: initialize.cc SegfaultLogger)."""
    if _installed["signals"]:
        return
    if not _env.get_bool("MXNET_USE_SIGNAL_HANDLER", True):
        return
    try:
        faulthandler.enable(file=sys.stderr, all_threads=True)
        _installed["signals"] = True
    except (RuntimeError, io.UnsupportedOperation, AttributeError):
        pass  # no usable stderr (embedded interpreter)


def _reinit_child():
    """After fork the child owns none of the engine's worker threads:
    drop the singletons so they rebuild on first use (reference:
    LibraryInitializer::atfork_child resets the engine).

    Lockless on purpose: the child is single-threaded right after fork,
    and ``engine._engine_lock`` may have been copied in the held state
    if another parent thread was inside ``engine.get()``; taking it
    would deadlock, so the lock is replaced too. The native pool's
    mutex and free lists were copied mid-flight: the child must not
    touch the parent's pool."""
    from . import engine as _engine
    from . import storage as _storage
    from .utils import locks as _locks

    _engine._engine = None
    _engine._engine_lock = _locks.RankedLock("engine.singleton")
    _storage._storage = None


def install_fork_handlers():
    if _installed["fork"]:
        return
    if hasattr(os, "register_at_fork"):
        os.register_at_fork(after_in_child=_reinit_child)
        _installed["fork"] = True


def initialize():
    install_signal_handlers()
    install_fork_handlers()
