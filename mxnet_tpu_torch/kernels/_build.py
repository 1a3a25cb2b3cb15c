"""Build the port's CUDA kernels at first use, and count their launches.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/mxnet_tpu_torch/<name>-<hash>.so <name>.cu

The library lands in ``build/mxnet_tpu_torch/`` beside the package,
keyed by a hash of the source, every ``*.cuh`` header and the flags, so
an edited source rebuilds and an unchanged one loads at once. PyTorch's
own extension tool is not used: it needs ``ninja`` and compiles
PyTorch's headers for minutes, where a plain C file takes seconds.
:func:`build_all` starts one ``nvcc`` per source together. A failed or
impossible build (no ``nvcc``) raises :class:`MXNetError`; nothing falls
back to another implementation.

Importing this module runs nothing: the CPU tests import it on hosts
with no CUDA toolkit.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_all",
           "load", "count_launch", "launch_counts", "reset_launch_counts",
           "recording_launches", "count_replay"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "mxnet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600

# guards: _LIBS
_LIB_LOCK = threading.Lock()
_LIBS = {}  # source name -> ctypes.CDLL

# guards: _LAUNCHES
_COUNT_LOCK = threading.Lock()
_LAUNCHES = {}  # kernel name -> launches since the last reset
# a thread's launch record while it captures a CUDA graph (None otherwise)
_RECORDING = threading.local()


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise MXNetError(
        "cannot build the CUDA kernels: nvcc not found on PATH or under "
        "CUDA_HOME")


def _library_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(os.listdir(CSRC_DIR)):
        if hdr.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, hdr), "rb") as f:
                h.update(hdr.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None):
    """Compile every source in ``names`` (default: all) that has no
    current library, one ``nvcc`` process per source, all started
    together. Returns ``{name: {"seconds": s, "log": compiler output}}``
    for the sources it compiled (the log holds ``-Xptxas -v``'s register
    and shared-memory report). Raises :class:`MXNetError` naming the
    compiler's errors if any build fails."""
    names = sources() if names is None else list(names)
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    report, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {_BUILD_TIMEOUT_S} s"
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: a racing build loads either
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"--- {name}.cu ---\n{log}")
    if failed:
        raise MXNetError("nvcc failed to build the CUDA kernels:\n"
                         + "\n".join(failed))
    return report


def load(name):
    """The ``ctypes.CDLL`` built from ``csrc/<name>.cu`` (building it
    first if needed)."""
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_library_path(name))
            _LIBS[name] = lib
        return lib


def count_launch(name):
    """Record one launch of kernel ``name`` (called by its wrapper right
    where the kernel is launched, and nowhere else). Inside
    :func:`recording_launches` the launch goes into the graph being
    captured, not to the device, so it is noted in that record instead;
    :func:`count_replay` counts it each time the graph runs."""
    rec = getattr(_RECORDING, "launches", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Around a CUDA-graph capture on this thread: yields the dict
    ``{kernel name: launches}`` that the captured work recorded, and
    counts none of them as launched."""
    if getattr(_RECORDING, "launches", None) is not None:
        raise MXNetError("recording_launches does not nest")
    _RECORDING.launches = rec = {}
    try:
        yield rec
    finally:
        _RECORDING.launches = None


def count_replay(record):
    """Count one replay of a captured graph whose capture recorded
    ``record`` (from :func:`recording_launches`)."""
    with _COUNT_LOCK:
        for name, n in record.items():
            _LAUNCHES[name] = _LAUNCHES.get(name, 0) + n


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts():
    with _COUNT_LOCK:
        _LAUNCHES.clear()
