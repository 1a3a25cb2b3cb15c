"""Build the port's CUDA kernels at first use, and count their launches.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/mxnet_tpu_torch/<name>-<hash>.so <name>.cu

The library lands in ``build/mxnet_tpu_torch/`` beside the package (or
in ``MXNET_COMPILE_CACHE_DIR`` when that is set), named by its
``compile_cache.fingerprint``: the source and every ``*.cuh`` header
(read as ``code_of``), the flags, ``nvcc --version``, the card's compute
capability and the compile cache's own salt. An edited source rebuilds
and an unchanged one loads at once. Beside each library a sidecar
``<name>-<fp>.json`` records the compiler version it was built with, so
a host without ``nvcc`` (a replica that imported a bundle,
``artifact/bundle.py``) finds the library by the same fingerprint;
without ``nvcc`` and without such a library, loading raises. PyTorch's
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
import glob
import json
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_all",
           "load", "library_dir", "library_fingerprint", "library_files",
           "recording_libraries", "count_launch",
           "launch_counts", "reset_launch_counts", "recording_launches",
           "count_replay"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "mxnet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600
#: link flags of the sources that call a library of the CUDA toolkit
LINK_FLAGS = {"jpeg_decode": ("-lnvjpeg",)}

# guards: _LIBS
_LIB_LOCK = threading.Lock()
_LIBS = {}  # source name -> ctypes.CDLL
_LIB_PATHS = {}  # source name -> the file it was loaded from

# guards: _LAUNCHES
_COUNT_LOCK = threading.Lock()
_LAUNCHES = {}  # kernel name -> launches since the last reset
# a thread's launch record while it captures a CUDA graph (None otherwise)
_RECORDING = threading.local()


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc(required=True):
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    if not required:
        return None
    raise MXNetError(
        "cannot build the CUDA kernels: nvcc not found on PATH or under "
        "CUDA_HOME")


_NVCC_VERSION = {}


def _nvcc_version(nvcc):
    """``nvcc --version``'s output (cached per compiler path)."""
    ver = _NVCC_VERSION.get(nvcc)
    if ver is None:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        _NVCC_VERSION[nvcc] = ver
    return ver


def library_dir():
    """Where the libraries live: ``MXNET_COMPILE_CACHE_DIR`` when set,
    else ``build/mxnet_tpu_torch/`` beside the package."""
    return os.environ.get("MXNET_COMPILE_CACHE_DIR") or BUILD_DIR


def _code_of(name):
    return [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
        os.path.join(CSRC_DIR, h) for h in os.listdir(CSRC_DIR)
        if h.endswith(".cuh"))


def library_fingerprint(name, nvcc_version):
    """The fingerprint of ``csrc/<name>.cu`` built by the compiler whose
    ``--version`` is ``nvcc_version`` for this card."""
    from ..utils import compile_cache as _cc

    key = (name, NVCC_FLAGS, nvcc_version, _cc._capability())
    if name in LINK_FLAGS:
        key += (LINK_FLAGS[name],)
    return _cc.fingerprint("kernel_library", key, code_of=_code_of(name))


def _paths(name, fp):
    stem = os.path.join(library_dir(), f"{name}-{fp[:16]}")
    return stem + ".so", stem + ".json"


def _prebuilt(name):
    """A library of ``name`` built elsewhere by any compiler version,
    found through its sidecar, or None: every other part of its
    fingerprint (source, headers, flags, card, salt) must match."""
    for side in sorted(glob.glob(os.path.join(library_dir(),
                                              f"{name}-*.json"))):
        try:
            with open(side) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        fp = library_fingerprint(name, meta.get("nvcc"))
        if fp == meta.get("fingerprint"):
            so, _ = _paths(name, fp)
            if os.path.exists(so):
                return so
    return None


def _library_path(name, nvcc=None):
    """The library file of ``name``: keyed by this host's compiler when
    it has one, else the prebuilt library whose sidecar matches."""
    nvcc = nvcc or _nvcc(required=False)
    if nvcc is None:
        found = _prebuilt(name)
        if found is None:
            _nvcc()  # raises: no compiler and no library to load
        return found
    return _paths(name, library_fingerprint(name, _nvcc_version(nvcc)))[0]


def build_all(names=None):
    """Compile every source in ``names`` (default: all) that has no
    current library, one ``nvcc`` process per source, all started
    together. Returns ``{name: {"seconds": s, "log": compiler output}}``
    for the sources it compiled (the log holds ``-Xptxas -v``'s register
    and shared-memory report). Raises :class:`MXNetError` naming the
    compiler's errors if any build fails."""
    names = sources() if names is None else list(names)
    nvcc = _nvcc(required=False)
    if nvcc is None:
        # a host without a compiler: every library must be prebuilt
        for n in names:
            _library_path(n)
        return {}
    todo = {n: _library_path(n, nvcc) for n in names}
    todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
    if not todo:
        return {}
    os.makedirs(library_dir(), exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu"),
               *LINK_FLAGS.get(name, ())]
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
            fp = library_fingerprint(name, _nvcc_version(nvcc))
            side = _paths(name, fp)[1]
            with open(side + ".tmp", "w") as f:
                json.dump({"name": name, "fingerprint": fp,
                           "nvcc": _nvcc_version(nvcc),
                           "flags": list(NVCC_FLAGS)}, f)
            os.replace(side + ".tmp", side)
            os.replace(tmp, path)  # atomic: a racing build loads either
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"--- {name}.cu ---\n{log}")
    from ..utils import compile_cache as _cc

    _cc.note_kernel_build(len(report))
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
            path = _library_path(name)
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
            _LIB_PATHS[name] = path
        return lib


@contextlib.contextmanager
def recording_libraries():
    """Yields the set of libraries whose kernels launch on this thread
    inside the block (:func:`count_launch`; a session's warmup: the
    libraries its graphs launch, which its bundle carries). Nests."""
    stack = getattr(_RECORDING, "libraries", None)
    if stack is None:
        stack = _RECORDING.libraries = []
    rec = set()
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def library_files(names):
    """``{file name: bytes}`` of the libraries ``names`` as this process
    loads them, each ``.so`` with its sidecar (a bundle's payload)."""
    out = {}
    for name in names:
        with _LIB_LOCK:
            so = _LIB_PATHS.get(name)
        so = so or _library_path(name)
        if so is None or not os.path.exists(so):
            raise MXNetError(f"kernel library {name!r} is not built here")
        for path in (so, so[:-3] + ".json"):
            with open(path, "rb") as f:
                out[os.path.basename(path)] = f.read()
    return out


#: launch-count names whose library is not the source of that name
_LIBRARY_OF = {"int8_to_nhwc": "int8_conv_sm90", "box_nms_mask": "box_nms",
               "box_nms_reduce": "box_nms", "box_nms_fused": "box_nms",
               "jpeg_crop": "jpeg_decode"}


def _note_library(name):
    """Note the library a launch of ``name`` runs in on this thread's
    :func:`recording_libraries` sets (the wrappers cache their entry
    points, so a later session's warmup calls no :func:`load`)."""
    recs = getattr(_RECORDING, "libraries", None)
    if not recs:
        return
    lib = _LIBRARY_OF.get(name, name)
    if os.path.exists(os.path.join(CSRC_DIR, lib + ".cu")):
        for rec in recs:
            rec.add(lib)


def count_launch(name):
    """Record one launch of kernel ``name`` (called by its wrapper right
    where the kernel is launched, and nowhere else). Inside
    :func:`recording_launches` the launch goes into the graph being
    captured, not to the device, so it is noted in that record instead;
    :func:`count_replay` counts it each time the graph runs."""
    _note_library(name)
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
