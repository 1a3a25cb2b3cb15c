"""Build and load the port's host libraries (``csrc/*.cc``).

Three C++ sources run on the host, each compiled by ``g++`` into a shared
library with a plain C interface and loaded with ``ctypes``:

- ``csrc/engine.cc``: the dependency engine and the pooled host storage
  (``engine.py``, ``storage.py``);
- ``csrc/recordio.cc``: the RecordIO frame parser and the libjpeg decode
  route (``io/image_record.py``). Where the host has no ``jpeglib.h`` it
  is built with ``-DMXTT_NO_LIBJPEG`` (the frame parser alone), and the
  record iterator decodes on the card with nvJPEG
  (``kernels/jpeg_decode.py``);
- ``csrc/textio.cc``: the multithreaded CSV and LibSVM parsers of
  ``io.CSVIter`` and ``io.LibSVMIter``.

The flags are the JAX package's native build's (``-O3 -fPIC -std=c++17
-Wall -shared`` with ``-lpthread``, and ``-ljpeg`` for the decode). A
library lands beside the kernel libraries (``kernels._build.library_dir``:
``build/mxnet_tpu_torch/``, or ``MXNET_COMPILE_CACHE_DIR``), named by its
``compile_cache.fingerprint`` over the source, the flags and
``g++ --version``: an edited source rebuilds, an unchanged one loads at
once. A failed or impossible build (no ``g++``) raises
:class:`MXNetError`; nothing falls back to a Python engine. The JAX
package's own libraries are never loaded.

Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["CXX_FLAGS", "build", "engine_lib", "io_lib", "io_loaded",
           "text_lib", "decoder"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_BUILD_TIMEOUT_S = 300

# guards: _LIBS, _GXX_VERSION, _HAS_JPEG
_LOCK = threading.Lock()
_LIBS = {}  # source name -> ctypes.CDLL
_GXX_VERSION = {}
_HAS_JPEG = {}


def _gxx():
    found = shutil.which("g++")
    if found is None:
        raise MXNetError("cannot build the port's host libraries "
                         "(csrc/*.cc): g++ not found on PATH")
    return found


def _gxx_version(gxx):
    ver = _GXX_VERSION.get(gxx)
    if ver is None:
        ver = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        _GXX_VERSION[gxx] = ver
    return ver


def _jpeg_header(gxx):
    """Whether ``gxx`` finds ``jpeglib.h`` (asked once per compiler)."""
    found = _HAS_JPEG.get(gxx)
    if found is None:
        proc = subprocess.run(
            [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
            input="#include <jpeglib.h>\n", capture_output=True, text=True,
            timeout=60)
        found = _HAS_JPEG[gxx] = proc.returncode == 0
    return found


def _flags(name, gxx):
    """(compile flags, link flags) of ``csrc/<name>.cc`` on this host."""
    if name == "recordio":
        if _jpeg_header(gxx):
            return CXX_FLAGS, ("-ljpeg", "-lpthread")
        return CXX_FLAGS + ("-DMXTT_NO_LIBJPEG",), ("-lpthread",)
    return CXX_FLAGS, ("-lpthread",)


def build(name):
    """Compile ``csrc/<name>.cc`` unless a current library exists; returns
    its path. Raises :class:`MXNetError` with the compiler's output when
    the build fails."""
    from .kernels._build import library_dir
    from .utils import compile_cache as _cc

    gxx = _gxx()
    src = os.path.join(_CSRC, name + ".cc")
    flags, link = _flags(name, gxx)
    fp = _cc.fingerprint("host_library",
                         (name, flags, link, _gxx_version(gxx)),
                         code_of=[src])
    path = os.path.join(library_dir(), f"{name}-{fp[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(library_dir(), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([gxx, *flags, "-o", tmp, src, *link],
                              capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise MXNetError(f"g++ timed out building csrc/{name}.cc") from None
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise MXNetError(f"g++ failed to build csrc/{name}.cc:\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a racing build loads either
    return path


def _load(name, bind):
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _LIBS[name] = lib
        return lib


def _bind_engine(L):
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    L.eng_create_lanes.restype = vp
    L.eng_create_lanes.argtypes = [ctypes.c_int, ctypes.c_int]
    L.eng_destroy.argtypes = [vp]
    L.eng_new_var.restype = i64
    L.eng_new_var.argtypes = [vp]
    L.eng_push_lane.restype = i64
    L.eng_push_lane.argtypes = [vp, vp, vp, ctypes.POINTER(i64),
                                ctypes.c_int, ctypes.POINTER(i64),
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    L.eng_wait_for_var.restype = i64
    L.eng_wait_for_var.argtypes = [vp, i64]
    L.eng_wait_all.argtypes = [vp]
    L.eng_var_version.restype = ctypes.c_uint64
    L.eng_var_version.argtypes = [vp, i64]
    L.pool_create2.restype = vp
    L.pool_create2.argtypes = [ctypes.c_int, i64]
    L.pool_alloc.restype = vp
    L.pool_alloc.argtypes = [vp, i64]
    L.pool_free.argtypes = [vp, vp]
    L.pool_direct_free.argtypes = [vp, vp]
    L.pool_release_all.argtypes = [vp]
    L.pool_destroy.argtypes = [vp]
    L.pool_stats.argtypes = [vp, ctypes.POINTER(i64)]


def _bind_io(L):
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    L.rio_open.restype = ctypes.c_void_p
    L.rio_open.argtypes = [ctypes.c_char_p]
    L.rio_close.argtypes = [ctypes.c_void_p]
    L.rio_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    L.rio_tell.restype = ctypes.c_long
    L.rio_tell.argtypes = [ctypes.c_void_p]
    L.rio_next.restype = ctypes.c_long
    L.rio_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p)]
    L.rio_has_jpeg.restype = ctypes.c_int
    L.rio_has_jpeg.argtypes = []
    if L.rio_has_jpeg():
        L.decode_jpeg.restype = ctypes.c_int
        L.decode_jpeg.argtypes = [u8p, ctypes.c_long] + [ctypes.c_int] * 6 \
            + [u8p]
        L.decode_batch.restype = ctypes.c_int
        L.decode_batch.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, u8p]


def _bind_text(L):
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(i64)
    L.textio_last_error.restype = ctypes.c_char_p
    L.csv_parse.restype = vp
    L.csv_parse.argtypes = [ctypes.c_char_p]
    L.svm_parse.restype = vp
    L.svm_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn, res in ((L.csv_rows, i64), (L.csv_cols, i64),
                    (L.csv_data, f32p), (L.svm_rows, i64), (L.svm_nnz, i64),
                    (L.svm_data, f32p), (L.svm_indices, i64p),
                    (L.svm_indptr, i64p), (L.svm_labels, f32p)):
        fn.restype = res
        fn.argtypes = [vp]
    L.csv_free.argtypes = [vp]
    L.svm_free.argtypes = [vp]


def engine_lib():
    """The engine library (``csrc/engine.cc``), built at first use."""
    return _load("engine", _bind_engine)


def io_lib():
    """The RecordIO library (``csrc/recordio.cc``), built at first use."""
    return _load("recordio", _bind_io)


def text_lib():
    """The text parsers' library (``csrc/textio.cc``), built at first
    use."""
    return _load("textio", _bind_text)


def io_loaded():
    """Whether this process has built and loaded the IO library."""
    with _LOCK:
        return "recordio" in _LIBS


def decoder():
    """The record decode route this machine has, chosen once by what it
    has: ``"libjpeg"`` (``csrc/recordio.cc`` on the host's cores) when
    the compiler finds ``jpeglib.h``, else ``"nvjpeg"`` (the CUDA
    toolkit's nvJPEG and the crop kernel of ``csrc/jpeg_decode.cu``) when
    the toolkit has nvJPEG and a card is present. Raises
    :class:`MXNetError` when the machine has neither."""
    if io_lib().rio_has_jpeg():
        return "libjpeg"
    from .kernels import jpeg_decode

    if jpeg_decode.available():
        return "nvjpeg"
    raise MXNetError(
        "no JPEG decoder on this machine: the compiler finds no "
        "jpeglib.h, and nvJPEG needs the CUDA toolkit's nvjpeg.h and "
        "libnvjpeg with a CUDA device")
