"""ctypes bindings to NVRTC and the CUDA driver API, for ``rtc.CudaModule``.

Two shared libraries, opened at first use and never when this module is
imported (the CPU tests import it on hosts with neither):

- ``libnvrtc`` compiles a CUDA C++ source string to a CUBIN for one
  architecture (``nvrtcCreateProgram``, ``nvrtcAddNameExpression``,
  ``nvrtcCompileProgram``, ``nvrtcGetLoweredName``, ``nvrtcGetCUBIN``);
- ``libcuda.so.1``, the driver, loads that CUBIN into torch's primary
  context (``cuModuleLoadData``), finds a kernel in it
  (``cuModuleGetFunction``) and launches it on a stream
  (``cuLaunchKernel``).

``libnvrtc`` is looked for in ``$CUDA_HOME/lib64`` (``/usr/local/cuda``
when unset), then in the ``nvidia/*/lib`` directories of the installed
CUDA wheels that torch depends on, then on the loader's path; the
``libnvrtc-builtins`` beside it is loaded first, so NVRTC finds it
whatever ``LD_LIBRARY_PATH`` says. Every failure raises
:class:`MXNetError`: a missing library, a compile error (with NVRTC's log
in the message), a failed load or launch. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys
import threading

from ..base import MXNetError

__all__ = ["cuda_home", "nvrtc_path", "nvrtc_version", "compile_cubin",
           "Driver"]

_NVRTC_SUCCESS = 0
_NVRTC_ERROR_COMPILATION = 6
_CUDA_SUCCESS = 0
CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

# guards: _NVRTC, _DRIVER, Driver._ctx
_LOCK = threading.Lock()
_NVRTC = None  # (ctypes.CDLL, path)
_DRIVER = None


def cuda_home():
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"


def _nvrtc_candidates():
    """Paths to try for libnvrtc, in order: the toolkit's ``lib64``, the
    CUDA wheels' ``nvidia/*/lib``, then the bare name for the loader."""
    found = []
    home = cuda_home()
    for d in (os.path.join(home, "lib64"), os.path.join(home, "lib")):
        found += sorted(glob.glob(os.path.join(d, "libnvrtc.so*")),
                        key=len)
    for site in sys.path:
        found += sorted(glob.glob(os.path.join(
            site, "nvidia", "*", "lib", "libnvrtc.so*")), key=len)
    found.append("libnvrtc.so")
    return [f for f in found if "builtins" not in os.path.basename(f)]


def _open_nvrtc():
    global _NVRTC
    with _LOCK:
        if _NVRTC is not None:
            return _NVRTC[0]
        errors = []
        for path in _nvrtc_candidates():
            d = os.path.dirname(path)
            try:
                if d:  # the builtins first, so NVRTC's own dlopen finds them
                    for b in sorted(glob.glob(os.path.join(
                            d, "libnvrtc-builtins.so*")), key=len)[:1]:
                        ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                lib = ctypes.CDLL(path)
            except OSError as e:
                errors.append(f"{path}: {e}")
                continue
            _declare_nvrtc(lib)
            _NVRTC = (lib, path)
            return lib
        raise MXNetError(
            "rtc.CudaModule needs NVRTC and no libnvrtc could be loaded "
            f"(CUDA_HOME={cuda_home()!r}); tried: " + "; ".join(errors))


def _declare_nvrtc(lib):
    P, S, C = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
    sigs = {
        "nvrtcGetErrorString": ([ctypes.c_int], C),
        "nvrtcVersion": ([ctypes.POINTER(ctypes.c_int)] * 2, ctypes.c_int),
        "nvrtcCreateProgram": ([ctypes.POINTER(P), C, C, ctypes.c_int,
                                ctypes.POINTER(C), ctypes.POINTER(C)],
                               ctypes.c_int),
        "nvrtcDestroyProgram": ([ctypes.POINTER(P)], ctypes.c_int),
        "nvrtcAddNameExpression": ([P, C], ctypes.c_int),
        "nvrtcCompileProgram": ([P, ctypes.c_int, ctypes.POINTER(C)],
                                ctypes.c_int),
        "nvrtcGetProgramLogSize": ([P, ctypes.POINTER(S)], ctypes.c_int),
        "nvrtcGetProgramLog": ([P, ctypes.c_char_p], ctypes.c_int),
        "nvrtcGetCUBINSize": ([P, ctypes.POINTER(S)], ctypes.c_int),
        "nvrtcGetCUBIN": ([P, ctypes.c_char_p], ctypes.c_int),
        "nvrtcGetLoweredName": ([P, C, ctypes.POINTER(C)], ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


def nvrtc_path():
    """The path of the libnvrtc this process loaded (loading it now)."""
    _open_nvrtc()
    return _NVRTC[1]


def nvrtc_version():
    """NVRTC's (major, minor) version."""
    lib = _open_nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _nvrtc_check(lib, rc, what):
    if rc != _NVRTC_SUCCESS:
        msg = lib.nvrtcGetErrorString(rc)
        raise MXNetError(f"{what} failed: "
                         f"{msg.decode() if msg else f'nvrtcResult {rc}'}")


def _cstrings(items):
    arr = (ctypes.c_char_p * max(len(items), 1))()
    for i, s in enumerate(items):
        arr[i] = s.encode()
    return arr


def compile_cubin(source, name, options, exports):
    """Compile ``source`` with ``options``; returns ``(cubin bytes,
    {export: lowered name}, log)``. An export is a C++ name expression
    (``"fwd<float>"``) whose mangled symbol NVRTC reports after the
    compile. Raises :class:`MXNetError` with NVRTC's log when the source
    does not compile."""
    lib = _open_nvrtc()
    prog = ctypes.c_void_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for e in exports:
            _nvrtc_check(lib, lib.nvrtcAddNameExpression(prog, e.encode()),
                         f"nvrtcAddNameExpression({e!r})")
        opts = _cstrings(list(options))
        rc = lib.nvrtcCompileProgram(prog, len(options), opts)
        size = ctypes.c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetProgramLogSize(prog,
                                                     ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetProgramLog(prog, buf),
                     "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        if rc == _NVRTC_ERROR_COMPILATION:
            raise MXNetError(f"NVRTC could not compile {name!r} with "
                             f"{list(options)}:\n{log}")
        _nvrtc_check(lib, rc, "nvrtcCompileProgram")
        lowered = {}
        for e in exports:
            out = ctypes.c_char_p()
            _nvrtc_check(lib, lib.nvrtcGetLoweredName(prog, e.encode(),
                                                      ctypes.byref(out)),
                         f"nvrtcGetLoweredName({e!r})")
            lowered[e] = out.value.decode()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


class Driver:
    """The CUDA driver API calls the launcher needs, on ``libcuda.so.1``.
    One instance per process (:meth:`get`)."""

    def __init__(self):
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError(f"rtc needs the CUDA driver (libcuda.so.1): "
                             f"{e}") from None
        P, U, I = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int
        sigs = {
            "cuInit": ([U], I),
            "cuGetErrorName": ([I, ctypes.POINTER(ctypes.c_char_p)], I),
            "cuGetErrorString": ([I, ctypes.POINTER(ctypes.c_char_p)], I),
            "cuDeviceGet": ([ctypes.POINTER(I), I], I),
            "cuDevicePrimaryCtxRetain": ([ctypes.POINTER(P), I], I),
            "cuCtxGetCurrent": ([ctypes.POINTER(P)], I),
            "cuCtxSetCurrent": ([P], I),
            "cuModuleLoadData": ([ctypes.POINTER(P), P], I),
            "cuModuleGetFunction": ([ctypes.POINTER(P), P, ctypes.c_char_p],
                                    I),
            "cuFuncSetAttribute": ([P, I, I], I),
            "cuLaunchKernel": ([P, U, U, U, U, U, U, U, P,
                                ctypes.POINTER(P), ctypes.POINTER(P)], I),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        self._lib = lib
        self._ctx = {}  # device ordinal -> primary CUcontext
        self.check(lib.cuInit(0), "cuInit")

    @classmethod
    def get(cls):
        global _DRIVER
        with _LOCK:
            if _DRIVER is None:
                _DRIVER = cls()
            return _DRIVER

    def check(self, rc, what):
        if rc != _CUDA_SUCCESS:
            name, text = ctypes.c_char_p(), ctypes.c_char_p()
            self._lib.cuGetErrorName(rc, ctypes.byref(name))
            self._lib.cuGetErrorString(rc, ctypes.byref(text))
            raise MXNetError(
                f"{what} failed: CUresult {rc} "
                f"({(name.value or b'?').decode()}: "
                f"{(text.value or b'?').decode()})")

    def make_current(self, ordinal):
        """Make the device's primary context (the one torch's runtime
        uses) current in the calling thread; a thread that never touched
        CUDA has none."""
        lib = self._lib
        ctx = self._ctx.get(ordinal)
        if ctx is None:
            with _LOCK:  # retain once per device
                ctx = self._ctx.get(ordinal)
                if ctx is None:
                    dev = ctypes.c_int()
                    self.check(lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                               "cuDeviceGet")
                    ctx = ctypes.c_void_p()
                    self.check(lib.cuDevicePrimaryCtxRetain(
                        ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
                    self._ctx[ordinal] = ctx
        cur = ctypes.c_void_p()
        self.check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
        if cur.value != ctx.value:
            self.check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")

    def load_module(self, cubin):
        mod = ctypes.c_void_p()
        image = ctypes.create_string_buffer(cubin, len(cubin))
        self.check(self._lib.cuModuleLoadData(
            ctypes.byref(mod), ctypes.cast(image, ctypes.c_void_p)),
            "cuModuleLoadData")
        return mod

    def get_function(self, module, name):
        fn = ctypes.c_void_p()
        self.check(self._lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                                 name.encode()),
                   f"cuModuleGetFunction({name!r})")
        return fn

    def set_max_dynamic_shared(self, fn, nbytes):
        self.check(self._lib.cuFuncSetAttribute(
            fn, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
            "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")

    def launch(self, fn, grid, block, shared_mem, stream, params):
        self.check(self._lib.cuLaunchKernel(
            fn, grid[0], grid[1], grid[2], block[0], block[1], block[2],
            shared_mem, ctypes.c_void_p(stream), params, None),
            "cuLaunchKernel")
