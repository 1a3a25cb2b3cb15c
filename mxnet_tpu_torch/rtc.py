"""User-written CUDA kernels compiled at run time: K4, ``rtc.CudaModule``.

The PyTorch/CUDA counterpart of ``mxnet_tpu/rtc.py`` (reference:
python/mxnet/rtc.py ``CudaModule``/``CudaKernel`` over
src/common/rtc.cc). The JAX package maps a user's Pallas kernel over a
grid (``PallasModule``, ``_Kernel.launch`` at ``rtc.py:19-50``, Mosaic in
NVRTC's place); on the card the user writes CUDA C++ again, as MXNet's
users do:

    mod = rtc.CudaModule(r'''
        extern "C" __global__ void axpy(const float* x, float* y,
                                        float a, int n) {
            int i = blockIdx.x * blockDim.x + threadIdx.x;
            if (i < n) y[i] += a * x[i];
        }''')
    k = mod.get_kernel("axpy", "const float* x, float* y, float a, int n")
    k.launch([x, y, 2.0, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
             (256, 1, 1))

- The source is compiled once, when the module is made, by NVRTC for
  ``sm_90a`` (``--gpu-architecture=sm_90a``, then ``options``), to a
  CUBIN. A compile error raises :class:`MXNetError` holding NVRTC's log.
- ``exports`` names C++ kernels (``"fwd<float>"``, overloads, namespaces)
  by their source names; NVRTC reports each one's mangled symbol
  (``nvrtcAddNameExpression``/``nvrtcGetLoweredName``) and
  ``get_kernel`` takes the source name. An ``extern "C"`` kernel needs
  no export.
- ``get_kernel(name, signature)`` parses the C signature into pointer
  and scalar arguments, as MXNet does: ``(const) type (*) (name)``
  separated by commas, with ``type`` one of ``float``, ``double``,
  ``__half``, ``__nv_bfloat16``, ``uint8_t``, ``int8_t``/``char``,
  ``int``/``int32_t``, ``int64_t``.
- ``launch(args, ctx, grid_dims, block_dims, shared_mem=0)`` takes an
  NDArray (or a tensor) of the matching dtype for each pointer and a
  Python number for each scalar, checks them (dtype, device, contiguity,
  count), loads the CUBIN into the device's context once
  (``cuModuleLoadData``), raises the kernel's dynamic shared-memory
  limit when ``shared_mem`` exceeds 48 KB, and launches
  (``cuLaunchKernel``) on torch's current stream of that device, so the
  kernel is ordered with torch's work on either side. A non-``const``
  pointer is the kernel's to write, in place. It returns None and does
  not synchronize. A CPU ``ctx``, a tensor off the card, and any driver
  error raise :class:`MXNetError`; nothing runs elsewhere instead.
- Each launch counts one under the kernel's name
  (``kernels._build.count_launch``).

On the H100 machine the launcher found libnvrtc in the CUDA toolkit's
``/usr/local/cuda/lib64`` (``_nvrtc.nvrtc_path()``, which
``chip_smoke.py`` prints). ``PallasModule`` has no meaning on the card
and raises, pointing here, as the JAX package's ``CudaModule`` does on
the TPU.
"""
from __future__ import annotations

import ctypes
import os
import re
import threading

import numpy as onp
import torch

from .base import MXNetError
from .context import Context
from .kernels import _build, _nvrtc
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "ARCH"]

ARCH = "sm_90a"
# the largest dynamic shared memory a kernel gets without opting in
_DEFAULT_SHARED = 48 * 1024

# C type of a kernel argument -> torch dtype (reference: rtc.py
# _DTYPE_CPP_TO_NP, plus __nv_bfloat16)
_DTYPES = {
    "float": torch.float32, "double": torch.float64, "__half": torch.float16,
    "__nv_bfloat16": torch.bfloat16, "uint8_t": torch.uint8,
    "int8_t": torch.int8, "char": torch.int8, "int": torch.int32,
    "int32_t": torch.int32, "int64_t": torch.int64,
}
# a scalar argument's C representation
_CSCALAR = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
            torch.uint8: ctypes.c_uint8, torch.int8: ctypes.c_int8,
            torch.int32: ctypes.c_int32, torch.int64: ctypes.c_int64}
_NUMBER = (int, float, onp.integer, onp.floating)
_ARG_RE = re.compile(
    r"^\s*(const)?\s*([A-Za-z_]\w*)\s*(\*)?\s*(?:__restrict__)?\s*"
    r"([A-Za-z_]\w*)?\s*$")


class _Arg:
    __slots__ = ("pointer", "const", "ctype", "dtype")

    def __init__(self, pointer, const, ctype):
        self.pointer, self.const, self.ctype = pointer, const, ctype
        self.dtype = _DTYPES[ctype]

    def __repr__(self):
        return (f"{'const ' if self.const else ''}{self.ctype}"
                f"{'*' if self.pointer else ''}")


def parse_signature(signature):
    """The kernel's arguments from its C signature, as ``_Arg``s
    (pointer?, const?, C type, torch dtype). Raises :class:`MXNetError`
    on a malformed argument or an unsupported type."""
    text = re.sub(r"\s+", " ", signature).strip()
    if not text:
        return []
    out = []
    for arg in text.split(","):
        m = _ARG_RE.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(f"invalid kernel argument {arg.strip()!r}: must "
                             "be of the form '(const) type (*) (name)'")
        if m.group(2) not in _DTYPES:
            raise MXNetError(f"unsupported kernel argument type in "
                             f"{arg.strip()!r}; supported: "
                             f"{', '.join(_DTYPES)}")
        out.append(_Arg(bool(m.group(3)), bool(m.group(1)), m.group(2)))
    return out


def _include_options():
    """The toolkit's headers (``cuda_fp16.h`` and the like), where present."""
    inc = os.path.join(_nvrtc.cuda_home(), "include")
    return (f"--include-path={inc}",) if os.path.isdir(inc) else ()


class CudaModule:
    """CUDA C++ source compiled by NVRTC for ``sm_90a`` (reference:
    rtc.py CudaModule). See the module docstring."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.exports = tuple(exports)
        self.options = (f"--gpu-architecture={ARCH}",) + \
            _include_options() + tuple(options)
        self._cubin, self._lowered, self.log = _nvrtc.compile_cubin(
            source, "rtc_module.cu", self.options, self.exports)
        self._lock = threading.Lock()
        self._loaded = {}  # device ordinal -> CUmodule
        self._functions = {}  # (ordinal, name) -> CUfunction

    def get_kernel(self, name, signature):
        """The kernel ``name`` (a source name from ``exports``, or an
        ``extern "C"`` name) taking the arguments ``signature`` declares
        (reference: rtc.py CudaModule.get_kernel)."""
        return CudaKernel(self, name, signature)

    def _function(self, ordinal, name):
        """The CUfunction of ``name`` in the device's context, loading
        the module there first (once per device). The context must be
        current."""
        key = (ordinal, name)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                drv = _nvrtc.Driver.get()
                mod = self._loaded.get(ordinal)
                if mod is None:
                    mod = self._loaded[ordinal] = drv.load_module(self._cubin)
                fn = drv.get_function(mod, self._lowered.get(name, name))
                self._functions[key] = fn
            return fn


class CudaKernel:
    """One kernel of a :class:`CudaModule` (reference: rtc.py
    CudaKernel)."""

    def __init__(self, module, name, signature):
        self._module = module
        self.name = name
        self.signature = signature
        self.args = parse_signature(signature)
        self._shared_set = {}  # ordinal -> dynamic shared bytes allowed
        self._devices = {}  # gpu ordinal -> torch.device

    def _device(self, ctx):
        if isinstance(ctx, Context):
            if ctx.device_type != "gpu":
                raise MXNetError(f"CudaKernel {self.name!r}: a CUDA kernel "
                                 f"launches on a GPU context, got {ctx}")
            dev = self._devices.get(ctx.device_id)
            if dev is None:  # checked against the host's devices once
                dev = self._devices[ctx.device_id] = ctx.torch_device
            return dev
        raise MXNetError(f"CudaKernel {self.name!r}: ctx must be a Context "
                         f"such as mx.gpu(0), got {ctx!r}")

    def _params(self, args, device):
        """Check ``args`` against the signature; returns the values to
        pass (kept alive by the caller) and the ``void*[]`` of their
        addresses."""
        if len(args) != len(self.args):
            raise MXNetError(f"CudaKernel {self.name!r} takes "
                             f"{len(self.args)} arguments ({self.signature}), "
                             f"got {len(args)}")
        holders = []
        params = (ctypes.c_void_p * max(len(args), 1))()
        for i, (spec, a) in enumerate(zip(self.args, args)):
            if spec.pointer:
                t = a.data if isinstance(a, NDArray) else a
                if not isinstance(t, torch.Tensor):
                    raise MXNetError(
                        f"CudaKernel {self.name!r}: argument {i} ({spec!r}) "
                        f"takes an NDArray, got {type(a).__name__}")
                if t.dtype != spec.dtype:
                    raise MXNetError(
                        f"CudaKernel {self.name!r}: argument {i} ({spec!r}) "
                        f"takes {spec.dtype}, got {t.dtype}")
                if t.device != device:
                    raise MXNetError(
                        f"CudaKernel {self.name!r}: argument {i} lies on "
                        f"{t.device}, the launch is on {device}")
                if not t.is_contiguous():
                    raise MXNetError(
                        f"CudaKernel {self.name!r}: argument {i} is not "
                        "contiguous; the kernel reads raw memory")
                h = ctypes.c_void_p(t.data_ptr())
                params[i] = ctypes.addressof(h)
            else:
                if not isinstance(a, _NUMBER) or isinstance(a, bool):
                    raise MXNetError(
                        f"CudaKernel {self.name!r}: argument {i} ({spec!r}) "
                        f"takes a number, got {type(a).__name__}")
                if spec.dtype in _CSCALAR:
                    try:
                        h = _CSCALAR[spec.dtype](a)
                    except TypeError:  # a float for an integer argument
                        raise MXNetError(
                            f"CudaKernel {self.name!r}: argument {i} "
                            f"({spec!r}) takes an integer, got {a!r}"
                        ) from None
                else:  # __half, __nv_bfloat16: their 16 bits
                    h = ctypes.c_uint16(torch.tensor(
                        a, dtype=spec.dtype).view(torch.int16).item()
                        & 0xFFFF)
                params[i] = ctypes.addressof(h)
            holders.append(h)
        return holders, params

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx``'s current torch stream over ``grid_dims``
        blocks of ``block_dims`` threads (3-tuples) with ``shared_mem``
        bytes of dynamic shared memory; returns None (reference: rtc.py
        CudaKernel.launch)."""
        device = self._device(ctx)
        dims = []
        for what, d in (("grid_dims", grid_dims), ("block_dims", block_dims)):
            d = tuple(d)
            if len(d) != 3 or not all(isinstance(x, (int, onp.integer))
                                      and x > 0 for x in d):
                raise MXNetError(f"CudaKernel {self.name!r}: {what} must be "
                                 f"3 positive integers, got {d}")
            dims.append(d)
        holders, params = self._params(args, device)
        ordinal = device.index
        stream = torch.cuda.current_stream(device).cuda_stream
        drv = _nvrtc.Driver.get()
        drv.make_current(ordinal)
        fn = self._module._function(ordinal, self.name)
        shared_mem = int(shared_mem)
        if shared_mem > max(_DEFAULT_SHARED,
                            self._shared_set.get(ordinal, 0)):
            drv.set_max_dynamic_shared(fn, shared_mem)
            self._shared_set[ordinal] = shared_mem
        drv.launch(fn, dims[0], dims[1], shared_mem, stream, params)
        _build.count_launch(self.name)
        del holders  # the driver copied the argument values at launch
        return None


def PallasModule(*args, **kwargs):
    """The JAX package's runtime-kernel module maps Pallas kernels; on the
    card the runtime compiler is NVRTC (reference: the JAX package's
    rtc.py PallasModule)."""
    raise NotImplementedError(
        "Pallas kernels run on the TPU; on the GPU write the kernel in CUDA "
        "C++ and compile it with mxnet_tpu_torch.rtc.CudaModule instead")
