"""K4's launcher, ``rtc.CudaModule``, on a host with no GPU.

What runs here: the C signature parsing (pointer and scalar arguments,
``const``, every supported C type and its dtype), the argument checks a
launch makes before it touches the driver (count, dtype, device,
contiguity, number or array), and the failure paths: no libnvrtc means
``MXNetError``, a CPU context or a host without a card raises, and the
port's ``PallasModule`` raises as the JAX package's ``CudaModule`` does
(each package points to the other's form of the runtime compiler).
Compiling and launching are card-only cases in ``test_torch_cuda.py``.
"""
import ctypes

import numpy as onp
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu import rtc as jrtc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.kernels import _nvrtc


@pytest.mark.parametrize("ctype,dtype", [
    ("float", torch.float32), ("double", torch.float64),
    ("__half", torch.float16), ("__nv_bfloat16", torch.bfloat16),
    ("uint8_t", torch.uint8), ("int8_t", torch.int8), ("char", torch.int8),
    ("int", torch.int32), ("int32_t", torch.int32), ("int64_t", torch.int64)])
def test_every_c_type_maps_to_its_dtype(ctype, dtype):
    args = rtc.parse_signature(f"const {ctype}* x, {ctype} *y, {ctype} a, "
                               f"const {ctype} b")
    assert [(a.pointer, a.const, a.ctype, a.dtype) for a in args] == [
        (True, True, ctype, dtype), (True, False, ctype, dtype),
        (False, False, ctype, dtype), (False, True, ctype, dtype)]


def test_signature_forms_as_mxnet_reads_them():
    # names are optional, whitespace free, __restrict__ allowed
    args = rtc.parse_signature("const float*,float*  __restrict__ out,\n"
                               "  int")
    assert [repr(a) for a in args] == ["const float*", "float*", "int"]
    assert rtc.parse_signature("   ") == []


@pytest.mark.parametrize("bad", ["const const float* x", "float x y",
                                 "float** x", "float* x,", "*x"])
def test_malformed_signature_raises(bad):
    with pytest.raises(mx.MXNetError, match="invalid kernel argument"):
        rtc.parse_signature(bad)


@pytest.mark.parametrize("bad", ["unsigned x", "float4* x", "void* p",
                                 "bool flag"])
def test_unsupported_type_raises(bad):
    with pytest.raises(mx.MXNetError, match="unsupported kernel argument"):
        rtc.parse_signature(bad)


def _kernel(sig="const float* x, float* y, float a, int n"):
    # a kernel object needs no compiled module until it launches
    return rtc.CudaKernel(None, "axpy", sig)


def test_argument_checks_before_the_driver():
    k = _kernel()
    dev = torch.device("cpu")
    x = torch.zeros(8)
    holders, params = k._params([mx.nd.NDArray(x), x, 2.0, 8], dev)
    assert len(holders) == 4 and params[0] and params[3]
    checks = [
        ([x, x, 2.0], "takes 4 arguments"),
        ([x.double(), x, 2.0, 8], "float64"),
        ([x, torch.zeros(8, dtype=torch.int32), 2.0, 8], "int32"),
        ([torch.zeros(8, 2)[:, 0], x, 2.0, 8], "contiguous"),
        ([x, x, x, 8], "takes a number"),
        ([x, x, 2.0, mx.nd.NDArray(x)], "takes a number"),
        ([onp.zeros(8, "f"), x, 2.0, 8], "takes an NDArray"),
        ([x, torch.zeros(8, device="meta"), 2.0, 8], "lies on meta"),
    ]
    for args, msg in checks:
        with pytest.raises(mx.MXNetError, match=msg):
            k._params(args, dev)


def test_scalar_arguments_are_passed_as_their_c_type():
    k = _kernel("double a, int8_t b, int64_t c, __half d, __nv_bfloat16 e")
    holders, _ = k._params([0.1, -3, 2 ** 40, 1.5, 2.5], torch.device("cpu"))
    assert [type(h) for h in holders] == [
        ctypes.c_double, ctypes.c_int8, ctypes.c_int64, ctypes.c_uint16,
        ctypes.c_uint16]
    assert [h.value for h in holders] == [
        0.1, -3, 2 ** 40,
        0x3E00,  # 1.5 in float16 bits
        0x4020]  # 2.5 in bfloat16 bits
    with pytest.raises(mx.MXNetError, match="takes a number"):
        k._params([True, -3, 2, 1.5, 2.5], torch.device("cpu"))
    with pytest.raises(mx.MXNetError, match="takes an integer"):
        k._params([0.1, -3.5, 2, 1.5, 2.5], torch.device("cpu"))


def test_launch_refuses_a_cpu_context_and_bad_dims():
    k = _kernel()
    x = torch.zeros(8)
    with pytest.raises(mx.MXNetError, match="GPU context"):
        k.launch([x, x, 1.0, 8], mx.cpu(), (1, 1, 1), (8, 1, 1))
    with pytest.raises(mx.MXNetError, match="Context"):
        k.launch([x, x, 1.0, 8], "gpu", (1, 1, 1), (8, 1, 1))
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="CUDA"):
            k.launch([x, x, 1.0, 8], mx.gpu(0), (1, 1, 1), (8, 1, 1))


def test_launch_dims_are_three_positive_ints(monkeypatch):
    k = _kernel()
    monkeypatch.setattr(k, "_device", lambda ctx: torch.device("cpu"))
    x = torch.zeros(8)
    for grid, block in [((1, 1), (8, 1, 1)), ((1, 1, 1), (0, 1, 1)),
                        ((1, 1, 1), (8.0, 1, 1))]:
        with pytest.raises(mx.MXNetError, match="3 positive integers"):
            k.launch([x, x, 1.0, 8], mx.gpu(0), grid, block)


def test_no_nvrtc_raises_mxnet_error(tmp_path, monkeypatch):
    monkeypatch.setattr(_nvrtc, "_NVRTC", None)
    monkeypatch.setattr(_nvrtc, "_nvrtc_candidates",
                        lambda: [str(tmp_path / "libnvrtc.so.12")])
    with pytest.raises(mx.MXNetError, match="no libnvrtc could be loaded"):
        rtc.CudaModule('extern "C" __global__ void f() {}')


def test_candidates_search_the_toolkit_first(tmp_path, monkeypatch):
    lib = tmp_path / "lib64"
    lib.mkdir()
    for name in ("libnvrtc.so.12", "libnvrtc-builtins.so.12.4"):
        (lib / name).write_bytes(b"")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    found = _nvrtc._nvrtc_candidates()
    assert found[0] == str(lib / "libnvrtc.so.12")
    assert found[-1] == "libnvrtc.so"
    assert not any("builtins" in f for f in found)


def test_no_driver_raises_mxnet_error(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks a host without the CUDA driver")
    monkeypatch.setattr(_nvrtc, "_DRIVER", None)
    with pytest.raises(mx.MXNetError, match="libcuda"):
        _nvrtc.Driver.get()


def test_each_package_points_to_its_own_runtime_compiler():
    """The JAX package's CudaModule raises (Pallas on the TPU); the
    port's PallasModule raises (CUDA C on the GPU). The JAX package's
    PallasModule still runs its kernel (interpret mode on the CPU)."""
    with pytest.raises(NotImplementedError, match="PallasModule"):
        jrtc.CudaModule("__global__ void f(){}")
    with pytest.raises(NotImplementedError, match="CudaModule"):
        rtc.PallasModule(double=lambda x_ref, o_ref: None)

    def double_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    x = onp.random.RandomState(0).randn(64).astype("f")
    out = jrtc.PallasModule(double=double_kernel).get_kernel(
        "double").launch([jnd.array(x)]).asnumpy()
    assert onp.array_equal(out, x * 2)
