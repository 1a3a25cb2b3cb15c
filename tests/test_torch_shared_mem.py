"""The port's shared-memory NDArrays (``ctx=Context("cpu_shared")``)
against the JAX package's on the CPU: the dtype rules of
``nd.array(..., ctx=cpu_shared)``, pickling by segment name, and writes
that another process sees, both ways. Values are compared exactly.
"""
import os
import pickle
import subprocess
import sys

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ndarray.shared_mem import (SharedNDArray, shared_empty,
                                                to_shared)

SHARED = mx.Context("cpu_shared")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("source,dtype", [
    ([1, 2, 3], None), ([[1.5, 2.5]], None), (onp.arange(4.0), None),
    (onp.arange(6, dtype="int32").reshape(2, 3), None),
    (onp.arange(4, dtype="int64"), None), (onp.ones(3), "float16"),
    ([1, 2], "int32")])
def test_array_on_cpu_shared_follows_the_jax_dtype_rules(source, dtype):
    t = nd.array(source, ctx=SHARED, dtype=dtype)
    j = jnd.array(source, ctx=jmx.Context("cpu_shared"), dtype=dtype)
    assert isinstance(t, SharedNDArray)
    assert t.context == SHARED and t.ctx == SHARED
    assert str(t.context) == str(j.context) == "cpu_shared(0)"
    assert t.dtype == j.dtype and t.shape == j.shape
    onp.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_from_an_ndarray_and_to_shared_keep_values():
    src = nd.array(onp.arange(6.0, dtype="f").reshape(2, 3), ctx=mx.cpu())
    t = nd.array(src, ctx=SHARED)
    onp.testing.assert_array_equal(t.asnumpy(), src.asnumpy())
    assert to_shared(t) is t
    s = to_shared(onp.arange(3.0))  # numpy's dtype, as the JAX one keeps
    assert s.dtype == onp.float64
    e = shared_empty((0, 2))
    assert e.shape == (0, 2) and e.asnumpy().shape == (0, 2)


def test_pickle_sends_the_segment_name_and_writes_are_shared():
    t = nd.array(onp.zeros((2, 3), "f"), ctx=SHARED)
    blob = pickle.dumps(t)
    assert len(blob) < 300  # a name and a shape, not the bytes
    back = pickle.loads(blob)
    assert back.shm_name == t.shm_name
    back[0, 1] = 7.0
    t += 1.0  # in place, into the segment
    onp.testing.assert_array_equal(back.asnumpy(),
                                   [[1, 8, 1], [1, 1, 1]])
    # an op's result is an ordinary array
    r = t * 2
    assert not isinstance(r, SharedNDArray)


CHILD = r"""
import pickle, sys
import numpy as onp
arr = pickle.loads(open(sys.argv[1], "rb").read())
seen = arr.asnumpy().tolist()
arr[1] = onp.array([5.0, 6.0, 7.0], "f")
print(repr(seen))
"""


def test_another_process_sees_and_writes_the_segment(tmp_path):
    t = nd.array(onp.arange(6, dtype="f").reshape(2, 3), ctx=SHARED)
    (tmp_path / "arr.pkl").write_bytes(pickle.dumps(t))
    env = dict(os.environ, PYTHONPATH=REPO)
    for _ in range(2):  # the segment outlives an attached process
        proc = subprocess.run(
            [sys.executable, "-c", "import mxnet_tpu_torch\n" + CHILD,
             str(tmp_path / "arr.pkl")],
            capture_output=True, text=True, timeout=120, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "leaked" not in proc.stderr
        t[0, 0] = 9.0
    assert eval(proc.stdout.strip()) == [[9.0, 1.0, 2.0], [5.0, 6.0, 7.0]]
    onp.testing.assert_array_equal(t.asnumpy(),
                                   [[9, 1, 2], [5, 6, 7]])
