"""The port's sparse storage types against the JAX package on the CPU.

Every case of ``tests/test_sparse.py`` and ``tests/test_sparse2.py``
(parametrized where they repeat), the index dtypes of every
constructor, ``retain`` with duplicate, missing and empty ids, the lazy
SGD, Adam and GroupAdaGrad rows, the store's sparse push, pull and
``row_sparse_pull``, the Trainer's per-tensor sparse path, the dense
gradient of ``SparseEmbedding`` and ``Embedding(sparse_grad=True)``, and
the sparse push across two processes, which the port refuses.

Inputs come from numpy seeds; the port's sparse arrays are carried from
the JAX package's components by ``convert.sparse_from_numpy``. Bounds:
index arrays, ``nnz`` and storage layouts equal; values equal where
both packages copy or gather them; sums (``dot``, the merged rows, the
optimizer updates) within rtol 1e-6 (one float32 rounding apart at
most, as both add in the same order on the CPU); the networks' weights
and gradients within rtol 1e-5, atol 1e-7.
"""
import os
import pickle
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu import test_utils as jtu

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as sp
from mxnet_tpu_torch import test_utils as ttu

CPU = mx.cpu()
SUM_TOL = 1e-6
NET_RTOL, NET_ATOL = 1e-5, 1e-7


def _t(a):
    return nd.array(a, ctx=CPU)


def dense_rand(shape, density=0.3, seed=0):
    """``tests/test_sparse.py``'s generator."""
    rs = onp.random.RandomState(seed)
    arr = rs.rand(*shape).astype(onp.float32)
    return arr * (rs.rand(*shape) < density)


def dense_with_zeros(shape, density=0.4, seed=0):
    """``tests/test_sparse2.py``'s generator."""
    rs = onp.random.RandomState(seed)
    x = rs.randn(*shape).astype("f")
    return onp.where(rs.rand(*shape) < density, x, 0.0).astype("f")


def _carry(j):
    """The port's array of a JAX sparse array, from its components."""
    if j.stype == "csr":
        parts = (j.data.asnumpy(), j.indices.asnumpy(), j.indptr.asnumpy())
    else:
        parts = (j.data.asnumpy(), j.indices.asnumpy())
    return convert.sparse_from_numpy(j.stype, parts, j.shape, ctx=CPU)


def _same_layout(t, j):
    """The port's sparse array stores what the JAX one stores."""
    assert t.stype == j.stype and t.shape == j.shape and t.nnz == j.nnz
    onp.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    assert t.indices.asnumpy().dtype == j.indices.asnumpy().dtype
    if j.stype == "csr":
        onp.testing.assert_array_equal(t.indptr.asnumpy(),
                                       j.indptr.asnumpy())
        assert t.indptr.asnumpy().dtype == j.indptr.asnumpy().dtype
    onp.testing.assert_array_equal(t.data.asnumpy(), j.data.asnumpy())
    assert t.dtype == j.dtype


# -- storage, conversion and construction -------------------------------------

_DENSES = {
    "sparse_6x8": lambda: dense_rand((6, 8)),
    "sparse2_6x5": lambda: dense_with_zeros((6, 5)),
    "sparse2_8x3": lambda: dense_with_zeros((8, 3), density=0.3, seed=1),
    "rows_2_5": lambda: onp.array([[0, 0, 0]] * 2 + [[1, 2, 3]] +
                                  [[0, 0, 0]] * 2 + [[4, 5, 6]] +
                                  [[0, 0, 0]] * 2, "f"),
    "all_zero": lambda: onp.zeros((3, 4), "f"),
}


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
@pytest.mark.parametrize("case", sorted(_DENSES))
def test_cast_storage_roundtrip_matches_jax(case, stype):
    d = _DENSES[case]()
    j = jsp.cast_storage(jnd.array(d), stype)
    t = sp.cast_storage(_t(d), stype)
    _same_layout(t, j)
    onp.testing.assert_array_equal(t.asnumpy(), d)
    back = t.tostype("default")
    assert back.stype == "default" and type(back) is mx.nd.NDArray
    onp.testing.assert_array_equal(back.asnumpy(), d)
    via = _t(d).tostype(stype)
    _same_layout(via, j)
    assert via.context == CPU
    if stype == "row_sparse":
        # only the rows with a non-zero are stored, in order
        nz = onp.nonzero((d != 0).any(axis=1))[0]
        assert t.indices.asnumpy().tolist() == nz.tolist()


def _constructors():
    data, indices, indptr = [1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 2, 3]
    comp = (onp.array([1.0, 2.0, 3.0], "f"), onp.array([0, 2, 1], "i8"),
            onp.array([0, 2, 3], "i8"))
    rvals = onp.array([[1.0, 2.0], [3.0, 4.0]], "f")
    return {
        "csr_lists": lambda s, **k: s.csr_matrix(
            (data, indices, indptr), shape=(3, 4), **k),
        "csr_int64_components": lambda s, **k: s.csr_matrix(
            comp, shape=(2, 3), **k),
        "csr_float64_values": lambda s, **k: s.csr_matrix(
            (onp.array(data), onp.array(indices), onp.array(indptr)),
            shape=(3, 4), **k),
        "csr_dense": lambda s, **k: s.csr_matrix(dense_rand((4, 5)), **k),
        "rsp_lists": lambda s, **k: s.row_sparse_array(
            ([[1.0, 2.0], [3.0, 4.0]], [1, 3]), shape=(5, 2), **k),
        "rsp_int64_components": lambda s, **k: s.row_sparse_array(
            (rvals, onp.array([1, 3], "i8")), shape=(5, 2), **k),
        "rsp_dense": lambda s, **k: s.row_sparse_array(
            dense_with_zeros((6, 3), seed=3), **k),
        "zeros_csr": lambda s, **k: s.zeros("csr", (3, 4), **k),
        "zeros_rsp": lambda s, **k: s.zeros("row_sparse", (3, 4), **k),
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructors_and_index_dtypes_match_jax(name):
    make = _constructors()[name]
    j = make(jsp)
    t = make(sp, ctx=CPU)
    _same_layout(t, j)
    onp.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    # the index arrays are int32 in both packages
    assert t.indices.asnumpy().dtype == onp.int32
    if t.stype == "csr":
        assert t.indptr.asnumpy().dtype == onp.int32


def test_csr_accessors_mirror_the_reference():
    t = sp.csr_matrix(([1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 2, 3]),
                      shape=(3, 4), ctx=CPU)
    assert t.indices.asnumpy().tolist() == [0, 2, 1]
    assert t.indptr.asnumpy().tolist() == [0, 2, 2, 3]
    assert t.data.asnumpy().tolist() == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="shape"):
        sp.csr_matrix(([1.0], [0], [0, 1]), ctx=CPU)
    with pytest.raises(ValueError, match="2-D"):
        sp.CSRNDArray(torch.ones(1), [0], [0, 1], (1, 2, 3))


def test_sparse_zeros_and_tostype_identity():
    for s, kw in ((jsp, {}), (sp, {"ctx": CPU})):
        z = s.zeros("csr", (3, 4), **kw)
        assert z.stype == "csr" and z.nnz == 0 and z.shape == (3, 4)
        assert z.tostype("csr") is z
        assert z.tostype("default").stype == "default"
        onp.testing.assert_array_equal(z.asnumpy(), onp.zeros((3, 4)))
        d = s.zeros("default", (2, 2), **kw)
        assert d.stype == "default" and d.shape == (2, 2)


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    with pytest.raises(MXNetError, match="CUDA"):
        sp.zeros("csr", (2, 2))
    with pytest.raises(MXNetError, match="CUDA"):
        sp.csr_matrix(([1.0], [0], [0, 1]), shape=(1, 2))
    with pytest.raises(MXNetError, match="CUDA"):
        sp.row_sparse_array(onp.ones((2, 2), "f"))


def test_cast_storage_refuses_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(MXNetError, match="CUDA graph capture"):
        _t(dense_rand((3, 3))).tostype("csr")
    with pytest.raises(MXNetError, match="CUDA graph capture"):
        _t(dense_rand((3, 3))).tostype("row_sparse")


def test_csr_row_slicing_matches_jax():
    x = dense_with_zeros((6, 4), seed=9)
    j = jsp.cast_storage(jnd.array(x), "csr")
    t = sp.cast_storage(_t(x), "csr")
    _same_layout(t[2:5], j[2:5])
    onp.testing.assert_array_equal(t[2:5].asnumpy(), x[2:5])
    onp.testing.assert_array_equal(t[1].asnumpy(), x[1])
    onp.testing.assert_array_equal(t[1].asnumpy(), j[1].asnumpy())


def test_copy_copyto_and_context_keep_the_format():
    x = dense_with_zeros((4, 4), seed=10)
    j = jsp.cast_storage(jnd.array(x), "csr")
    t = _carry(j)
    c = t.copy()
    assert c.stype == "csr" and c is not t
    _same_layout(c, j)
    c._data.add_(1.0)  # a deep copy: the original keeps its values
    _same_layout(t, j)
    dst = nd.zeros((4, 4), ctx=CPU)
    buf = dst.data
    assert t.copyto(dst) is dst and dst.data is buf  # written in place
    onp.testing.assert_array_equal(dst.asnumpy(), x)
    assert t.as_in_context(CPU) is t
    r = jsp.row_sparse_array(([[1.0, 1.0]], [2]), shape=(4, 2))
    rc = _carry(r).copy()
    assert rc.stype == "row_sparse" and rc.shape == (4, 2)
    h = t.astype("float16")
    assert h.stype == "csr" and h.dtype == onp.float16
    onp.testing.assert_array_equal(h.indices.asnumpy(), j.indices.asnumpy())


@pytest.mark.parametrize("what", ["getitem_pair", "setitem", "setitem_pair",
                                  "arithmetic"])
def test_unsupported_ops_raise(what):
    csr = sp.zeros("csr", (2, 2), ctx=CPU)
    with pytest.raises(MXNetError):
        if what == "getitem_pair":
            csr[0, 1]
        elif what == "setitem":
            csr[0] = 1.0
        elif what == "setitem_pair":
            csr[0, 0] = 1.0
        else:
            csr + 1.0


# -- dot ----------------------------------------------------------------------

_DOTS = {
    # (lhs shape, lhs maker seed, rhs shape, rhs seed, transpose_a, _b)
    "sparse_csr_dense": ((5, 7), 1, (7, 4), 2, False, False),
    "sparse_transpose_a": ((5, 7), 1, (5, 4), 3, True, False),
    "sparse_transpose_b": ((2, 3), 7, (4, 3), 8, False, True),
    "sparse2_csr_dense": ((4, 6), 2, (6, 5), 3, False, False),
    "sparse2_transpose_a": ((4, 6), 4, (4, 3), 5, True, False),
    "jit_static_nnz": ((4, 6), 5, (6, 3), 6, False, False),
}


@pytest.mark.parametrize("case", sorted(_DOTS))
def test_dot_matches_jax(case):
    ls, lseed, rshape, rseed, ta, tb = _DOTS[case]
    d = dense_rand(ls, seed=lseed)
    w = onp.random.RandomState(rseed).rand(*rshape).astype("f")
    j = jsp.dot(jsp.cast_storage(jnd.array(d), "csr"), jnd.array(w),
                transpose_a=ta, transpose_b=tb).asnumpy()
    t = sp.dot(sp.cast_storage(_t(d), "csr"), _t(w), transpose_a=ta,
               transpose_b=tb)
    assert t.stype == "default" and t.context == CPU
    onp.testing.assert_allclose(t.asnumpy(), j, rtol=SUM_TOL, atol=1e-7)
    a = d.T if ta else d
    b = w.T if tb else w
    onp.testing.assert_allclose(t.asnumpy(), a @ b, rtol=1e-5, atol=1e-6)


def test_dot_on_a_csr_built_from_components():
    """``test_sparse_dot_in_jit``: a CSR made from its components (there
    under ``jax.jit``) multiplies as the cast one does."""
    d = dense_rand((4, 6), seed=5)
    j = jsp.cast_storage(jnd.array(d), "csr")
    w = onp.random.RandomState(6).rand(6, 3).astype("f")
    c = sp.CSRNDArray(torch.from_numpy(onp.array(j.data.asnumpy())),
                      j.indices.asnumpy(), j.indptr.asnumpy(), (4, 6))
    onp.testing.assert_allclose(sp.dot(c, _t(w)).asnumpy(),
                                jsp.dot(j, jnd.array(w)).asnumpy(),
                                rtol=SUM_TOL)


@pytest.mark.parametrize("combo", ["dense_x_rsp", "rsp_x_dense",
                                   "csr_x_rsp", "dense_x_dense"])
def test_dot_densifying_combinations_match_jax(combo):
    a = dense_with_zeros((4, 5), seed=11)
    b = dense_with_zeros((5, 3), seed=12)
    pick = {"dense_x_rsp": ("default", "row_sparse"),
            "rsp_x_dense": ("row_sparse", "default"),
            "csr_x_rsp": ("csr", "row_sparse"),
            "dense_x_dense": ("default", "default")}[combo]
    j = jsp.dot(jnd.array(a).tostype(pick[0]),
                jnd.array(b).tostype(pick[1])).asnumpy()
    t = sp.dot(_t(a).tostype(pick[0]), _t(b).tostype(pick[1])).asnumpy()
    onp.testing.assert_allclose(t, j, rtol=SUM_TOL, atol=1e-7)


# -- retain and elemwise_add --------------------------------------------------

_RETAINS = {
    # (stored values, stored rows, shape, requested ids)
    "sparse_basic": ([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]], [0, 2, 4],
                     (6, 2), [2, 3, 4]),
    "duplicate_ids": ([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]], [0, 2, 4],
                      (6, 2), [4, 2, 4, 0, 2]),
    "missing_ids": ([[1.0, 1.0], [2.0, 2.0]], [1, 3], (6, 2),
                    [0, 5, 3, 2]),
    "float_ids": ([[1.0, 2.0], [3.0, 4.0]], [1, 4], (5, 2),
                  [1.0, 4.0, 2.0]),
    "empty_ids": ([[1.0, 1.0]], [1], (4, 2), []),
    "empty_rsp": (onp.zeros((0, 2), "f"), onp.zeros((0,), "i8"), (4, 2),
                  [0, 1]),
    "empty_both": (onp.zeros((0, 3), "f"), onp.zeros((0,), "i8"), (4, 3),
                   []),
    "unsorted_stored": ([[5.0], [1.0], [3.0]], [4, 0, 2], (5, 1),
                        [0, 2, 4, 1]),
}


@pytest.mark.parametrize("case", sorted(_RETAINS))
def test_retain_matches_jax(case):
    vals, rows, shape, ids = _RETAINS[case]
    vals, rows = onp.asarray(vals, "f"), onp.asarray(rows, "i8")
    ids = onp.asarray(ids, "f")
    j = jsp.retain(jsp.row_sparse_array((vals, rows), shape=shape),
                   jnd.array(ids))
    t = sp.retain(sp.row_sparse_array((vals, rows), shape=shape, ctx=CPU),
                  _t(ids))
    _same_layout(t, j)
    if case == "sparse_basic":
        expect = onp.zeros((6, 2), "f")
        expect[2], expect[4] = 2, 3
        onp.testing.assert_array_equal(t.asnumpy(), expect)


def test_retain_rows_of_a_cast_array():
    x = dense_with_zeros((6, 4), seed=6)
    j = jsp.retain(jsp.cast_storage(jnd.array(x), "row_sparse"),
                   jnd.array(onp.array([1.0, 4.0])))
    t = sp.cast_storage(_t(x), "row_sparse").retain(
        _t(onp.array([1.0, 4.0])))
    _same_layout(t, j)
    want = onp.zeros_like(x)
    want[[1, 4]] = x[[1, 4]]
    onp.testing.assert_array_equal(t.asnumpy(), want)
    with pytest.raises(TypeError):
        sp.retain(sp.zeros("csr", (2, 2), ctx=CPU), _t([0.0]))


_ADDS = {
    "disjoint": (([[1.0, 1.0]], [1]), ([[2.0, 2.0]], [1]), (3, 2)),
    "overlap_merged": (([[1.0, 1.0]], [2]), ([[2.0, 2.0]], [2]), (4, 2)),
    "unsorted_mix": (([[1.0], [2.0], [3.0]], [3, 0, 2]),
                     ([[4.0], [5.0]], [2, 1]), (4, 1)),
}


@pytest.mark.parametrize("case", sorted(_ADDS))
def test_elemwise_add_of_two_row_sparse_matches_jax(case):
    (av, ai), (bv, bi), shape = _ADDS[case]
    ja = jsp.row_sparse_array((onp.asarray(av, "f"), ai), shape=shape)
    jb = jsp.row_sparse_array((onp.asarray(bv, "f"), bi), shape=shape)
    j = jsp.elemwise_add(ja, jb)
    t = sp.add(_carry(ja), _carry(jb))
    assert t.stype == "row_sparse"
    _same_layout(t, j)
    idx = t.indices.asnumpy()
    assert idx.tolist() == sorted(set(idx.tolist()))  # sorted, unique


@pytest.mark.parametrize("seeds", [(7, 8), (21, 22)])
def test_elemwise_add_sparse_and_mixed_matches_jax(seeds):
    a = dense_with_zeros((5, 3), seed=seeds[0])
    b = dense_with_zeros((5, 3), seed=seeds[1])
    ja = jsp.cast_storage(jnd.array(a), "row_sparse")
    jb = jsp.cast_storage(jnd.array(b), "row_sparse")
    ta, tb = _carry(ja), _carry(jb)
    _same_layout(sp.elemwise_add(ta, tb), jsp.elemwise_add(ja, jb))
    onp.testing.assert_allclose(sp.elemwise_add(ta, tb).asnumpy(), a + b,
                                rtol=SUM_TOL)
    mixed = sp.elemwise_add(ta, _t(b))
    assert mixed.stype == "default"
    onp.testing.assert_array_equal(
        mixed.asnumpy(), jsp.elemwise_add(ja, jnd.array(b)).asnumpy())
    ones = sp.elemwise_add(ta, nd.ones((5, 3), ctx=CPU))
    onp.testing.assert_array_equal(ones.asnumpy(), a + 1)


# -- test_utils ---------------------------------------------------------------

@pytest.mark.parametrize("stype", ["default", "csr", "row_sparse"])
def test_rand_ndarray_draws_what_the_jax_helper_draws(stype):
    onp.random.seed(5)
    j = jtu.rand_ndarray((8, 5), stype=stype, density=0.3)
    onp.random.seed(5)
    t = ttu.rand_ndarray((8, 5), stype=stype, density=0.3, ctx=CPU)
    assert t.stype == stype
    onp.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    if stype != "default":
        _same_layout(t, j)
        frac = (t.asnumpy() != 0).mean()
        assert 0.0 < frac < 0.8


def test_test_utils_helpers_match_jax():
    a = onp.array([1.0, 2.0, 3.0], "f")
    ttu.assert_almost_equal(_t(a), a * (1 + 1e-7))
    with pytest.raises(AssertionError, match="max rel err"):
        ttu.assert_almost_equal(_t(a), a + 1)
    assert ttu.almost_equal(a, a) and not ttu.almost_equal(a, a + 1)
    assert ttu.same(_t(a), a)
    for dt in ("float32", "float16", "bfloat16", "int32", "float64"):
        assert ttu.default_tols(dt) == jtu.default_tols(dt)
    assert ttu.effective_dtype(_t(a)) == "float32"
    onp.random.seed(0)
    j = (jtu.rand_shape_2d(), jtu.rand_shape_3d(), jtu.rand_shape_nd(4))
    onp.random.seed(0)
    t = (ttu.rand_shape_2d(), ttu.rand_shape_3d(), ttu.rand_shape_nd(4))
    assert [tuple(map(int, s)) for s in t] == \
        [tuple(map(int, s)) for s in j]
    ttu.check_numeric_gradient(lambda x, y: x * y + nd.exp(x),
                               [onp.array([0.5, -1.0], "f"),
                                onp.array([2.0, 0.25], "f")], ctx=CPU)
    out = ttu.check_consistency(lambda x: nd.exp(x) * 2, [a],
                                ctx_list=[CPU, CPU])
    onp.testing.assert_allclose(out.asnumpy(), onp.exp(a) * 2, rtol=1e-6)

    @ttu.with_seed(3)
    def draw():
        return onp.random.rand()

    @jtu.with_seed(3)
    def jdraw():
        return onp.random.rand()

    assert draw() == jdraw()


def test_check_consistency_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    with pytest.raises(MXNetError, match="CUDA"):
        ttu.check_consistency(lambda x: x * 2, [onp.ones(2, "f")])


# -- contrib.getnnz -----------------------------------------------------------

def test_getnnz_over_csr_matches_jax():
    dense = onp.array([[1.0, 0, 2], [0, 0, 0], [3, 4, 0]], "f")
    j = jnd.array(dense).tostype("csr")
    t = _t(dense).tostype("csr")
    for axis in (None, 1):
        got = nd.contrib.getnnz(t, axis=axis)
        want = jnd.contrib.getnnz(j, axis=axis).asnumpy()
        onp.testing.assert_array_equal(got.asnumpy(), want)
        assert got.asnumpy().dtype == want.dtype == onp.int32
    assert int(nd.contrib.getnnz(t).asnumpy()[0]) == 4
    assert nd.contrib.getnnz(t, axis=1).asnumpy().tolist() == [2, 0, 2]
    with pytest.raises(NotImplementedError):
        nd.contrib.getnnz(t, axis=0)
    assert int(nd.contrib.getnnz(_t(dense)).asnumpy()[0]) == 4
    rsp = sp.row_sparse_array((onp.ones((2, 3), "f"), onp.array([0, 2])),
                              shape=(4, 3), ctx=CPU)
    with pytest.raises(TypeError, match="csr"):
        nd.contrib.getnnz(rsp)


# -- save and load ------------------------------------------------------------

def test_save_writes_sparse_dense_as_jax_and_load_refuses_sparse(tmp_path):
    x = dense_with_zeros((4, 3), seed=14)
    j = jsp.cast_storage(jnd.array(x), "row_sparse")
    jnd.save(str(tmp_path / "j.params"), {"w": j})
    nd.save(str(tmp_path / "t.params"), {"w": _carry(j)})
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "t.params").read_bytes()
    onp.testing.assert_array_equal(
        nd.load(str(tmp_path / "t.params"), ctx=CPU)["w"].asnumpy(), x)
    buf = bytearray((tmp_path / "t.params").read_bytes())
    buf[28:32] = (1).to_bytes(4, "little")  # the first array's stype
    with pytest.raises(MXNetError, match="dense"):
        nd.load_frombuffer(bytes(buf), ctx=CPU)
    with pytest.raises(jmx.MXNetError, match="dense"):
        jnd.load_frombuffer(bytes(buf))


# -- the lazy optimizer rows --------------------------------------------------

def _rsp_grad(rows, width, seed, n):
    rs = onp.random.RandomState(seed)
    return (rs.randn(len(rows), width).astype("f"), onp.asarray(rows, "i8"),
            (n, width))


_OPTS = {
    # name: (optimizer, kwargs, steps)
    "sgd_lazy": ("sgd", {"learning_rate": 0.1}, 3),
    "sgd_lazy_wd_clip_rescale": ("sgd", {"learning_rate": 0.1, "wd": 0.01,
                                         "clip_gradient": 0.5,
                                         "rescale_grad": 0.5}, 3),
    "sgd_momentum_densifies": ("sgd", {"learning_rate": 0.1,
                                       "momentum": 0.9}, 3),
    "sgd_not_lazy_densifies": ("sgd", {"learning_rate": 0.1,
                                       "lazy_update": False, "wd": 0.1}, 2),
    "adam_lazy": ("adam", {"learning_rate": 0.01}, 3),
    "adam_lazy_wd_clip": ("adam", {"learning_rate": 0.01, "wd": 0.05,
                                   "clip_gradient": 0.3}, 3),
    "adam_not_lazy": ("adam", {"learning_rate": 0.01,
                               "lazy_update": False}, 3),
    "groupadagrad": ("groupadagrad", {"learning_rate": 0.5}, 3),
    "groupadagrad_clip_rescale": ("groupadagrad", {
        "learning_rate": 0.5, "clip_gradient": 0.4, "rescale_grad": 2.0}, 2),
}


@pytest.mark.parametrize("case", sorted(_OPTS))
def test_lazy_rows_match_jax(case):
    name, kw, steps = _OPTS[case]
    w0 = onp.random.RandomState(1).randn(7, 3).astype("f")
    grads = [_rsp_grad(rows, 3, 10 + s, 7)
             for s, rows in enumerate([[1, 4], [0, 4, 6], [2]][:steps])]
    res = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            opt = jmx.optimizer.create(name, **kw)
            w = jnd.array(w0)
            state = opt.create_state(0, w)
            for vals, rows, shape in grads:
                opt.update(0, w, jsp.row_sparse_array((vals, rows),
                                                      shape=shape), state)
        else:
            opt = mx.optimizer.create(name, **kw)
            w = _t(w0)
            buf = w.data
            state = opt.create_state(0, w)
            for vals, rows, shape in grads:
                opt.update(0, w, sp.row_sparse_array(
                    (vals, rows), shape=shape, ctx=CPU), state)
            assert w.data is buf  # updated in place
        res[pkg] = (w.asnumpy(), state)
    onp.testing.assert_allclose(res["port"][0], res["jax"][0],
                                rtol=SUM_TOL, atol=1e-7)
    if case in ("sgd_lazy", "adam_lazy", "groupadagrad"):
        # rows no gradient touched keep their values (and zero states)
        untouched = [3, 5]
        onp.testing.assert_array_equal(res["port"][0][untouched],
                                       w0[untouched])
    js, ts = res["jax"][1], res["port"][1]
    for a, b in zip(js if isinstance(js, tuple) else (js,),
                    ts if isinstance(ts, tuple) else (ts,)):
        if a is None:
            assert b is None
            continue
        onp.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=SUM_TOL,
                                    atol=1e-7)


def test_sparse_sgd_and_adam_cases_of_the_jax_suite():
    w0 = onp.ones((6, 3), onp.float32)
    weight = _t(w0)
    grad = sp.row_sparse_array((onp.full((2, 3), 0.5, onp.float32), [1, 4]),
                               shape=(6, 3), ctx=CPU)
    opt = mx.optimizer.SGD(learning_rate=0.1, lazy_update=True)
    opt.update(0, weight, grad, opt.create_state(0, weight))
    expect = w0.copy()
    expect[[1, 4]] -= 0.1 * 0.5
    onp.testing.assert_allclose(weight.asnumpy(), expect, rtol=1e-6)
    w0 = onp.ones((5, 2), onp.float32)
    weight = _t(w0)
    grad = sp.row_sparse_array((onp.full((1, 2), 1.0, onp.float32), [3]),
                               shape=(5, 2), ctx=CPU)
    opt = mx.optimizer.Adam(learning_rate=0.01)
    opt.update(0, weight, grad, opt.create_state(0, weight))
    out = weight.asnumpy()
    onp.testing.assert_array_equal(out[[0, 1, 2, 4]], w0[[0, 1, 2, 4]])
    assert (out[3] < 1.0).all()


def test_updater_aggregates_dense_lists_only(monkeypatch):
    calls = []
    opt = mx.optimizer.SGD(learning_rate=0.1)
    monkeypatch.setattr(opt, "update_multi",
                        lambda *a: calls.append("multi"))
    up = mx.optimizer.get_updater(opt)
    ws = [_t(onp.ones((4, 2), "f")) for _ in range(2)]
    dense = [_t(onp.ones((4, 2), "f")) for _ in range(2)]
    up([0, 1], dense, ws)
    assert calls == ["multi"]
    g = sp.row_sparse_array(([[1.0, 1.0]], [2]), shape=(4, 2), ctx=CPU)
    up([0, 1], [g, dense[1]], ws)
    assert calls == ["multi"]  # the per-index loop took the sparse list
    onp.testing.assert_allclose(ws[0].asnumpy()[2], [0.9, 0.9], rtol=1e-6)
    onp.testing.assert_array_equal(ws[0].asnumpy()[0], [1.0, 1.0])


# -- the store ----------------------------------------------------------------

def _kv_run(pkg, scenario):
    if pkg == "jax":
        P, S, arr, zeros = jmx, jsp, jnd.array, jnd.zeros
        kw = {}
    else:
        P, S, arr = mx, sp, _t
        kw = {"ctx": CPU}

        def zeros(shape):
            return nd.zeros(shape, ctx=CPU)
    kv = P.kv.create("local")
    out = {}
    if scenario == "push_list_pull":
        kv.init("w", zeros((4, 2)))
        g1 = S.row_sparse_array(([[1.0, 1.0]], [0]), shape=(4, 2), **kw)
        g2 = S.row_sparse_array(([[2.0, 2.0]], [3]), shape=(4, 2), **kw)
        kv.push("w", [g1, g2])
    elif scenario == "duplicate_rows_lazy_sgd":
        kv.init("w", arr(onp.ones((4, 2), "f")))
        kv.set_optimizer(P.optimizer.SGD(learning_rate=1.0))
        a = S.row_sparse_array(([[1.0, 1.0]], [2]), shape=(4, 2), **kw)
        b = S.row_sparse_array(([[2.0, 2.0]], [2]), shape=(4, 2), **kw)
        kv.push("w", [a, b])
    elif scenario == "lazy_adam_three_pushes":
        rs = onp.random.RandomState(3)
        kv.init("w", arr(rs.randn(6, 3).astype("f")))
        kv.set_optimizer(P.optimizer.create("adam", learning_rate=0.05))
        for rows in ([0, 3], [3, 5], [1]):
            kv.push("w", S.row_sparse_array(
                (rs.randn(len(rows), 3).astype("f"), rows), shape=(6, 3),
                **kw))
    elif scenario == "no_updater_sparse_into_dense":
        kv.init("w", arr(onp.arange(8, dtype="f").reshape(4, 2)))
        kv.push("w", S.row_sparse_array(([[1.0, 2.0]], [1]), shape=(4, 2),
                                        **kw))
        kv.push("w", S.row_sparse_array(([[3.0, 3.0]], [3]), shape=(4, 2),
                                        **kw))
        out["stype"] = kv._store["w"].stype
    o = zeros((4, 2) if scenario != "lazy_adam_three_pushes" else (6, 3))
    kv.pull("w", out=o)
    out["pulled"] = o.asnumpy()
    return out


@pytest.mark.parametrize("scenario", ["push_list_pull",
                                      "duplicate_rows_lazy_sgd",
                                      "lazy_adam_three_pushes",
                                      "no_updater_sparse_into_dense"])
def test_store_sparse_push_and_pull_match_jax(scenario):
    j, t = _kv_run("jax", scenario), _kv_run("port", scenario)
    assert set(j) == set(t)
    onp.testing.assert_allclose(t["pulled"], j["pulled"], rtol=SUM_TOL,
                                atol=1e-7)
    if "stype" in j:
        assert t["stype"] == j["stype"]
    if scenario == "push_list_pull":
        expect = onp.zeros((4, 2), onp.float32)
        expect[0], expect[3] = 1, 2
        onp.testing.assert_array_equal(t["pulled"], expect)
    if scenario == "duplicate_rows_lazy_sgd":
        onp.testing.assert_array_equal(t["pulled"][2], [-2.0, -2.0])


@pytest.mark.parametrize("case", ["arange_rows", "sparse2_two_rows",
                                  "duplicate_ids"])
def test_row_sparse_pull_matches_jax(case):
    if case == "arange_rows":
        w = onp.arange(12, dtype=onp.float32).reshape(6, 2)
        ids, oshape = [1, 3, 5], (3, 2)
    elif case == "sparse2_two_rows":
        w = dense_with_zeros((6, 3), density=1.0, seed=13)
        ids, oshape = [0.0, 4.0], (6, 3)
    else:
        w = onp.random.RandomState(2).randn(5, 4).astype("f")
        ids, oshape = [4, 1, 4, 0], (4, 4)
    res = []
    for P, arr, zeros in ((jmx, jnd.array, jnd.zeros),
                          (mx, _t, lambda s: nd.zeros(s, ctx=CPU))):
        kv = P.kv.create("local")
        kv.init(9, arr(w))
        out = zeros(oshape)
        kv.row_sparse_pull(9, out=out, row_ids=arr(onp.array(ids, "f")))
        res.append(out.asnumpy())
    onp.testing.assert_array_equal(res[1], res[0])
    onp.testing.assert_array_equal(res[1][:len(ids)],
                                   w[onp.asarray(ids, int)])


def test_store_value_initialized_sparse_pulls_dense():
    x = dense_with_zeros((5, 2), seed=4)
    kv = mx.kv.create("local")
    kv.init("e", _t(x).tostype("row_sparse"))
    out = nd.zeros((5, 2), ctx=CPU)
    kv.pull("e", out=out)
    onp.testing.assert_array_equal(out.asnumpy(), x)
    rows = nd.zeros((2, 2), ctx=CPU)
    kv.row_sparse_pull("e", out=rows, row_ids=_t([4.0, 0.0]))
    onp.testing.assert_array_equal(rows.asnumpy(), x[[4, 0]])


def test_store_and_trainer_refuse_a_sparse_reduce_over_ranks(monkeypatch):
    """The same refusal as the two-process launch below, in one process
    with the group's size patched (the path the launch cannot count)."""
    from mxnet_tpu_torch import _rendezvous

    kv = mx.kv.create("dist_sync")
    kv.init("w", nd.zeros((4, 2), ctx=CPU))
    g = sp.row_sparse_array(([[1.0, 1.0]], [1]), shape=(4, 2), ctx=CPU)
    kv.push("w", g)  # one process: the store applies it
    out = nd.zeros((4, 2), ctx=CPU)
    kv.pull("w", out=out)
    onp.testing.assert_array_equal(out.asnumpy()[1], [1.0, 1.0])
    monkeypatch.setattr(_rendezvous, "world_size", lambda: 2)
    with pytest.raises(MXNetError, match="sparse push to a dist_sync store "
                                         "across 2 processes"):
        kv.push("w", g)
    net = gluon.nn.Dense(2, in_units=4)
    net.initialize(ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync")
    monkeypatch.setattr(tr, "_distributed", True)
    net.weight._ndarray._grad = sp.row_sparse_array(
        ([[1.0] * 4], [0]), shape=(2, 4), ctx=CPU)
    with pytest.raises(MXNetError, match="across 2 processes"):
        tr.step(1)


SPARSE_DIST_BODY = r"""
import os, sys
import numpy as onp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
store = mx.kv.create("dist_sync")
rank, n = store.rank, store.num_workers
store.init("w", nd.zeros((4, 2), ctx=CPU))
g = mx.nd.sparse.row_sparse_array(([[1.0, 1.0]], [rank]), shape=(4, 2),
                                  ctx=CPU)
try:
    store.push("w", g)
    msg = "no error"
except MXNetError as e:
    msg = str(e)
store.push("w", g.tostype("default"))  # a dense push still sums
out = nd.zeros((4, 2), ctx=CPU)
store.pull("w", out=out)
store.barrier()
with open(os.path.join(sys.argv[1], "rank%d.txt" % rank), "w") as f:
    f.write("%d\n%s\n%s\n" % (n, msg, out.asnumpy().ravel().tolist()))
"""


def test_sparse_push_across_two_processes_raises(tmp_path):
    from mxnet_tpu_torch.tools import launch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(SPARSE_DIST_BODY)
    proc = launch.run_local(
        [sys.executable, str(worker), str(tmp_path)], 2,
        env={"MXNET_DIST_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": repo}, timeout=150, cwd=repo)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    for r in (0, 1):
        n, msg, vals = (tmp_path / f"rank{r}.txt").read_text().splitlines()
        assert n == "2"
        assert "sparse push to a dist_sync store across 2 processes" in msg
        # rows 0 and 1 hold one rank's dense push each
        assert eval(vals) == [1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]


# -- gluon: the Trainer's sparse path and the dense embedding gradient --------

def _embed_pair(kind, sparse_grad):
    """The same embedding (weights carried) in both packages."""
    if kind == "SparseEmbedding":
        jb = jmx.gluon.contrib.nn.SparseEmbedding(20, 4, prefix="emb_")
        tb = gluon.contrib.nn.SparseEmbedding(20, 4, prefix="emb_")
    else:
        jb = jmx.gluon.nn.Embedding(20, 4, sparse_grad=sparse_grad,
                                    prefix="emb_")
        tb = gluon.nn.Embedding(20, 4, sparse_grad=sparse_grad,
                                prefix="emb_")
    jmx.random.seed(12)
    jb.initialize()
    tb.initialize(ctx=CPU)
    convert.params_from_numpy(tb, {
        k: p.data().asnumpy()
        for k, p in jb._collect_params_with_prefix().items()}, ctx=CPU)
    return jb, tb


@pytest.mark.parametrize("kind,sparse_grad", [("Embedding", True),
                                              ("Embedding", False),
                                              ("SparseEmbedding", None)])
def test_embedding_gradient_is_dense_and_matches_jax(kind, sparse_grad):
    jb, tb = _embed_pair(kind, sparse_grad)
    idx = onp.array([3.0, 7.0, 3.0], "f")
    cot = onp.random.RandomState(4).randn(3, 4).astype("f")
    with jmx.autograd.record():
        jl = (jb(jnd.array(idx)) * jnd.array(cot)).sum()
    jl.backward()
    with autograd.record():
        tl = (tb(_t(idx)) * _t(cot)).sum()
    tl.backward()
    jg, tg = jb.weight.grad(), tb.weight.grad()
    assert tg.stype == "default" and not isinstance(
        tg, sp.BaseSparseNDArray)
    assert jg.stype == "default"  # the JAX package's is dense too
    onp.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(), rtol=NET_RTOL,
                                atol=NET_ATOL)
    onp.testing.assert_allclose(tg.asnumpy()[3], cot[0] + cot[2],
                                rtol=1e-6)
    assert (tg.asnumpy()[[0, 1, 2]] == 0).all()


def test_embedding_sparse_grad_case_of_the_jax_suite():
    mx.random.seed(12)
    emb = gluon.nn.Embedding(20, 4, sparse_grad=True)
    emb.initialize(ctx=CPU)
    with autograd.record():
        loss = emb(_t(onp.array([3.0, 7.0, 3.0], "f"))).sum()
    loss.backward()
    dense = emb.weight.grad().asnumpy()
    assert (dense[3] == 2.0).all() and (dense[7] == 1.0).all()
    p = gluon.Parameter("w", shape=(3, 2), stype="row_sparse",
                        grad_stype="row_sparse")
    p.initialize(ctx=CPU)
    assert p.data().stype == "default" and p.grad().stype == "default"


@pytest.mark.parametrize("opt,kw", [("sgd", {"learning_rate": 0.5}),
                                    ("adam", {"learning_rate": 0.05})])
def test_trainer_sparse_gradient_takes_the_per_tensor_path(opt, kw):
    """A row_sparse gradient in a parameter's buffer (the Trainer's
    per-tensor path; autograd never writes one) takes the lazy update in
    both packages, and the port's fused step steps aside for it."""
    from mxnet_tpu_torch.gluon import fused_step as fs

    jb, tb = _embed_pair("SparseEmbedding", None)
    rows, vals = [2, 5, 11], onp.random.RandomState(8).randn(3, 4) \
        .astype("f")
    jtr = jmx.gluon.Trainer(jb.collect_params(), opt, dict(kw))
    ttr = gluon.Trainer(tb.collect_params(), opt, dict(kw))
    before = fs.fused_step_stats()["bypasses"]
    for step in range(2):
        jb.weight._ndarray._grad = jsp.row_sparse_array(
            (vals * (step + 1), rows), shape=(20, 4))
        tb.weight._ndarray._grad = sp.row_sparse_array(
            (vals * (step + 1), rows), shape=(20, 4), ctx=CPU)
        jtr.step(2)
        ttr.step(2)
    jw, tw = jb.weight.data().asnumpy(), tb.weight.data().asnumpy()
    onp.testing.assert_allclose(tw, jw, rtol=NET_RTOL, atol=NET_ATOL)
    w0 = _embed_pair("SparseEmbedding", None)[1].weight.data().asnumpy()
    untouched = [r for r in range(20) if r not in rows]
    onp.testing.assert_array_equal(tw[untouched], w0[untouched])
    assert not (tw[rows] == w0[rows]).any()
    assert fs.fused_step_stats()["bypasses"] >= before + 2


def test_reducer_skips_a_sparse_gradient():
    from mxnet_tpu_torch.pipeline import AsyncGradReducer

    g = sp.row_sparse_array(([[1.0]], [0]), shape=(2, 1), ctx=CPU)
    assert not AsyncGradReducer._reducible(g)
    assert not AsyncGradReducer._reducible(None)
    assert AsyncGradReducer._reducible(nd.zeros((2, 1), ctx=CPU))


def test_sparse_arrays_pickle_by_value():
    x = dense_with_zeros((3, 4), seed=2)
    t = _t(x).tostype("csr")
    back = pickle.loads(pickle.dumps(t))
    assert back.stype == "csr"
    onp.testing.assert_array_equal(back.asnumpy(), x)
