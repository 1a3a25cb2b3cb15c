"""The port's text parsers (``csrc/textio.cc`` behind ``CSVIter`` and
``LibSVMIter``) against the JAX package's (``native/textio.cc``) on the
same files, on the CPU: every case of ``tests/test_textio.py``.

Bounds: parsed values, labels, CSR layouts and ``pad`` equal (both
packages parse with the same ``strtof``); the index dtypes the JAX
package reports (int32 ids and indptr, float32 values and labels). A
parser that cannot be built raises and nothing falls back to a Python
parse.
"""
import numpy as onp
import pytest

from mxnet_tpu.io import CSVIter as JCSVIter
from mxnet_tpu.io.image_record import LibSVMIter as JLibSVMIter
from mxnet_tpu.io.io import _parse_csv as j_parse_csv

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import CSVIter, LibSVMIter
from mxnet_tpu_torch.io.io import _parse_csv

CPU = mx.cpu()


def _csr_parts(a):
    return (a.data.asnumpy(), a.indices.asnumpy(), a.indptr.asnumpy())


def _svm_batches(it):
    out = []
    for b in it:
        x = b.data[0]
        out.append((x.stype, x.shape, _csr_parts(x), x.asnumpy(),
                    b.label[0].asnumpy(), b.pad))
    return out


def _same_svm(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        assert t[0] == j[0] == "csr" and t[1] == j[1] and t[5] == j[5]
        for a, b in zip(t[2], j[2]):
            onp.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        onp.testing.assert_array_equal(t[3], j[3])
        onp.testing.assert_array_equal(t[4], j[4])
        assert t[4].dtype == j[4].dtype == onp.float32


def test_native_parser_builds_as_the_ports_own():
    lib = _native.text_lib()
    assert lib is _native.text_lib()
    path = _native.build("textio")
    assert "mxnet_tpu/_native" not in path and "/native/" not in path


def test_csviter_matches_numpy_and_jax(tmp_path):
    rng = onp.random.RandomState(0)
    data = rng.randn(256, 6).astype("f")
    labels = rng.randint(0, 3, (256, 1)).astype("f")
    dpath, lpath = tmp_path / "d.csv", tmp_path / "l.csv"
    onp.savetxt(dpath, data, delimiter=",", fmt="%.6g")
    onp.savetxt(lpath, labels, delimiter=",", fmt="%.6g")
    got = []
    for cls in (JCSVIter, CSVIter):
        it = cls(data_csv=str(dpath), data_shape=(6,), label_csv=str(lpath),
                 label_shape=(1,), batch_size=64, round_batch=False)
        got.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    assert len(got[0]) == len(got[1]) == 4
    for (jd, jl, jp), (td, tl, tp) in zip(*got):
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)
        assert tp == jp
    td = onp.concatenate([g[0] for g in got[1]])
    onp.testing.assert_allclose(td, data, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("text,shape", [
    ("1.0, 2.0 ,3.0\n\n4.5,5.5,6.5\n   \n7,8,9\n", (3,)),
    ("# header comment\n1,2,3\n4,5,6 # trailing\n", (3,)),
    ("1,2\n3,4\n5,6\n7,8\n9,10\n", (2,)),
])
def test_csv_blank_lines_spaces_and_comments_match_jax(tmp_path, text,
                                                       shape):
    p = tmp_path / "x.csv"
    p.write_text(text)
    onp.testing.assert_array_equal(_parse_csv(str(p)), j_parse_csv(str(p)))
    jb = [b.data[0].asnumpy() for b in JCSVIter(
        data_csv=str(p), data_shape=shape, batch_size=3, round_batch=True)]
    tb = [b.data[0].asnumpy() for b in CSVIter(
        data_csv=str(p), data_shape=shape, batch_size=3, round_batch=True)]
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        onp.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("text", ["1,2,3\n4,5\n", "1,abc,3\n"])
def test_csv_ragged_or_malformed_raises(tmp_path, text):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    with pytest.raises(MXNetError, match="CSV parse failed"):
        CSVIter(data_csv=str(p), data_shape=(3,), batch_size=1)


def test_csv_directory_raises_not_aborts(tmp_path):
    with pytest.raises(MXNetError, match="CSV parse failed"):
        CSVIter(data_csv=str(tmp_path), data_shape=(3,), batch_size=1)


def test_native_csv_large_parallel(tmp_path):
    """Big enough to span several parser threads; order must hold."""
    n = 20000
    data = onp.arange(n * 3, dtype=onp.float32).reshape(n, 3)
    p = tmp_path / "big.csv"
    onp.savetxt(p, data, delimiter=",", fmt="%.1f")
    out = _parse_csv(str(p))
    assert out.shape == (n, 3) and out.dtype == onp.float32
    onp.testing.assert_array_equal(out, data)


INLINE = ("1 0:1.5 3:2.5\n"
          "0 1:-1.0\n"
          "\n"
          "2 0:0.5 2:4.0 3:-2.0\n")


@pytest.mark.parametrize("batch,round_batch", [(3, False), (2, True),
                                               (2, False), (4, True)])
def test_libsvm_inline_labels_match_jax(tmp_path, batch, round_batch):
    p = tmp_path / "t.libsvm"
    p.write_text(INLINE)
    kw = dict(data_libsvm=str(p), data_shape=(4,), batch_size=batch,
              round_batch=round_batch)
    jb = _svm_batches(JLibSVMIter(**kw))
    tb = _svm_batches(LibSVMIter(ctx=CPU, **kw))
    _same_svm(tb, jb)
    if batch == 3:
        expect = onp.array([[1.5, 0, 0, 2.5], [0, -1.0, 0, 0],
                            [0.5, 0, 4.0, -2.0]], "f")
        onp.testing.assert_array_equal(tb[0][3], expect)
        onp.testing.assert_array_equal(tb[0][4], [1, 0, 2])


def test_libsvm_separate_label_file_matches_jax(tmp_path):
    d, lab = tmp_path / "d.libsvm", tmp_path / "l.libsvm"
    d.write_text("0:1.0\n1:2.0\n")
    lab.write_text("5\n7\n")
    kw = dict(data_libsvm=str(d), data_shape=(2,), label_libsvm=str(lab),
              batch_size=2, round_batch=False)
    tb = _svm_batches(LibSVMIter(ctx=CPU, **kw))
    _same_svm(tb, _svm_batches(JLibSVMIter(**kw)))
    onp.testing.assert_array_equal(tb[0][4], [5, 7])
    lab.write_text("5\n")
    with pytest.raises(ValueError, match="label_libsvm has 1 rows"):
        LibSVMIter(ctx=CPU, **kw)


def test_libsvm_seeded_file_matches_jax_batch_by_batch(tmp_path):
    """A wider seeded file (the smoke's generator at a small size),
    several batches and a padded last one."""
    from mxnet_tpu_torch.tools import profile_sparse as ps

    p = tmp_path / "s.libsvm"
    ps.write_libsvm(str(p), rows=200, features=5000, nnz=15, seed=3)
    kw = dict(data_libsvm=str(p), data_shape=(5000,), batch_size=64)
    jit = JLibSVMIter(**kw)
    tit = LibSVMIter(ctx=CPU, **kw)
    assert tit.provide_data[0].shape == (64, 5000)
    assert tit.provide_label[0].shape == (64,)
    _same_svm(_svm_batches(tit), _svm_batches(jit))
    tit.reset()
    assert sum(1 for _ in tit) == 4


def test_parse_rate_reads_the_whole_file(tmp_path):
    from mxnet_tpu_torch.tools import profile_sparse as ps

    p = ps.write_libsvm(str(tmp_path / "r.libsvm"), 300, 5000, seed=1)
    r = ps.parse_rate(mx, p, 5000, 64)
    assert r["rows"] == 300 and r["nnz"] == 300 * 15
    assert r["parse_s"] > 0 and r["parser_build_s"] >= 0


def test_libsvm_malformed_raises(tmp_path):
    p = tmp_path / "bad.libsvm"
    p.write_text("1 0:1.5 nonsense\n")
    with pytest.raises(MXNetError, match="libsvm parse failed"):
        LibSVMIter(data_libsvm=str(p), data_shape=(4,), batch_size=1,
                   ctx=CPU)


def test_batches_land_on_the_iterators_device(tmp_path):
    p = tmp_path / "t.libsvm"
    p.write_text(INLINE)
    b = next(iter(LibSVMIter(str(p), (4,), 2, ctx=CPU)))
    assert b.data[0].context == CPU and b.label[0].context == CPU
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            LibSVMIter(str(p), (4,), 2)


@pytest.mark.parametrize("kind", ["no_compiler", "compile_error"])
def test_failed_parser_build_raises_and_never_falls_back(monkeypatch,
                                                         tmp_path, kind):
    p = tmp_path / "t.libsvm"
    p.write_text(INLINE)
    c = tmp_path / "d.csv"
    c.write_text("1,2\n")
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "out"))
    if kind == "no_compiler":
        monkeypatch.setattr(_native.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    else:
        bad = tmp_path / "csrc"
        bad.mkdir()
        (bad / "textio.cc").write_text("this is not C++\n")
        monkeypatch.setattr(_native, "_CSRC", str(bad))
        match = "g\\+\\+ failed to build csrc/textio.cc"
    with pytest.raises(MXNetError, match=match):
        LibSVMIter(str(p), (4,), 2, ctx=CPU)
    with pytest.raises(MXNetError, match=match):
        CSVIter(data_csv=str(c), data_shape=(2,), batch_size=1)
