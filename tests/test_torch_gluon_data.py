"""``gluon.data`` and ``io`` in the port against the JAX package.

The same numpy data, and the same numpy (and Python ``random``) seeds,
go through both packages' datasets, samplers, loaders, iterators and
transforms; batches are compared value for value, in order. Dataset
files (MNIST idx-ubyte, CIFAR pickles, an image folder of PNGs, CSV)
are written by the tests in their formats; nothing is downloaded.

Tolerances: batches, samples and index sequences exactly; transforms in
float32 within 1e-5 (rtol and atol: the same arithmetic in another
order), on uint8 images within one step (a float result one rounding
apart may truncate to the next integer). ``Resize`` is
``F.interpolate`` (bilinear, antialiased when it shrinks) against
``jax.image.resize(method="linear")``, held to the same 1e-5 in float32
(measured: 1.5e-5 at most on values up to 255, float32 rounding).

``NDArrayIter``'s ``"discard"`` and ``"roll_over"`` follow the reference
(a short last batch dropped, or carried into the next pass); the JAX
package returns the short batch under both, so those modes are held to
the JAX package's full batches plus the reference's rule.
"""
import gzip
import pickle
import random
import struct
import time

import numpy as onp
import pytest

from mxnet_tpu import io as jio
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as tT

TOL = 1e-5


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _flat(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    return [_np(batch)]


def _same(jbatches, tbatches):
    assert len(jbatches) == len(tbatches)
    for jb, tb in zip(jbatches, tbatches):
        for j, t in zip(_flat(jb), _flat(tb)):
            onp.testing.assert_array_equal(t, j)


def _arrays(n=11, d=3):
    X = onp.arange(n * d, dtype="f").reshape(n, d)
    return X, onp.arange(n, dtype="f")


# -- samplers ----------------------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    seqs = []
    for mod in (jdata, tdata):
        onp.random.seed(3)
        rnd = list(mod.RandomSampler(13))
        seq = list(mod.SequentialSampler(5))
        bs = mod.BatchSampler(mod.SequentialSampler(10), 4, last_batch)
        epochs = [list(bs), list(bs)]
        seqs.append((rnd, seq, epochs, len(bs)))
    assert seqs[1] == seqs[0]


def test_batch_sampler_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "nope")


# -- DataLoader ----------------------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_batches_match_jax(last_batch, num_workers):
    X, Y = _arrays()
    got = []
    for mod in (jdata, tdata):
        onp.random.seed(11)
        loader = mod.DataLoader(mod.ArrayDataset(X, Y), batch_size=4,
                                shuffle=True, last_batch=last_batch,
                                num_workers=num_workers)
        got.append([b for _ in range(2) for b in loader])
    _same(*got)
    assert all(b[0].context == mx.cpu() for b in got[1])


def test_dataloader_over_ndarray_dataset_and_single_array():
    X, _ = _arrays()
    loader = tdata.DataLoader(
        tdata.ArrayDataset(nd.array(X, ctx=mx.cpu())), batch_size=5)
    jloader = jdata.DataLoader(jdata.ArrayDataset(jnd.array(X)), batch_size=5)
    _same(list(jloader), list(loader))


def test_dataloader_prefetch_depth_and_env(monkeypatch):
    X, _ = _arrays(10)
    ds = tdata.ArrayDataset(nd.array(X, ctx=mx.cpu()))
    assert tdata.DataLoader(ds, batch_size=2, num_workers=2)._prefetch == 4
    monkeypatch.setenv("MXNET_DATALOADER_PREFETCH", "7")
    assert tdata.DataLoader(ds, batch_size=2, num_workers=2)._prefetch == 7
    assert tdata.DataLoader(ds, batch_size=2, num_workers=2,
                            prefetch=3)._prefetch == 3
    ref = [b.asnumpy().tobytes()
           for b in tdata.DataLoader(ds, batch_size=2, num_workers=0)]
    for depth in (0, 1, 4):
        got = [b.asnumpy().tobytes()
               for b in tdata.DataLoader(ds, batch_size=2, num_workers=2,
                                         prefetch=depth)]
        assert got == ref, depth


def test_dataloader_timeout_raises_instead_of_hanging():
    class Glacial:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            time.sleep(2)
            return onp.zeros((2,), "f")

    loader = tdata.DataLoader(Glacial(), batch_size=2, num_workers=1,
                              timeout=0.2)
    with pytest.raises(RuntimeError, match="timeout"):
        next(iter(loader))
    ds = tdata.ArrayDataset(onp.arange(4, dtype="f"))
    assert tdata.DataLoader(ds, batch_size=2, num_workers=1,
                            timeout=0)._timeout is None
    assert tdata.DataLoader(ds, batch_size=2, num_workers=1,
                            timeout=60)._timeout == 60.0


def test_dataloader_pin_memory_without_a_card_keeps_host_batches():
    X, Y = _arrays(8)
    loader = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=4,
                              num_workers=1, pin_memory=True)
    batches = list(loader)
    assert len(batches) == 2 and batches[0][0].context == mx.cpu()
    onp.testing.assert_array_equal(batches[1][0].asnumpy(), X[4:])


def test_process_workers_match_sync_over_two_epochs():
    """``tests/test_mp_dataloader.py``: process workers (forkserver,
    batches through shared memory) give the inline loader's batches, and
    the pool survives epochs. Each wait is bounded by ``timeout``."""
    rs = onp.random.RandomState(0)
    X = rs.rand(24, 5).astype("f")
    ds = tdata.ArrayDataset(X, onp.arange(24, dtype="f"))
    sync = tdata.DataLoader(ds, batch_size=8, num_workers=0)
    procs = tdata.DataLoader(ds, batch_size=8, num_workers=2,
                             thread_pool=False, timeout=90)
    want = [(d.asnumpy(), lb.asnumpy()) for d, lb in sync]
    for _ in range(2):
        got = [(d.asnumpy(), lb.asnumpy()) for d, lb in procs]
        assert len(got) == 3
        for (dw, lw), (dg, lg) in zip(want, got):
            onp.testing.assert_array_equal(dg, dw)
            onp.testing.assert_array_equal(lg, lw)


def test_shared_memory_codec_roundtrip():
    from mxnet_tpu_torch.gluon.data import _mp_worker as w

    arr = onp.random.RandomState(0).rand(4, 3).astype("f")
    onp.testing.assert_array_equal(w._from_shm(w._to_shm(arr)), arr)
    dec = w.decode(w._encode([arr, {"k": arr[0]}, 3]))
    onp.testing.assert_array_equal(dec[0].asnumpy(), arr)
    onp.testing.assert_array_equal(dec[1]["k"].asnumpy(), arr[0])
    assert dec[2] == 3 and dec[0].context == mx.cpu()


# -- datasets ------------------------------------------------------------------

def test_dataset_transform_filter_take_match_jax():
    X, Y = _arrays(6)
    out = []
    for mod in (jdata, tdata):
        ds = mod.ArrayDataset(X, Y)
        lazy = ds.transform(lambda x, y: (x * 2, y + 1))
        eager = ds.transform_first(lambda x: x - 1, lazy=False)
        picked = ds.filter(lambda s: s[1] % 2 == 0)
        out.append(([lazy[i] for i in range(6)], [eager[i] for i in range(6)],
                    [picked[i] for i in range(len(picked))],
                    [ds.take(2)[i] for i in range(2)], len(ds)))
    for j, t in zip(out[0][:4], out[1][:4]):
        _same(j, t)
    assert out[0][4] == out[1][4] == 6
    with pytest.raises(ValueError):
        tdata.ArrayDataset(X, Y[:3])


def _write_idx(path, arr, gz=False):
    head = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(onp.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_mnist_and_fashion_mnist_read_idx_files_as_jax(tmp_path, gz):
    rs = onp.random.RandomState(1)
    imgs = rs.randint(0, 256, (7, 28, 28)).astype("uint8")
    lbls = rs.randint(0, 10, 7).astype("uint8")
    sfx = ".gz" if gz else ""
    for name, arr in (("train-images-idx3-ubyte", imgs),
                      ("train-labels-idx1-ubyte", lbls),
                      ("t10k-images-idx3-ubyte", imgs[:3]),
                      ("t10k-labels-idx1-ubyte", lbls[:3])):
        _write_idx(str(tmp_path / (name + sfx)), arr, gz)
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv

    for cls in ("MNIST", "FashionMNIST"):
        for train in (True, False):
            j = getattr(jv, cls)(root=str(tmp_path), train=train)
            t = getattr(tv, cls)(root=str(tmp_path), train=train)
            assert len(t) == len(j) == (7 if train else 3)
            _same([j[i] for i in range(len(j))], [t[i] for i in range(len(t))])
            assert t[0][0].shape == (28, 28, 1)
            assert t[0][0].dtype == onp.uint8


def test_mnist_without_files_raises(tmp_path):
    from mxnet_tpu_torch.gluon.data import vision as tv

    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        tv.MNIST(root=str(tmp_path / "none"))


def test_cifar10_and_cifar100_read_pickles_as_jax(tmp_path):
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv

    rs = onp.random.RandomState(2)
    d10 = tmp_path / "c10" / "cifar-10-batches-py"
    d10.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d10 / name, "wb") as f:
            pickle.dump({"data": rs.randint(0, 256, (2, 3072)).astype("uint8"),
                         "labels": list(rs.randint(0, 10, 2))}, f)
    j = jv.CIFAR10(root=str(tmp_path / "c10"))
    t = tv.CIFAR10(root=str(tmp_path / "c10"))
    assert len(t) == len(j) == 10
    _same([j[i] for i in range(10)], [t[i] for i in range(10)])
    assert t[0][0].shape == (32, 32, 3)
    t_test = tv.CIFAR10(root=str(tmp_path / "c10"), train=False)
    assert len(t_test) == 2
    # CIFAR-100 (the port reads its own layout; the JAX package has none)
    d100 = tmp_path / "c100" / "cifar-100-python"
    d100.mkdir(parents=True)
    data = rs.randint(0, 256, (3, 3072)).astype("uint8")
    fine, coarse = [5, 77, 12], [1, 19, 3]
    for name in ("train", "test"):
        with open(d100 / name, "wb") as f:
            pickle.dump({"data": data, "fine_labels": fine,
                         "coarse_labels": coarse}, f)
    c = tv.CIFAR100(root=str(tmp_path / "c100"), fine_label=True)
    assert [int(c[i][1]) for i in range(3)] == fine
    onp.testing.assert_array_equal(
        c[1][0].asnumpy(), data[1].reshape(3, 32, 32).transpose(1, 2, 0))
    c2 = tv.CIFAR100(root=str(tmp_path / "c100"), train=False)
    assert [int(c2[i][1]) for i in range(3)] == coarse


def test_image_folder_dataset_matches_jax(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv

    rs = onp.random.RandomState(3)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            PIL.fromarray(rs.randint(0, 256, (5, 7, 3)).astype("uint8")).save(
                tmp_path / cls / f"{i}.png")
    (tmp_path / "dog" / "notes.txt").write_text("skip me")
    for flag in (1, 0):
        j = jv.ImageFolderDataset(str(tmp_path), flag=flag)
        t = tv.ImageFolderDataset(str(tmp_path), flag=flag)
        assert t.synsets == j.synsets == ["cat", "dog"]
        assert len(t) == len(j) == 4
        _same([j[i] for i in range(4)], [t[i] for i in range(4)])


def test_record_datasets_name_what_they_wait_for(tmp_path):
    # the record datasets are ported: a missing file is named, as the
    # JAX datasets name it (their parity is in test_torch_recordio.py)
    from mxnet_tpu_torch.gluon.data import vision as tv

    missing = str(tmp_path / "x.rec")
    with pytest.raises(FileNotFoundError, match="x.rec"):
        tdata.RecordFileDataset(missing)
    with pytest.raises(FileNotFoundError, match="x.rec"):
        tv.ImageRecordDataset(missing)
    with pytest.raises(FileNotFoundError, match="x.rec"):
        jdata.RecordFileDataset(missing)


# -- io ------------------------------------------------------------------------

def _iter_batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([(_flat(b.data), _flat(b.label), b.pad) for b in it])
        it.reset()
    return out


def test_ndarrayiter_pad_matches_jax_with_shuffle():
    X, Y = _arrays(10)
    got = []
    for io in (jio, tio):
        onp.random.seed(5)
        got.append(_iter_batches(io.NDArrayIter(X, Y, batch_size=4,
                                                shuffle=True)))
    for je, te in zip(*got):
        assert len(je) == len(te) == 3
        for (jd, jl, jp), (td, tl, tp) in zip(je, te):
            onp.testing.assert_array_equal(td[0], jd[0])
            onp.testing.assert_array_equal(tl[0], jl[0])
            assert tp == jp
    assert got[1][0][-1][2] == 2


def test_ndarrayiter_discard_and_roll_over_follow_the_reference():
    X, Y = _arrays(10)
    jfull = [b for b in _iter_batches(jio.NDArrayIter(
        X, Y, batch_size=4, last_batch_handle="discard"), 1)[0]
        if b[0][0].shape[0] == 4]
    disc = _iter_batches(tio.NDArrayIter(X, Y, batch_size=4,
                                         last_batch_handle="discard"))
    for epoch in disc:
        assert len(epoch) == len(jfull) == 2
        for (jd, jl, _), (td, tl, tp) in zip(jfull, epoch):
            onp.testing.assert_array_equal(td[0], jd[0])
            assert tp == 0
    roll = _iter_batches(tio.NDArrayIter(X, Y, batch_size=4,
                                         last_batch_handle="roll_over"), 3)
    assert [len(e) for e in roll] == [2, 3, 2]
    first = roll[1][0]
    onp.testing.assert_array_equal(first[1][0], [8, 9, 0, 1])
    assert first[2] == 2
    onp.testing.assert_array_equal(roll[1][2][1][0], [6, 7, 8, 9])
    with pytest.raises(ValueError):
        tio.NDArrayIter(X, batch_size=4, last_batch_handle="nope")


def test_ndarrayiter_provide_data_and_multiple_arrays():
    X, Y = _arrays(6)
    it = tio.NDArrayIter({"a": X, "b": X * 2}, Y, batch_size=3)
    jit = jio.NDArrayIter({"a": X, "b": X * 2}, Y, batch_size=3)
    assert [(d.name, d.shape) for d in it.provide_data] == \
        [(d.name, d.shape) for d in jit.provide_data]
    assert [(d.name, d.shape) for d in it.provide_label] == \
        [(d.name, d.shape) for d in jit.provide_label]
    _same([b.data for b in jit], [b.data for b in it])


def test_resize_and_prefetching_iter_match_jax():
    X, Y = _arrays(8)
    got = []
    for io in (jio, tio):
        r = io.ResizeIter(io.NDArrayIter(X, Y, batch_size=3), 5)
        p = io.PrefetchingIter([io.NDArrayIter(X, Y, batch_size=4),
                                io.NDArrayIter(X * 3, Y, batch_size=4)])
        got.append(([_flat(b.data) for b in r],
                    [_flat(b.data) + _flat(b.label) for b in p]))
        p.reset()
        got[-1] += ([_flat(b.data) for b in p],)
    for j, t in zip(got[0], got[1]):
        assert len(j) == len(t)
        for jb, tb in zip(j, t):
            for a, b in zip(jb, tb):
                onp.testing.assert_array_equal(b, a)


def test_prefetching_iter_raises_a_fetch_error_at_next():
    class Boom(tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.provide_data = self.provide_label = []

        def next(self):
            raise KeyError("decode failed")

    it = tio.PrefetchingIter(Boom())
    with pytest.raises(KeyError, match="decode failed"):
        it.next()


def test_csv_and_mnist_iters_match_jax(tmp_path):
    rs = onp.random.RandomState(4)
    data = rs.rand(7, 6).astype("f")
    label = rs.randint(0, 3, (7, 1)).astype("f")
    onp.savetxt(tmp_path / "d.csv", data, delimiter=",", fmt="%.6f")
    onp.savetxt(tmp_path / "l.csv", label, delimiter=",", fmt="%.1f")
    got = []
    for io in (jio, tio):
        it = io.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                        label_csv=str(tmp_path / "l.csv"), batch_size=3)
        got.append([(_flat(b.data), _flat(b.label), b.pad) for b in it])
    for (jd, jl, jp), (td, tl, tp) in zip(*got):
        onp.testing.assert_allclose(td[0], jd[0], rtol=TOL)
        onp.testing.assert_array_equal(tl[0], jl[0])
        assert tp == jp
    imgs = rs.randint(0, 256, (9, 28, 28)).astype("uint8")
    lbls = rs.randint(0, 10, 9).astype("uint8")
    _write_idx(str(tmp_path / "img"), imgs)
    _write_idx(str(tmp_path / "lbl"), lbls)
    got = []
    for io in (jio, tio):
        it = io.MNISTIter(image=str(tmp_path / "img"),
                          label=str(tmp_path / "lbl"), batch_size=4,
                          shuffle=False, flat=True)
        got.append([(_flat(b.data), _flat(b.label)) for b in it])
    assert len(got[1]) == 2  # the short third batch is discarded
    for (jd, jl), (td, tl) in zip(got[0], got[1]):
        onp.testing.assert_array_equal(td[0], jd[0])
        onp.testing.assert_array_equal(tl[0], jl[0])


# -- transforms ------------------------------------------------------------------

def _img(seed=0, shape=(6, 8, 3)):
    return onp.random.RandomState(seed).randint(0, 256, shape).astype("uint8")


def _pair_img(a):
    return jnd.array(a, dtype=a.dtype), nd.array(a, ctx=mx.cpu())


def _cmp(t, j, uint8):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    if uint8:
        assert onp.abs(t.astype(int) - j.astype(int)).max() <= 1
    else:
        onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_to_tensor_normalize_cast_compose_match_jax():
    for shape in ((6, 8, 3), (2, 6, 8, 3)):
        a = _img(1, shape)
        ja, ta = _pair_img(a)
        _cmp(tT.ToTensor()(ta), jT.ToTensor()(ja), False)
        _cmp(tT.Cast("float16")(ta), jT.Cast("float16")(ja), False)
    a = _img(2)
    ja, ta = _pair_img(a)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    j = jT.Compose([jT.ToTensor(), jT.Normalize(mean, std)])(ja)
    t = tT.Compose([tT.ToTensor(), tT.Normalize(mean, std)])(ta)
    _cmp(t, j, False)


@pytest.mark.parametrize("size", [(12, 9), (4, 3), 5], ids=["up", "down", "sq"])
def test_resize_matches_jax_image_resize(size):
    a = _img(3, (6, 8, 3)).astype("f")
    ja, ta = jnd.array(a), nd.array(a, ctx=mx.cpu())
    j = _np(jT.Resize(size)(ja))
    t = _np(tT.Resize(size)(ta))
    assert t.shape == j.shape
    onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    u = _img(3, (2, 6, 8, 3))
    jb, tb = _pair_img(u)
    _cmp(tT.Resize(size)(tb), jT.Resize(size)(jb), True)


def test_crops_and_flips_match_jax():
    a = _img(4, (9, 11, 3))
    ja, ta = _pair_img(a)
    _cmp(tT.CenterCrop((5, 4))(ta), jT.CenterCrop((5, 4))(ja), True)
    _cmp(tT.CropResize(1, 2, 6, 5)(ta), jT.CropResize(1, 2, 6, 5)(ja), True)
    pytest.importorskip("PIL")
    _cmp(tT.CropResize(1, 2, 6, 5, size=(4, 3))(ta),
         jT.CropResize(1, 2, 6, 5, size=(4, 3))(ja), True)
    for cls in ("RandomFlipLeftRight", "RandomFlipTopBottom"):
        outs = []
        for T, x in ((jT, ja), (tT, ta)):
            random.seed(8)
            outs.append([_np(getattr(T, cls)()(x)) for _ in range(6)])
        for j, t in zip(*outs):
            onp.testing.assert_array_equal(t, j)
    outs = []
    for T, x in ((jT, jnd.array(a.astype("f"))),
                 (tT, nd.array(a.astype("f"), ctx=mx.cpu()))):
        random.seed(9)
        outs.append([_np(T.RandomResizedCrop(4)(x)) for _ in range(3)])
    for j, t in zip(*outs):
        onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,arg", [("RandomBrightness", 0.3),
                                      ("RandomContrast", 0.3),
                                      ("RandomSaturation", 0.3),
                                      ("RandomHue", 0.2)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_color_jitters_match_jax(name, arg, dtype):
    a = _img(5).astype(dtype)
    ja, ta = _pair_img(a)
    outs = []
    for T, x in ((jT, ja), (tT, ta)):
        random.seed(13)
        outs.append([getattr(T, name)(arg)(x) for _ in range(3)])
    for j, t in zip(*outs):
        _cmp(t, j, dtype == "uint8")


def test_color_jitter_and_lighting_match_jax():
    a = _img(6).astype("f")
    ja, ta = _pair_img(a)
    outs = []
    for T, x in ((jT, ja), (tT, ta)):
        random.seed(21)
        onp.random.seed(21)
        outs.append([T.RandomColorJitter(0.2, 0.2, 0.2, 0.1)(x),
                     T.RandomLighting(0.1)(x)])
    for j, t in zip(*outs):
        _cmp(t, j, False)
    u = _img(7)
    ju, tu = _pair_img(u)
    outs = []
    for T, x in ((jT, ju), (tT, tu)):
        onp.random.seed(22)
        outs.append(T.RandomLighting(0.1)(x))
    _cmp(outs[1], outs[0], True)


def test_transform_first_pipeline_through_the_loader():
    X = onp.random.RandomState(9).randint(0, 256, (8, 4, 4, 3)).astype(
        "uint8")
    Y = onp.arange(8, dtype="f")
    got = []
    for mod, T in ((jdata, jT), (tdata, tT)):
        ds = mod.ArrayDataset(X, Y).transform_first(T.ToTensor())
        got.append(list(mod.DataLoader(ds, batch_size=4)))
    for jb, tb in zip(*got):
        for j, t in zip(_flat(jb), _flat(tb)):
            onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
