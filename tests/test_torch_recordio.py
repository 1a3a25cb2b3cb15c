"""The record pipeline of the port against the JAX package's: ``.rec``
files (``recordio``), the record datasets, ``tools/im2rec``, the
``ImageRecordIter`` and ``ImageDetRecordIter`` batches, the libjpeg route
of ``csrc/recordio.cc`` and the plain twin of the card's crop kernel
(``kernels/jpeg_decode.py``), and the slice as a whole: a narrow ResNet
v1 trained from one ``.rec`` by both packages.

Tolerances: files, labels, padding and the uint8 decode are compared
for equality (the same libjpeg code runs in both packages' native
libraries); the normalized float batches within 1e-6 (the same float32
subtract, divide and multiply); the slice's losses within 1e-4 (float32
through two frameworks' convolutions over two steps).
"""
import os
import pickle
from io import BytesIO

import numpy as onp
import pytest
from PIL import Image

from mxnet_tpu import _native as jnative
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrio
from mxnet_tpu.io import image_record as jir

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import image_record as tir
from mxnet_tpu_torch.kernels import jpeg_decode as jd

CPU = mx.cpu()
MEAN = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94, std_r=58.4,
            std_g=57.1, std_b=57.4)


def _jpeg(rng, h, w, quality=90):
    buf = BytesIO()
    Image.fromarray(rng.randint(0, 255, (h, w, 3), "uint8")).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _write(mod, path, n=10, sizes=((40, 48), (48, 40), (44, 44)),
           label_width=1, seed=0):
    """n JPEG records of varied sizes from ``seed``, written by ``mod``."""
    rng = onp.random.RandomState(seed)
    w = mod.MXIndexedRecordIO(str(path) + ".idx", str(path), "w")
    for i in range(n):
        h, wd = sizes[i % len(sizes)]
        label = float(i % 3) if label_width == 1 else \
            [float(i), 1.0 + i, 2.0]
        w.write_idx(i, mod.pack(mod.IRHeader(0, label, i, 0),
                                _jpeg(rng, h, wd)))
    w.close()
    return str(path)


@pytest.fixture
def rec(tmp_path):
    return _write(jrio, tmp_path / "imgs.rec")


# -- files --------------------------------------------------------------------

def test_rec_files_are_byte_equal(tmp_path):
    j = _write(jrio, tmp_path / "j.rec", label_width=2)
    t = _write(trio, tmp_path / "t.rec", label_width=2)
    for ext in ("", ".idx"):
        with open(j + ext, "rb") as f, open(t + ext, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("writer,reader", [(jrio, trio), (trio, jrio)])
def test_each_package_reads_the_others_records(tmp_path, writer, reader):
    magic = bytes.fromhex("0a23d7ce")  # the frame magic inside a payload
    payloads = [b"", b"abc", magic, b"x" + magic + b"yz" + magic,
                os.urandom(1001) + magic + os.urandom(3)]
    path = str(tmp_path / "p.rec")
    w = writer.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    r = reader.MXRecordIO(path, "r")
    got = []
    while True:
        item = r.read()
        if item is None:
            break
        got.append(item)
    r.close()
    assert got == payloads


def test_pack_and_unpack_equal_jax():
    for header, payload in [((0, 3.0, 7, 0), b"img"),
                            ((0, [1.0, 2.5, -3.0], 9, 1), b""),
                            ((0, onp.arange(4, dtype="f"), 2, 5), b"\0\1")]:
        j, t = jrio.pack(header, payload), trio.pack(header, payload)
        assert j == t
        jh, jp = jrio.unpack(j)
        th, tp = trio.unpack(t)
        assert jp == tp and tuple(jh)[2:] == tuple(th)[2:]
        onp.testing.assert_array_equal(jh.label, th.label)


def test_pack_img_and_unpack_img_equal_jax():
    img = onp.random.RandomState(3).randint(0, 255, (20, 30, 3), "uint8")
    for fmt in (".jpg", ".png"):
        j = jrio.pack_img((0, 1.0, 0, 0), img, quality=80, img_fmt=fmt)
        t = trio.pack_img((0, 1.0, 0, 0), img, quality=80, img_fmt=fmt)
        assert j == t
        for flag in (-1, 0, 1):
            onp.testing.assert_array_equal(jrio.unpack_img(j, flag)[1],
                                           trio.unpack_img(t, flag)[1])


def test_readers_pickle_at_their_position(rec):
    r = trio.MXIndexedRecordIO(rec + ".idx", rec, "r")
    r.read()
    clone = pickle.loads(pickle.dumps(r))
    assert clone.read() == r.read()
    assert clone.keys == list(range(10))
    w = trio.MXRecordIO(os.path.join(os.path.dirname(rec), "w.rec"), "w")
    with pytest.raises(RuntimeError, match="writable"):
        pickle.dumps(w)
    w.close()
    with pytest.raises(ValueError):
        r.write(b"x")


def test_record_datasets_equal_jax(tmp_path):
    from mxnet_tpu.gluon.data import RecordFileDataset as JRecords
    from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JImages
    from mxnet_tpu_torch.gluon.data import RecordFileDataset
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset

    # the datasets read the index beside the file: data.rec, data.idx
    rec = _write(jrio, tmp_path / "data.rec")
    os.replace(rec + ".idx", str(tmp_path / "data.idx"))
    j, t = JRecords(rec), RecordFileDataset(rec)
    assert len(j) == len(t) == 10
    assert [j[i] for i in range(10)] == [t[i] for i in range(10)]
    for flag in (0, 1):
        ji, ti = JImages(rec, flag=flag), ImageRecordDataset(rec, flag=flag)
        for i in (0, 4, 9):
            (ja, jl), (ta, tl) = ji[i], ti[i]
            assert ta.context == CPU
            onp.testing.assert_array_equal(ja.asnumpy(), ta.asnumpy())
            assert float(jl) == float(tl)


def test_im2rec_equals_jax(tmp_path):
    from mxnet_tpu.tools import im2rec as jtool
    from mxnet_tpu_torch.tools import im2rec as ttool

    rng = onp.random.RandomState(1)
    root = tmp_path / "imgs"
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for k in range(3):
            (root / cls / f"{k}.jpg").write_bytes(_jpeg(rng, 24, 30))
    out = {}
    for name, tool in (("j", jtool), ("t", ttool)):
        d = tmp_path / name
        d.mkdir()
        lsts = tool.make_list(str(root), str(d / "data"), train_ratio=0.5)
        for lst in lsts:
            tool.im2rec(lst, str(root), lst[:-4], resize=16)
        out[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert out["j"] == out["t"] and len(out["t"]) == 6


# -- the iterators ------------------------------------------------------------

def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


ITER_CASES = {
    "center": dict(),
    "shuffled_random_crop_mirror": dict(shuffle=True, rand_crop=True,
                                        rand_mirror=True, seed=11),
    "resize_short": dict(resize=36, rand_crop=True, seed=3),
    "no_round_batch": dict(round_batch=False, shuffle=True, seed=5),
    "part_1_of_3": dict(part_index=1, num_parts=3),
    "scale": dict(scale=1.0 / 255, prefetch_buffer=3,
                  preprocess_threads=3),
}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_image_record_iter_equals_jax(rec, case):
    kw = dict(data_shape=(3, 32, 32), batch_size=4, path_imgidx=rec + ".idx",
              **MEAN, **ITER_CASES[case])
    j = _batches(jio.ImageRecordIter(rec, **kw))
    it = tio.ImageRecordIter(rec, **kw)
    assert it.decoder == "libjpeg"
    t = _batches(it)
    it.close()
    assert len(j) == len(t) > 0
    for (jx, jy, jp), (tx, ty, tp) in zip(j, t):
        assert jx.shape == tx.shape and jp == tp
        onp.testing.assert_array_equal(jy, ty)
        onp.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)


def test_det_record_iter_labels_equal_jax(tmp_path):
    rec = _write(jrio, tmp_path / "det.rec", n=6, label_width=3)
    kw = dict(data_shape=(3, 32, 32), batch_size=4, label_pad_width=8,
              path_imgidx=rec + ".idx")
    j = _batches(jio.ImageDetRecordIter(rec, **kw), 1)
    t = _batches(tio.ImageDetRecordIter(rec, **kw), 1)
    for (jx, jy, jp), (tx, ty, tp) in zip(j, t):
        onp.testing.assert_array_equal(jy, ty)
        assert jp == tp
        onp.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)


def test_native_decode_is_bitwise_the_jax_librarys(rec):
    """The port's csrc/recordio.cc and the JAX package's native/recordio.cc
    decode the same records to the same bytes (resize, crops, mirror)."""
    if jnative.lib is None:
        pytest.skip("the JAX package's native library did not build")
    blobs = [trio.unpack(r)[1] for r in
             (trio.MXIndexedRecordIO(rec + ".idx", rec, "r").read_idx(k)
              for k in range(10))]
    rs = onp.random.RandomState(0)
    crops = onp.stack([rs.randint(0, 10001, 10), rs.randint(0, 10001, 10),
                       rs.randint(0, 2, 10)], 1).astype(onp.int32)
    for resize in (0, 36, 20):
        class Dummy:
            preprocess_threads = 2
            resize = None
        d = Dummy()
        d.resize = resize
        want = jir.ImageRecordIter._decode(d, blobs, 28, 28, crops)
        got = tir._decode_libjpeg(blobs, 28, 28, resize, crops, 2)
        assert got.dtype == onp.uint8
        onp.testing.assert_array_equal(got, want)


def test_python_twin_equals_jax(rec):
    blobs = [trio.unpack(trio.MXIndexedRecordIO(rec + ".idx", rec, "r")
                         .read_idx(k))[1] for k in range(6)]
    crops = [(-1, -1, 0), (0, 10000, 1), (5000, 2500, 0)] * 2
    for resize in (0, 36):
        onp.testing.assert_array_equal(
            tir._decode_batch_python(blobs, 28, 28, resize, crops),
            jir._decode_batch_python(blobs, 28, 28, resize, crops))


def test_index_scan_equals_jax(rec):
    assert tir._index_offsets(rec) == jir._index_offsets(rec)
    assert tir._index_offsets(rec, rec + ".idx") == \
        jir._index_offsets(rec, rec + ".idx")


def test_undecodable_record_raises(tmp_path):
    """A record that does not decode raises at the next() that waits for
    it (the JAX package's native route zero-fills it); reset() recovers
    with fresh vars."""
    path = str(tmp_path / "bad.rec")
    rng = onp.random.RandomState(0)
    w = trio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(4):
        blob = b"not a jpeg" if i == 2 else _jpeg(rng, 40, 40)
        w.write_idx(i, trio.pack(trio.IRHeader(0, float(i), i, 0), blob))
    w.close()
    it = tio.ImageRecordIter(path, data_shape=(3, 32, 32), batch_size=2,
                             path_imgidx=path + ".idx")
    it.next()
    with pytest.raises(MXNetError, match="did not decode"):
        it.next()
    it.reset()
    it.next()
    it.close()


def test_iterator_recovers_after_a_failed_decode(rec):
    it = tio.ImageRecordIter(rec, data_shape=(3, 32, 32), batch_size=4,
                             path_imgidx=rec + ".idx")
    assert sum(1 for _ in it) == 3
    orig, calls = it._decode, {"n": 0}

    def boom(blobs, H, W, crops):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("corrupt record")
        return orig(blobs, H, W, crops)

    it._decode = boom
    it.reset()
    with pytest.raises(ValueError, match="corrupt record"):
        for _ in it:
            pass
    it.reset()
    assert sum(1 for _ in it) == 3
    it.close()


def test_libsvm_iter_names_what_it_waits_for():
    with pytest.raises(MXNetError, match="sparse"):
        tio.LibSVMIter("x.libsvm", (4,), 2)


# -- the card's route, on the CPU: the crop kernel's plain version -------------

def _full(blob):
    """The full-size RGB pixels of a JPEG through the port's libjpeg."""
    im = Image.open(BytesIO(blob))
    w, h = im.size
    return _native_decode(blob, h, w, 0, (-1, -1, 0)), (w, h)


def _native_decode(blob, H, W, resize, crop):
    return tir._decode_libjpeg([blob], H, W, resize,
                               onp.array([crop], onp.int32), 1)[0]


# (h, w) of the JPEGs, the crop (H, W): the first three at 28 x 28; then
# rows of 99 and 120 bytes (not multiples of 16) from images of mixed
# sizes whose 97 x 61 members put the next image at an odd byte offset
_CROP_SHAPES = {
    "": ([(40, 48), (52, 40), (44, 44)], 28, 28),
    "w33-": ([(61, 97), (40, 48), (61, 97), (44, 50)], 20, 33),
    "w40-": ([(61, 97), (52, 40), (61, 97), (70, 50)], 24, 40),
}


@pytest.mark.parametrize("shape,resize", [
    pytest.param(shape, resize, id=f"{shape}{resize}")
    for shape in _CROP_SHAPES for resize in (0, 36, 50)])
def test_crop_plain_version_is_bitwise_the_libjpeg_route(shape, resize):
    """From the same full-size pixels the crop kernel's plain version
    (the kernel's arithmetic op by op) gives libjpeg's decode_one bit for
    bit wherever libjpeg scales by 1 (no DCT scaling), at any crop width
    and for images packed at any byte offset."""
    import torch

    hws, H, W = _CROP_SHAPES[shape]
    rng = onp.random.RandomState(7)
    blobs = [_jpeg(rng, h, w) for h, w in hws]
    crops = onp.array([[-1, -1, 0], [2500, 10000, 1], [10000, 0, 1],
                       [5000, 5000, 0]][:len(blobs)], onp.int32)
    fulls = [_full(b) for b in blobs]
    src = torch.from_numpy(onp.concatenate([f.ravel() for f, _ in fulls]))
    plan = jd.crop_plan([s for _, s in fulls], H, W, resize, crops)
    assert (plan[:, 3] == 1).all()
    got = jd.jpeg_crop(src, plan, H, W)
    for i, blob in enumerate(blobs):
        onp.testing.assert_array_equal(
            got[i].numpy(), _native_decode(blob, H, W, resize, crops[i]))


def test_crop_kinds_name_the_kernels_a_plan_needs():
    """No resize at scale 1 is the copy kernel's (1); a resize, or
    libjpeg's scale with no resize after it, the scaled kernel's (2)."""
    crops = onp.full((2, 3), -1, onp.int32)
    copy = jd.crop_plan([(40, 40), (50, 45)], 28, 28, 0, crops)
    resized = jd.crop_plan([(40, 40), (100, 130)], 28, 28, 36, crops)
    scaled = jd.crop_plan([(130, 100)], 28, 28, 50, crops[:1])
    assert scaled[0, 3] == 2 and tuple(scaled[0, 4:6]) == tuple(
        scaled[0, 6:8])
    assert jd.crop_kinds(copy) == 1
    assert jd.crop_kinds(resized) == 2
    assert jd.crop_kinds(scaled) == 2
    assert jd.crop_kinds(onp.concatenate([copy, resized])) == 3


def test_decode_buffer_holds_the_crop_kernels_padding():
    """``decode_full`` packs the images where ``crop_plan`` says they lie
    and leaves CROP_PAD bytes after the last: the crop kernel stages each
    source row as the 16-byte-aligned run that encloses it, and those
    runs end inside the buffer (a 16-byte-aligned base, as the card's
    allocator gives)."""
    sizes = [(97, 61), (252, 252), (33, 17), (97, 61), (5, 3)]
    offs, nbytes = jd.decode_layout(sizes)
    plan = jd.crop_plan(sizes, 3, 5, 0, onp.full((5, 3), -1, onp.int32))
    assert offs.tolist() == plan[:, 0].tolist()
    px = [w * h * 3 for w, h in sizes]
    assert nbytes == sum(px) + jd.CROP_PAD and jd.CROP_PAD >= 15
    assert offs[1] % 2 == 1  # the next image starts at an odd byte
    # every row's run ends at or before the last row's, whose end is the
    # 16-byte boundary at or after the last image's last byte
    run_end = -(-(offs[-1] + px[-1]) // 16) * 16
    assert run_end <= nbytes
    assert run_end > sum(px)  # the pixels alone would leave it outside


def test_crop_bound_counts_the_source_under_the_taps():
    """The crop kernels' byte bound (``tools/profile_records.py``) reads
    the full-size pixels under the plain version's taps and no others:
    the crop itself with no resize; with one, the scaled rows and columns
    its taps reach, each a denom x denom block cut at the image's edge."""
    import torch

    from mxnet_tpu_torch.tools import profile_records as pr

    sizes = [(500, 375), (375, 500), (97, 61), (130, 100), (300, 290),
             (252, 252), (40, 30)]
    rs = onp.random.RandomState(3)
    crops = onp.stack([rs.randint(-1, 10001, len(sizes)),
                       rs.randint(-1, 10001, len(sizes)),
                       rs.randint(0, 2, len(sizes))], 1).astype(onp.int32)
    H, W = 28, 33
    for resize in (0, 36, 100, 256):
        plan = jd.crop_plan(sizes, H, W, resize, crops)
        for row in plan:
            _, w, h, denom, sw, sh, tw, th, cy, cx, _ = row.tolist()
            oy, ox = torch.arange(cy, cy + H), torch.arange(cx, cx + W)

            def taps(o, s, t):  # _crop_ref's, in torch
                f = (o.to(torch.float32) + 0.5) * float(s) / torch.tensor(
                    float(t)) - 0.5
                i0 = torch.where(f < 0, 0, f.to(torch.int64))
                return torch.cat([i0, torch.clamp(i0 + 1, max=s - 1)])

            ys, xs = (oy, ox) if (tw, th) == (sw, sh) else (
                taps(oy, sh, th), taps(ox, sw, tw))
            under = onp.zeros((h, w), bool)
            for r in ys.unique().tolist():
                for c in xs.unique().tolist():
                    under[r * denom:(r + 1) * denom,
                          c * denom:(c + 1) * denom] = True
            assert pr.crop_source_bytes(row, H, W) == int(under.sum()) * 3, \
                (resize, row.tolist())
    plan = jd.crop_plan([(252, 252)] * 2, 224, 224, 0, crops[:2])
    assert pr.crop_bound_ms(plan, 224, 224) == (
        plan.size * 8 + 2 * 2 * 224 * 224 * 3) / pr.HBM_BYTES_PER_S * 1e3


def test_crop_plan_is_decode_ones():
    """libjpeg's scale, the resize and the crop corner as decode_one
    computes them: the largest power-of-two scale that keeps the short
    edge at or above resize_short (1/4 for 400 rows at 100); an image
    smaller than the crop is scaled up to cover it."""
    plan = jd.crop_plan([(500, 400), (100, 300), (30, 30)], 64, 64, 100,
                        onp.array([[-1, -1, 0], [5000, 10000, 1],
                                   [0, 0, 0]], onp.int32))
    assert plan[0].tolist() == [0, 500, 400, 4, 125, 100, 125, 100, 18,
                                30, 0]
    assert plan[1].tolist()[3:] == [1, 100, 300, 100, 300, 118, 36, 1]
    assert plan[2].tolist()[3:8] == [1, 30, 30, 100, 100]
    assert jd.crop_plan([(40, 40)], 64, 64, 0, onp.array(
        [[-1, -1, 0]]))[0].tolist()[3:10] == [1, 40, 40, 64, 64, 0, 0]


def test_crop_scaled_route_is_near_libjpeg():
    """Where libjpeg scales by 1/2 (DCT scaling), the kernel takes the
    rounded mean of each 2 x 2 block of the full-size pixels: within 12
    levels of 255 and a mean under 2 of libjpeg's scaled IDCT on these
    seeded images (the two keep the same low frequencies and round
    apart)."""
    import torch

    rng = onp.random.RandomState(9)
    smooth = onp.clip(onp.add.outer(onp.arange(96), onp.arange(96))[
        :, :, None] + rng.randint(0, 40, (96, 96, 3)), 0, 255)
    buf = BytesIO()
    Image.fromarray(smooth.astype("uint8")).save(buf, format="JPEG",
                                                 quality=90)
    blob = buf.getvalue()
    full, size = _full(blob)
    plan = jd.crop_plan([size], 40, 40, 40, onp.array([[-1, -1, 1]]))
    assert plan[0, 3] == 2
    got = jd.jpeg_crop(torch.from_numpy(full.ravel()),
                       torch.from_numpy(plan), 40, 40)[0].numpy()
    want = _native_decode(blob, 40, 40, 40, (-1, -1, 1))
    diff = onp.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 12 and diff.mean() < 2.0


def test_decoder_choice():
    assert _native.decoder() == "libjpeg"
    assert _native.io_lib().rio_has_jpeg() == 1
    assert not jd.available()  # no card here


# -- the slice as a whole ------------------------------------------------------

def test_narrow_resnet_trained_from_one_rec_equals_jax(tmp_path):
    """ResNet v1 ([8, 8, 16, 32, 64], basic blocks) trained 2 steps from
    one .rec by both packages through their ImageRecordIter, SGD 0.05 /
    0.9 / 1e-4, the port's weights carried from the JAX package's initial
    values; losses within 1e-4, the final weights within 1e-4."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu.gluon.model_zoo.vision.resnet import (BasicBlockV1 as JB,
                                                         ResNetV1 as JR)
    from mxnet_tpu_torch import autograd, convert, gluon
    from mxnet_tpu_torch.examples import train_imagenet_rec as ex

    rec = ex.synth_rec(str(tmp_path / "train.rec"), 16, 36, 10)
    kw = dict(data_shape=(3, 32, 32), batch_size=4, path_imgidx=rec + ".idx",
              shuffle=True, rand_crop=True, rand_mirror=True, **MEAN)
    jmx.random.seed(0)
    jnet = JR(JB, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10,
              thumbnail=True, prefix="rn_")
    jnet.initialize(jmx.init.Xavier())
    jit = jio.ImageRecordIter(rec, **kw)
    jnet(jit.next().data[0])
    jit.reset()
    init = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.05, "momentum": 0.9,
                          "wd": 1e-4})
    jlf = jgluon.loss.SoftmaxCrossEntropyLoss()
    jlosses = []
    for _ in range(2):
        b = jit.next()
        with jag.record():
            loss = jlf(jnet(b.data[0]), b.label[0]).mean()
        loss.backward()
        jtr.step(4)
        jlosses.append(float(loss.asscalar()))

    net = ex.build(CPU, 10, [8, 8, 16, 32, 64])
    it = ex.record_iter(rec, 4, 32, 2)
    net(it.next().data[0])
    it.reset()
    convert.params_from_numpy(net, init, ctx=CPU)
    tr = ex.make_trainer(net)
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(2):
        b = it.next()
        with autograd.record():
            loss = lf(net(b.data[0]), b.label[0]).mean()
        loss.backward()
        tr.step(4)
        losses.append(float(loss.asscalar()))
    it.close()
    onp.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    final = {k: p.data().asnumpy()
             for k, p in net._collect_params_with_prefix().items()}
    for k, p in jnet._collect_params_with_prefix().items():
        onp.testing.assert_allclose(final[k], p.data().asnumpy(),
                                    rtol=1e-4, atol=1e-4, err_msg=k)
