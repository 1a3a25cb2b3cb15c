"""``mx.image`` of the port against the JAX package's: decode, resize and
crop functions, every augmenter in ``__all__`` and ``CreateAugmenter``
under the same ``random``/``numpy`` seeds, and ``ImageIter`` over a .rec
and over an image list.

Both run the same numpy and PIL arithmetic on the host: integer results
must be equal, float ones within 1e-5 relative (numpy float32 in both;
JAX's own arrays only carry the results)."""
import json
import random as pyrandom
from io import BytesIO

import numpy as onp
import pytest
from PIL import Image

from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timage

CPU = mx.cpu()


def _img(seed=0, h=40, w=52):
    return onp.random.RandomState(seed).randint(0, 255, (h, w, 3), "uint8")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(j, t, rtol=1e-5):
    j, t = _np(j), _np(t)
    assert j.shape == t.shape and j.dtype == t.dtype
    if j.dtype.kind in "ui":
        onp.testing.assert_array_equal(t, j)
    else:
        onp.testing.assert_allclose(t, j, rtol=rtol, atol=1e-4)


def _seeded(fn, seed=3):
    pyrandom.seed(seed)
    onp.random.seed(seed)
    return fn()


def _jpeg_bytes(arr, fmt="JPEG"):
    buf = BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def test_every_name_is_ported():
    assert set(timage.image.__all__) == set(jimage.image.__all__)
    for name in jimage.image.__all__:
        assert hasattr(timage, name), name


@pytest.mark.parametrize("flag,to_rgb", [(1, 1), (1, 0), (0, 1)])
@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_imdecode_and_imread_equal_jax(tmp_path, flag, to_rgb, fmt):
    blob = _jpeg_bytes(_img(), fmt)
    t = timage.imdecode(blob, flag=flag, to_rgb=to_rgb)
    assert t.context == CPU
    _same(jimage.imdecode(blob, flag=flag, to_rgb=to_rgb), t)
    path = tmp_path / "x.img"
    path.write_bytes(blob)
    _same(jimage.imread(str(path), flag=flag, to_rgb=to_rgb),
          timage.imread(str(path), flag=flag, to_rgb=to_rgb))


FUNCTIONS = {
    "imresize_bilinear": lambda m, x: m.imresize(x, 30, 20, 1),
    "imresize_area_auto": lambda m, x: m.imresize(x, 13, 11, 9),
    "imresize_random": lambda m, x: m.imresize(x, 64, 48, 10),
    "resize_short": lambda m, x: m.resize_short(x, 24),
    "fixed_crop": lambda m, x: m.fixed_crop(x, 3, 5, 20, 18),
    "fixed_crop_resized": lambda m, x: m.fixed_crop(x, 3, 5, 20, 18,
                                                    (16, 16)),
    "random_crop": lambda m, x: m.random_crop(x, (24, 20)),
    "center_crop": lambda m, x: m.center_crop(x, (24, 20)),
    "random_size_crop": lambda m, x: m.random_size_crop(
        x, (24, 24), (0.08, 1.0), (0.75, 1.33)),
    "color_normalize": lambda m, x: m.color_normalize(
        x.astype("float32") if hasattr(x, "astype") else x,
        onp.array([120.0, 110.0, 100.0], "f"),
        onp.array([50.0, 60.0, 70.0], "f")),
    "copyMakeBorder": lambda m, x: m.copyMakeBorder(x, 1, 2, 3, 4,
                                                    value=7.0),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functions_equal_jax(name):
    fn = FUNCTIONS[name]
    x = _img(1)
    j = _seeded(lambda: fn(jimage, x))
    t = _seeded(lambda: fn(timage, x))
    if isinstance(j, tuple):
        assert j[1] == t[1]
        j, t = j[0], t[0]
    _same(j, t)


def _augmenters(m):
    eigval = onp.array([55.46, 4.794, 1.148])
    eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])
    return {
        "ResizeAug": m.ResizeAug(30),
        "ForceResizeAug": m.ForceResizeAug((26, 22)),
        "RandomCropAug": m.RandomCropAug((24, 20)),
        "RandomSizedCropAug": m.RandomSizedCropAug((24, 24), (0.08, 1.0),
                                                   (0.75, 1.33)),
        "CenterCropAug": m.CenterCropAug((24, 20)),
        "HorizontalFlipAug": m.HorizontalFlipAug(0.9),
        "CastAug": m.CastAug(),
        "ColorNormalizeAug": m.ColorNormalizeAug(
            onp.array([120.0, 110.0, 100.0]), onp.array([50.0, 60.0, 70.0])),
        "BrightnessJitterAug": m.BrightnessJitterAug(0.4),
        "ContrastJitterAug": m.ContrastJitterAug(0.4),
        "SaturationJitterAug": m.SaturationJitterAug(0.4),
        "HueJitterAug": m.HueJitterAug(0.3),
        "ColorJitterAug": m.ColorJitterAug(0.3, 0.3, 0.3),
        "LightingAug": m.LightingAug(0.1, eigval, eigvec),
        "RandomGrayAug": m.RandomGrayAug(0.9),
        "SequentialAug": m.SequentialAug([m.CastAug(),
                                          m.BrightnessJitterAug(0.2)]),
        "RandomOrderAug": m.RandomOrderAug([m.CastAug(),
                                            m.ContrastJitterAug(0.2),
                                            m.HueJitterAug(0.1)]),
    }


@pytest.mark.parametrize("name", sorted(_augmenters(jimage)))
def test_augmenter_equals_jax_under_one_seed(name):
    x = _img(2).astype("float32") if name not in (
        "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
        "RandomSizedCropAug") else _img(2)
    jaug, taug = _augmenters(jimage)[name], _augmenters(timage)[name]
    for seed in (0, 1, 2):
        j = _seeded(lambda: jaug(_jnd(x)), seed)
        t = _seeded(lambda: taug(_tnd(x)), seed)
        _same(j, t)
    jd, td = jaug.dumps(), taug.dumps()
    assert (json.loads(jd) if isinstance(jd, str) else jd) == \
        (json.loads(td) if isinstance(td, str) else td)


def _jnd(x):
    from mxnet_tpu import nd

    return nd.array(x, dtype=str(x.dtype))


def _tnd(x):
    from mxnet_tpu_torch import nd

    return nd.array(x, dtype=str(x.dtype), ctx=CPU)


CREATE_CASES = {
    "plain": dict(),
    "resize_rand_crop_mirror": dict(resize=30, rand_crop=True,
                                    rand_mirror=True),
    "rand_resize": dict(rand_crop=True, rand_resize=True),
    "color": dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1,
                  pca_noise=0.05, rand_gray=0.3),
    "mean_std_true": dict(mean=True, std=True),
}


@pytest.mark.parametrize("case", sorted(CREATE_CASES))
def test_create_augmenter_equals_jax(case):
    kw = CREATE_CASES[case]
    jl = jimage.CreateAugmenter((3, 24, 24), **kw)
    tl = timage.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in jl] == [type(a).__name__ for a in tl]
    x = _img(4)

    def run(mod, augs, arr):
        for a in augs:
            arr = a(arr)
        return arr

    for seed in (0, 5):
        _same(_seeded(lambda: run(jimage, jl, _jnd(x)), seed),
              _seeded(lambda: run(timage, tl, _tnd(x)), seed))


def test_create_augmenter_refuses_what_jax_refuses():
    # the JAX package asserts; the port raises MXNetError (asserts vanish
    # under python -O)
    for kw in (dict(rand_resize=True), dict(mean=onp.array([-1.0, 0, 0]))):
        with pytest.raises(AssertionError):
            jimage.CreateAugmenter((3, 8, 8), **kw)
        with pytest.raises(mx.MXNetError):
            timage.CreateAugmenter((3, 8, 8), **kw)


def _write_rec(tmp_path, n=7):
    path = str(tmp_path / "img.rec")
    w = jrio.MXIndexedRecordIO(str(tmp_path / "img.idx"), path, "w")
    for i in range(n):
        w.write_idx(i, jrio.pack(jrio.IRHeader(0, float(i % 4), i, 0),
                                 _jpeg_bytes(_img(10 + i, 36, 44))))
    w.close()
    return path


def _iter_batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_image_iter_over_a_rec_equals_jax(tmp_path, handle):
    rec = _write_rec(tmp_path)
    kw = dict(batch_size=3, data_shape=(3, 24, 24), path_imgrec=rec,
              shuffle=True, rand_crop=True, rand_mirror=True,
              last_batch_handle=handle, mean=True, std=True)
    j = _seeded(lambda: _iter_batches(jimage.ImageIter(**kw)))
    t = _seeded(lambda: _iter_batches(timage.ImageIter(**kw)))
    assert len(j) == len(t) > 0
    for (jx, jy, jp), (tx, ty, tp) in zip(j, t):
        assert jp == tp
        onp.testing.assert_array_equal(jy, ty)
        onp.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-4)


def test_image_iter_over_an_image_list_equals_jax(tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    items = []
    for i in range(5):
        (root / f"{i}.png").write_bytes(_jpeg_bytes(_img(20 + i), "PNG"))
        items.append([float(i % 2), float(i), f"{i}.png"])
    kw = dict(batch_size=2, data_shape=(3, 20, 20), imglist=items,
              path_root=str(root), label_width=2, resize=24)
    j = _iter_batches(jimage.ImageIter(**kw), 1)
    t = _iter_batches(timage.ImageIter(**kw), 1)
    assert len(j) == len(t) == 3
    for (jx, jy, jp), (tx, ty, tp) in zip(j, t):
        assert jp == tp
        onp.testing.assert_array_equal(jy, ty)
        onp.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-4)
