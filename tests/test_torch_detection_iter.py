"""``mx.image``'s detection pipeline in the PyTorch port against the JAX
package's, on the CPU: each box-aware augmenter, ``CreateDetAugmenter``
and ``ImageDetIter`` over a small detection .rec (``pack_det`` labels,
written by ``tools/profile_detiter.write_det_records``).

Both packages draw from Python's ``random`` (and numpy's) under the same
seed and run the same numpy and Pillow arithmetic on the host, so the
labels must be equal bit for bit and the pixels within 1e-5 (absolute,
on mean/std-normalized values of magnitude about 2; uint8 images
exactly)."""
import random as pyrandom

import numpy as onp
import pytest

from mxnet_tpu import image as jimage

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.tools import profile_detiter as pdi

CPU = mx.cpu()
PIXEL_TOL = 1e-5


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("det") / "det.rec")
    return pdi.write_det_records(path, n=11, seed=4, sides=(40, 72))


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _sample(seed=0):
    rs = onp.random.RandomState(seed)
    img = rs.randint(0, 255, (48, 64, 3)).astype("uint8")
    label = onp.array([[1, 0.1, 0.2, 0.5, 0.6], [3, 0.4, 0.1, 0.9, 0.7],
                       [0, 0.6, 0.5, 0.8, 0.95]], "float32")
    return img, label


def _pair(j, t, what):
    (jimg, jlab), (timg, tlab) = j, t
    jimg, timg = _np(jimg), _np(timg)
    assert jimg.shape == timg.shape and jimg.dtype == timg.dtype, what
    if jimg.dtype.kind in "ui":
        onp.testing.assert_array_equal(timg, jimg, err_msg=what)
    else:
        onp.testing.assert_allclose(timg, jimg, rtol=0, atol=PIXEL_TOL,
                                    err_msg=what)
    assert jlab.dtype == tlab.dtype and jlab.shape == tlab.shape, what
    onp.testing.assert_array_equal(tlab, jlab, err_msg=what)


AUGS = {
    "flip": lambda m: m.DetHorizontalFlipAug(1.0),
    "crop": lambda m: m.DetRandomCropAug(min_object_covered=0.3,
                                         area_range=(0.2, 1.0)),
    "pad": lambda m: m.DetRandomPadAug(area_range=(1.2, 2.5),
                                       pad_val=(10, 20, 30)),
    "select": lambda m: m.DetRandomSelectAug(
        [m.DetRandomCropAug(), m.DetHorizontalFlipAug(1.0)], 0.2),
    "borrow_resize": lambda m: m.DetBorrowAug(m.ForceResizeAug((33, 21))),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_det_augmenters_match_jax(name):
    outs = []
    for m in (jimage, timage):
        pyrandom.seed(9)
        onp.random.seed(9)
        aug = AUGS[name](m)
        img, label = _sample()
        got = [aug(img, label) for _ in range(4)]
        outs.append(got)
        assert aug.dumps()
    for k, (j, t) in enumerate(zip(*outs)):
        _pair(j, t, f"{name} draw {k}")


def test_create_det_augmenter_lists_match():
    kw = dict(resize=64, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
              mean=True, std=True, brightness=0.1, hue=0.1, rand_gray=0.1)
    j = jimage.CreateDetAugmenter((3, 32, 32), **kw)
    t = timage.CreateDetAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    assert [a.dumps() for a in t] == [a.dumps() for a in j]
    assert set(timage.detection.__all__) == set(jimage.detection.__all__)


@pytest.mark.parametrize("aug", [
    pdi.AUG, dict(resize=48, rand_crop=1, rand_mirror=True),
    dict(brightness=0.2, contrast=0.2, saturation=0.2, rand_gray=0.3)],
    ids=["ssd", "resize_crop", "jitter"])
def test_image_det_iter_matches_jax(rec, aug):
    shape = (3, 32, 40)
    runs = []
    for m in (jimage, timage):
        it = pdi.det_iter(m, rec, batch=4, seed=5, shape=shape, **aug)
        batches = [it.next() for _ in range(3)]  # 11 images: a padded third
        it.reset()
        batches.append(it.next())
        runs.append((it, batches))
    (jit, jb), (tit, tb) = runs
    assert tit.provide_label[0].shape == jit.provide_label[0].shape == \
        (4, 5, 5)
    assert tit.provide_data[0].shape == (4,) + shape
    for k, (j, t) in enumerate(zip(jb, tb)):
        assert t.pad == j.pad
        assert t.data[0].context == CPU
        _pair((j.data[0], j.label[0].asnumpy()),
              (t.data[0], t.label[0].asnumpy()), f"batch {k}")
        assert pdi.label_faults(t.label[0].asnumpy()) == []
    assert tb[2].pad == 1


def test_ssd_iterator_repeats_under_one_seed(rec):
    """What the card's SSD phase relies on: the same seed gives the same
    first batch's labels, another seed other crops."""
    def first(seed):
        return pdi.det_iter(timage, rec, batch=4, seed=seed,
                            shape=(3, 30, 30)).next().label[0].asnumpy()

    onp.testing.assert_array_equal(first(2), first(2))
    assert not onp.array_equal(first(2), first(3))
