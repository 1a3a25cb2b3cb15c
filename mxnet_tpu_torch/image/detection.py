"""The detection image pipeline: box-aware augmenters and
``ImageDetIter``.

The PyTorch counterpart of ``mxnet_tpu/image/detection.py`` (reference:
python/mxnet/image/detection.py). Labels use the reference's packed
format: [header_width, object_width, extra..., then per object (id,
xmin, ymin, xmax, ymax, ...)], coordinates normalized to [0, 1]. The
augmenters draw from Python's ``random``, as the JAX package's do, so
one seed gives both packages the same crops, pads and flips and the
same labels bit for bit; images stay host arrays (numpy arithmetic and
Pillow), and ``ImageDetIter`` emits host NDArrays, which a
``pipeline.DeviceFeed`` stages on the card.
"""
from __future__ import annotations

import json
import logging
import random as pyrandom

import numpy as onp

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc
from .image import (CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, ImageIter, RandomGrayAug,
                    ResizeAug, _host, _to_numpy, fixed_crop, imdecode,
                    imresize)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Reference: detection.py DetAugmenter; works on (image, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only Augmenter applied to the image, the label passed
    through (reference: detection.py:112)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and the boxes' x coordinates with probability ``p``
    (reference: detection.py:131)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = _host(_to_numpy(src)[:, ::-1].copy())
            label = label.copy()
            tmp = 1.0 - label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop whose kept boxes are covered by at least
    ``min_eject_coverage`` and one of them by ``min_object_covered``
    (reference: detection.py:164)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _to_numpy(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range) * h * w
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = int(round((area * ratio) ** 0.5))
            ch = int(round((area / ratio) ** 0.5))
            if cw > w or ch > h or cw <= 0 or ch <= 0:
                continue
            x0 = pyrandom.randint(0, w - cw)
            y0 = pyrandom.randint(0, h - ch)
            crop = (x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h)
            new_label = self._update_labels(label, crop)
            if new_label is None:
                continue
            return fixed_crop(arr, x0, y0, cw, ch), new_label
        return src, label

    def _update_labels(self, label, crop):
        cx0, cy0, cx1, cy1 = crop
        cw, chh = cx1 - cx0, cy1 - cy0
        out = []
        covered = False
        for row in label:
            box = row[1:5]
            inter = (max(box[0], cx0), max(box[1], cy0),
                     min(box[2], cx1), min(box[3], cy1))
            if inter[2] <= inter[0] or inter[3] <= inter[1]:
                continue
            barea = (box[2] - box[0]) * (box[3] - box[1])
            carea = (inter[2] - inter[0]) * (inter[3] - inter[1])
            coverage = carea / barea if barea > 0 else 0
            if coverage < self.min_eject_coverage:
                continue
            if coverage >= self.min_object_covered:
                covered = True
            new_row = row.copy()
            new_row[1] = (inter[0] - cx0) / cw
            new_row[2] = (inter[1] - cy0) / chh
            new_row[3] = (inter[2] - cx0) / cw
            new_row[4] = (inter[3] - cy0) / chh
            out.append(new_row)
        if not out or not covered:
            return None
        return onp.stack(out)


class DetRandomPadAug(DetAugmenter):
    """A random expansion onto a ``pad_val`` canvas (reference:
    detection.py:308)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _to_numpy(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            scale = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            nw = int(round((scale * h * w * ratio) ** 0.5))
            nh = int(round((scale * h * w / ratio) ** 0.5))
            if nw < w or nh < h:
                continue
            x0 = pyrandom.randint(0, nw - w)
            y0 = pyrandom.randint(0, nh - h)
            canvas = onp.empty((nh, nw, 3), arr.dtype)
            canvas[:] = onp.asarray(self.pad_val, arr.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = arr
            new_label = label.copy()
            new_label[:, 1] = (label[:, 1] * w + x0) / nw
            new_label[:, 2] = (label[:, 2] * h + y0) / nh
            new_label[:, 3] = (label[:, 3] * w + x0) / nw
            new_label[:, 4] = (label[:, 4] * h + y0) / nh
            return _host(canvas), new_label
        return src, label


class DetRandomSelectAug(DetAugmenter):
    """One of ``aug_list`` at random, or none with probability
    ``skip_prob`` (reference: detection.py:274)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       pca_noise=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """The reference's augmenter chain (detection.py CreateDetAugmenter):
    the same knobs in the same order."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


_DET_AUG_KEYS = ("resize", "rand_crop", "rand_pad", "rand_gray",
                 "rand_mirror", "mean", "std", "brightness", "contrast",
                 "saturation", "hue", "pca_noise", "inter_method",
                 "min_object_covered", "aspect_ratio_range", "area_range",
                 "min_eject_coverage", "max_attempts", "pad_val")


class ImageDetIter(ImageIter):
    """The detection iterator (reference: detection.py ImageDetIter).

    Labels come from the record header (the reference's ``pack_det``
    form) or the image list; each batch's are (batch, max_objects,
    object_width), -1 past an image's last object; ``max_objects`` is
    the largest count in the whole dataset."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", path_imgidx=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="label", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items() if k in _DET_AUG_KEYS})
        super().__init__(batch_size, data_shape, label_width=-1,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.det_auglist = aug_list
        self.max_objects, self.obj_width = self._infer_label_shape()

    def _parse_label(self, label):
        """A packed header label as (objects, object_width) (reference:
        detection.py _parse_label)."""
        raw = onp.asarray(label, "float32").reshape(-1)
        if raw.size < 2:
            raise MXNetError(f"label too short: {raw}")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        body = raw[header_width:]
        nobj = body.size // obj_width
        return body[:nobj * obj_width].reshape(nobj, obj_width)

    def _infer_label_shape(self):
        """The largest object count over the whole dataset (a capped scan
        would cut late samples' labels), and the object width."""
        pos = self.cur
        maxo, width = 0, 5
        while True:
            try:
                lab, _ = self.next_sample()
            except StopIteration:
                break
            parsed = self._parse_label(lab)
            maxo = max(maxo, parsed.shape[0])
            width = parsed.shape[1]
        self.cur = pos
        self.reset()
        return max(maxo, 1), width

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size, self.max_objects,
                          self.obj_width))]

    def next(self):
        H, W = self.data_shape[1], self.data_shape[2]
        data = onp.zeros((self.batch_size, H, W, 3), "float32")
        labels = onp.full((self.batch_size, self.max_objects,
                           self.obj_width), -1.0, "float32")
        i = 0
        pad = 0
        while i < self.batch_size:
            try:
                lab, img = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                pad = self.batch_size - i
                break
            try:
                arr = imdecode(img)
            except Exception as e:  # a corrupt image: skipped, as reference
                logging.debug("skipping corrupted image: %s", e)
                continue
            parsed = self._parse_label(lab)
            for aug in self.det_auglist:
                arr, parsed = aug(arr, parsed)
            a = _to_numpy(arr)
            if a.shape[:2] != (H, W):
                a = _to_numpy(imresize(a, W, H))
            data[i] = a.astype("float32")
            nobj = min(parsed.shape[0], self.max_objects)
            labels[i, :nobj] = parsed[:nobj]
            i += 1
        return DataBatch([_host(onp.transpose(data, (0, 3, 1, 2)))],
                         [_host(labels)], pad=pad)
