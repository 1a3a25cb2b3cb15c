"""Image decode and augmentation.

The PyTorch counterpart of ``mxnet_tpu/image/image.py`` (reference:
python/mxnet/image/image.py; imdecode backed by src/io/image_io.cc's
OpenCV kernels, ImageIter and the CreateAugmenter list). These keep the
JAX package's host semantics: numpy transforms, PIL for the container
formats, and the same ``random``/``numpy`` draws, so that seeded runs
agree. Every result is a host (CPU) NDArray, as the port's data
iterators give; ``pipeline.DeviceFeed`` stages batches onto the card.
The record iterators of ``io/image_record.py`` decode JPEGs through
libjpeg or nvJPEG instead.
"""
from __future__ import annotations

import io as _io
import logging
import os
import random as pyrandom

import numpy as onp

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import host_tensor
from ..io.io import DataIter, DataBatch, DataDesc
from .. import recordio

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "random_size_crop",
           "color_normalize", "copyMakeBorder",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "RandomGrayAug", "CreateAugmenter", "ImageIter"]


def _to_numpy(src):
    return src.asnumpy() if isinstance(src, NDArray) else onp.asarray(src)


def _host(arr, dtype=None):
    """A host NDArray of a numpy array (float64 narrowed to float32, as
    ``nd.array`` does)."""
    return NDArray(host_tensor(onp.ascontiguousarray(arr), dtype=dtype))


def imdecode(buf, flag=1, to_rgb=1, **kwargs):
    """Decode an image byte buffer to an HWC uint8 NDArray.

    Reference: image.py:imdecode → image_io.cc Imdecode (OpenCV). Here
    PIL handles the container formats; output is RGB (to_rgb, the
    reference's default) or BGR, flag=0 → grayscale HW1."""
    from PIL import Image

    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        arr = onp.asarray(img.convert("L"))[:, :, None]
    else:
        arr = onp.asarray(img.convert("RGB"))
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return _host(arr, "uint8")


def imread(filename, flag=1, to_rgb=1, **kwargs):
    """Reference: image.py:imread."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


_PIL_INTERP = None


def _interp_method(interp, sizes=()):
    """Reference interp codes (image.py:_get_interp_method): 0 nearest,
    1 bilinear, 2 bicubic, 3 area, 4 lanczos, 9 auto, 10 random."""
    global _PIL_INTERP
    from PIL import Image

    if _PIL_INTERP is None:
        R = Image.Resampling if hasattr(Image, "Resampling") else Image
        _PIL_INTERP = {0: R.NEAREST, 1: R.BILINEAR, 2: R.BICUBIC,
                       3: R.BOX, 4: R.LANCZOS}
    if interp == 9:
        if len(sizes) == 4:
            oh, ow, nh, nw = sizes
            interp = 1 if nh > oh and nw > ow else 3
        else:
            interp = 2
    elif interp == 10:
        interp = pyrandom.randint(0, 4)
    if interp not in _PIL_INTERP:
        raise MXNetError(f"unknown interp method {interp}")
    return _PIL_INTERP[interp]


def imresize(src, w, h, interp=1):
    """Reference: image.py:imresize."""
    from PIL import Image

    arr = _to_numpy(src)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    method = _interp_method(interp, (arr.shape[0], arr.shape[1], h, w))
    out = onp.asarray(img.resize((w, h), method))
    if out.ndim == 2:
        out = out[:, :, None]
    return _host(out, str(arr.dtype))


def resize_short(src, size, interp=2):
    """Resize so the SHORTER edge == size, preserving aspect
    (reference: image.py:resize_short)."""
    arr = _to_numpy(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Reference: image.py:fixed_crop."""
    arr = _to_numpy(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _to_numpy(imresize(out, size[0], size[1], interp))
    return _host(out, str(arr.dtype))


def random_crop(src, size, interp=2):
    """Reference: image.py:random_crop → (cropped, (x0, y0, w, h))."""
    arr = _to_numpy(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Reference: image.py:center_crop."""
    arr = _to_numpy(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, **kwargs):
    """Random area+aspect crop (reference: image.py:random_size_crop)."""
    arr = _to_numpy(src)
    h, w = arr.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        aspect = onp.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(arr, size, interp)


def color_normalize(src, mean, std=None):
    """Reference: image.py:color_normalize."""
    arr = _to_numpy(src).astype("float32")
    arr = arr - onp.asarray(_to_numpy(mean), "float32")
    if std is not None:
        arr = arr / onp.asarray(_to_numpy(std), "float32")
    return _host(arr)


def copyMakeBorder(src, top, bot, left, right, typ=0, value=0.0):
    """Constant-border pad (reference: image_io.cc ImdecodeImpl border)."""
    arr = _to_numpy(src)
    return _host(onp.pad(
        arr, ((top, bot), (left, right), (0, 0)),
        mode="constant", constant_values=value).astype(arr.dtype))


# ------------------------------------------------------------ augmenters

class Augmenter:
    """Reference: image.py:Augmenter — dumps() serializes config."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                self._kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, onp.ndarray):
                self._kwargs[k] = v.tolist()

    def dumps(self):
        import json

        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _host(_to_numpy(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_to_numpy(src).astype(self.typ))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else onp.asarray(
            _to_numpy(mean), "float32")
        self.std = None if std is None else onp.asarray(
            _to_numpy(std), "float32")

    def __call__(self, src):
        return color_normalize(src, self.mean if self.mean is not None
                               else 0.0, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _host(_to_numpy(src).astype("float32") * alpha)


_GRAY = onp.asarray([0.299, 0.587, 0.114], "float32")


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        arr = _to_numpy(src).astype("float32")
        gray = (arr * _GRAY).sum(axis=2).mean() * (1.0 - alpha)
        return _host(arr * alpha + gray)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        arr = _to_numpy(src).astype("float32")
        gray = (arr * _GRAY).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return _host(arr * alpha + gray)


class HueJitterAug(Augmenter):
    """YIQ-rotation hue jitter (reference: image.py:HueJitterAug, same
    tyiq/ityiq matrices)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], "float32")
        self.ityiq = onp.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], "float32")

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = onp.cos(alpha * onp.pi)
        w = onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       "float32")
        t = onp.dot(onp.dot(self.ityiq, bt), self.tyiq).T
        arr = _to_numpy(src).astype("float32")
        return _host(onp.dot(arr, t))


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting noise (reference: image.py:LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, "float32")
        self.eigvec = onp.asarray(eigvec, "float32")

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        return _host(_to_numpy(src).astype("float32") + rgb)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = onp.array([[0.21, 0.21, 0.21],
                              [0.72, 0.72, 0.72],
                              [0.07, 0.07, 0.07]], "float32")

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _host(onp.dot(
                _to_numpy(src).astype("float32"), self.mat))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference:
    image.py:CreateAugmenter — same ordering and defaults)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise MXNetError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = onp.asarray(_to_numpy(mean))
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = onp.asarray(_to_numpy(std))
    if mean is not None or std is not None:
        if mean is not None and not (mean >= 0).all():
            raise MXNetError("mean must be non-negative")
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# -------------------------------------------------------------- ImageIter

class ImageIter(DataIter):
    """Image iterator over .rec files or image lists with augmenters.

    Reference: image.py:ImageIter (:1121). Sources: ``path_imgrec`` (the
    native-decode fast path), or ``path_imglist``/``imglist`` + files
    under ``path_root`` (PIL decode). Emits NCHW float32 batches."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0,
                 num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", last_batch_handle="pad", **kwargs):
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(
                f"unknown last_batch_handle '{last_batch_handle}'")
        self._last_batch_handle = last_batch_handle
        self._rolled = []  # (label, raw) carried across epochs
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise MXNetError("data_shape must be (3, H, W)")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.dtype = dtype
        self._data_name = data_name
        self._label_name = label_name
        self._allow_read = True

        self.imgrec = None
        self.seq = None
        self.imglist = None
        if path_imgrec:
            self.imgrec = recordio.MXIndexedRecordIO(
                path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx",
                path_imgrec, "r") if (path_imgidx or os.path.exists(
                    os.path.splitext(path_imgrec)[0] + ".idx")) else \
                recordio.MXRecordIO(path_imgrec, "r")
            if isinstance(self.imgrec, recordio.MXIndexedRecordIO):
                self.seq = list(self.imgrec.keys)
        elif path_imglist or imglist is not None:
            self.imglist = {}
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        label = onp.array(parts[1:-1], "float32")
                        self.imglist[int(parts[0])] = (label, parts[-1])
            else:
                for i, item in enumerate(imglist):
                    label = onp.array(item[:-1], "float32").reshape(-1)
                    self.imglist[i] = (label, item[-1])
            self.seq = list(self.imglist.keys())
            self.path_root = path_root
        else:
            raise MXNetError(
                "need path_imgrec, path_imglist or imglist")
        if num_parts > 1:
            if self.seq is None:
                raise MXNetError(
                    "num_parts > 1 needs a sequence source (indexed "
                    ".rec or imglist) to partition — plain .rec without "
                    "an .idx cannot be split")
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize",
                         "rand_mirror", "mean", "std", "brightness",
                         "contrast", "saturation", "hue", "pca_noise",
                         "rand_gray", "inter_method")})
        else:
            self.auglist = aug_list
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """(label, raw image bytes or array) — reference
        image.py:next_sample."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                rec = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(rec)
                label = header.label
                return label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return label, f.read()
        rec = self.imgrec.read()
        if rec is None:
            raise StopIteration
        header, img = recordio.unpack(rec)
        return header.label, img

    def next(self):
        H, W = self.data_shape[1], self.data_shape[2]
        data = onp.zeros((self.batch_size, H, W, 3), "float32")
        label_shape = (self.batch_size, self.label_width) if \
            self.label_width > 1 else (self.batch_size,)
        labels = onp.zeros(label_shape, "float32")
        i = 0
        pad = 0
        pending = []  # raw samples consumed into this batch
        while i < self.batch_size:
            try:
                if self._rolled:
                    lab, img = self._rolled.pop(0)
                else:
                    lab, img = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                if self._last_batch_handle == "discard":
                    raise
                if self._last_batch_handle == "roll_over":
                    # keep the partial batch for the next epoch
                    self._rolled = pending
                    raise
                pad = self.batch_size - i
                break
            try:
                arr = imdecode(img)
            except Exception as e:  # corrupt image — skip, like reference
                logging.debug("skipping corrupted image: %s", e)
                continue
            pending.append((lab, img))
            for aug in self.auglist:
                arr = aug(arr)
            a = _to_numpy(arr)
            if a.shape[:2] != (H, W):
                raise MXNetError(
                    f"augmented shape {a.shape} != data_shape; add a "
                    "crop/resize augmenter")
            data[i] = a.astype("float32")
            lab = onp.asarray(lab, "float32").reshape(-1)
            if self.label_width == 1:
                labels[i] = lab[0]
            else:
                labels[i, :lab.shape[0]] = lab[:self.label_width]
            i += 1
        batch_data = _host(
            onp.transpose(data, (0, 3, 1, 2)).astype(self.dtype))
        return DataBatch([batch_data], [_host(labels)], pad=pad)
