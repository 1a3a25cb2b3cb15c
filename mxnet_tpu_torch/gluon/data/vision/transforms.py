"""Vision transforms over HWC images.

The PyTorch counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py`` (reference:
python/mxnet/gluon/data/vision/transforms.py), on host or device
NDArrays. The jitters' arithmetic (the BT.601 luma, the YIQ hue
rotation, the AlexNet PCA lighting basis) is ``ndarray/ops_image.py``'s,
as the JAX package's transforms take theirs from its ``ops_image``. The
random transforms draw from Python's ``random`` (and ``RandomLighting`` from
numpy's), as the JAX package's do, so one seed gives both the same
draws. ``Resize`` is bilinear with half-pixel centers, antialiased when
it shrinks (``F.interpolate(..., antialias=True)``), where the JAX
package calls ``jax.image.resize(method="linear")``; the two agree to
float32 rounding (see ``tests/test_torch_gluon_data.py``).
"""
from __future__ import annotations

import math
import random as pyrandom

import numpy as onp
import torch
import torch.nn.functional as F

from .... import ndarray as nd
from ....ndarray import NDArray
from ....ndarray.ndarray import host_tensor
from ....ndarray.ops_image import (_adjust, _brightness, _contrast, _hue,
                                   _saturation)
from ...block import Block, HybridBlock
from ...nn import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomLighting", "RandomHue", "RandomColorJitter", "CropResize"]


def _back(out, like):
    """A float result in ``like``'s dtype: uint8 images are clipped to
    [0, 255] first, as the JAX transforms do."""
    if like.dtype == torch.uint8:
        return NDArray(out.clamp(0, 255).to(torch.uint8))
    return NDArray(out)


class _NumpyIn:
    """Transforms take numpy images too (a dataset of numpy arrays yields
    them), as host NDArrays."""

    def __call__(self, x, *args):
        if isinstance(x, onp.ndarray):
            x = NDArray(host_tensor(onp.ascontiguousarray(x)))
        return super().__call__(x, *args)


class Compose(_NumpyIn, HybridSequential):
    """Apply the transforms in order (reference: transforms.py Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(_NumpyIn, HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(_NumpyIn, HybridBlock):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (NHWC to NCHW)."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        if x.ndim == 3:
            return F.transpose(x, axes=(2, 0, 1))
        return F.transpose(x, axes=(0, 3, 1, 2))


class Normalize(_NumpyIn, HybridBlock):
    """(x - mean) / std per channel of CHW (or NCHW) input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32).reshape(-1, 1, 1)
        self._std = onp.asarray(std, dtype=onp.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        dev = x.data.device
        mean = NDArray(host_tensor(self._mean).to(dev))
        std = NDArray(host_tensor(self._std).to(dev))
        return (x - mean) / std


class Resize(_NumpyIn, Block):
    """Resize HWC (or NHWC) images to ``size`` = (width, height), or a
    square; bilinear, antialiased when shrinking; the result keeps the
    input's dtype (a float result cast to uint8 truncates, as the JAX
    package's ``astype``)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        t = x.data
        nchw = (t.unsqueeze(0) if t.dim() == 3 else t).permute(0, 3, 1, 2)
        out = F.interpolate(nchw.float(), size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
        out = out.permute(0, 2, 3, 1)
        if t.dim() == 3:
            out = out[0]
        return NDArray(out.to(t.dtype).contiguous())


class CenterCrop(_NumpyIn, Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0, x0 = max((H - h) // 2, 0), max((W - w) // 2, 0)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(_NumpyIn, Block):
    """A random crop of random area and aspect, resized to ``size``
    (reference: transforms.py RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = pyrandom.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(pyrandom.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                x0 = pyrandom.randint(0, W - w)
                y0 = pyrandom.randint(0, H - h)
                return Resize(self._size)(x[y0:y0 + h, x0:x0 + w, :])
        return Resize(self._size)(CenterCrop(min(H, W))(x))


class _RandomFlip(_NumpyIn, Block):
    _axis = 1

    def forward(self, x):
        if pyrandom.random() < 0.5:
            return nd.flip(x, axis=self._axis)
        return x


class RandomFlipLeftRight(_RandomFlip):
    _axis = 1


class RandomFlipTopBottom(_RandomFlip):
    _axis = 0


class _RandomJitter(_NumpyIn, Block):
    """A factor drawn on the host, then the jitter's arithmetic in
    float32."""

    _impl = None

    def __init__(self, val):
        super().__init__()
        self._val = val

    def _alpha(self):
        return 1.0 + pyrandom.uniform(-self._val, self._val)

    def forward(self, x):
        return _back(type(self)._impl(x.data.float(), self._alpha()),
                     x.data)


class RandomBrightness(_RandomJitter):
    _impl = staticmethod(_brightness)


class RandomContrast(_RandomJitter):
    _impl = staticmethod(_contrast)


class RandomSaturation(_RandomJitter):
    _impl = staticmethod(_saturation)


class RandomHue(_RandomJitter):
    """YIQ-rotation hue jitter (reference: transforms.py RandomHue)."""

    _impl = staticmethod(_hue)

    def _alpha(self):
        return pyrandom.uniform(-self._val, self._val)


class RandomColorJitter(_NumpyIn, Block):
    """Brightness, contrast, saturation and hue jitter, the enabled ones
    in random order (reference: transforms.py RandomColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class CropResize(_NumpyIn, Block):
    """A fixed crop, then an optional resize with Pillow (reference:
    transforms.py CropResize; the JAX package's ``image.imresize``)."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y = int(x), int(y)
        self._w, self._h = int(width), int(height)
        self._size = size
        self._interp = interpolation

    def forward(self, data):
        H, W = data.shape[-3], data.shape[-2]
        if self._y + self._h > H or self._x + self._w > W:
            raise ValueError(
                f"crop ({self._x},{self._y},{self._w},{self._h}) exceeds "
                f"image size {W}x{H}")
        out = data[..., self._y:self._y + self._h,
                   self._x:self._x + self._w, :]
        if self._size is None:
            return out
        size = self._size if isinstance(self._size, (list, tuple)) \
            else (self._size, self._size)
        if out.ndim == 3:
            return _imresize(out, size[0], size[1], self._interp)
        return NDArray(torch.stack(
            [_imresize(out[i], size[0], size[1], self._interp).data
             for i in range(out.shape[0])]))


def _imresize(src, w, h, interp=1):
    """Pillow's resize of one HWC image (interp codes: 0 nearest, 1
    bilinear, 2 bicubic, 3 area, 4 lanczos), on the host, back on the
    source's device."""
    from PIL import Image

    R = Image.Resampling if hasattr(Image, "Resampling") else Image
    method = {0: R.NEAREST, 1: R.BILINEAR, 2: R.BICUBIC, 3: R.BOX,
              4: R.LANCZOS}[interp]
    arr = src.asnumpy()
    squeeze = arr.shape[2] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    out = onp.asarray(img.resize((w, h), method))
    if out.ndim == 2:
        out = out[:, :, None]
    return NDArray(host_tensor(out.copy()).to(src.data.device))


class RandomLighting(_NumpyIn, Block):
    """AlexNet-style PCA noise with numpy-drawn alpha (reference:
    transforms.py RandomLighting)."""

    def __init__(self, alpha_std=0.05):
        super().__init__()
        self._alpha_std = alpha_std

    def forward(self, x):
        alpha = onp.random.normal(0, self._alpha_std, 3).astype(onp.float32)
        return _back(_adjust(x.data.float(), alpha), x.data)
