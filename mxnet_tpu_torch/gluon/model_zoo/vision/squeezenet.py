"""SqueezeNet 1.0 and 1.1 (reference:
python/mxnet/gluon/model_zoo/vision/squeezenet.py; the JAX package's
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``; Iandola et al. 2016).
Its max-pools use ``ceil_mode=True``, the ``pooling`` op's
``pooling_convention="full"``, which keeps a last window that starts
inside the input even where it runs past the end (MXNet's rule)."""
from __future__ import annotations

from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent
from ...nn import (Activation, AvgPool2D, Conv2D, Dropout, Flatten,
                   HybridSequential, MaxPool2D)
from .resnet import _load_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = HybridConcurrent(axis=1, prefix="")
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel_size, padding=padding))
    out.add(Activation("relu"))
    return out


class SqueezeNet(HybridBlock):
    """``version`` "1.0" or "1.1" (1.1 pools earlier: about 2.4x less
    compute at the same accuracy)."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1"), \
            f"Unsupported SqueezeNet version {version}"
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(Conv2D(96, kernel_size=7, strides=2))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(Conv2D(64, kernel_size=3, strides=2))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(Dropout(0.5))

            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1))
            self.output.add(Activation("relu"))
            self.output.add(AvgPool2D(13))
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   **kwargs):
    """Reference: squeezenet.py get_squeezenet."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        _load_pretrained(net, f"squeezenet{version}", ctx, root)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
