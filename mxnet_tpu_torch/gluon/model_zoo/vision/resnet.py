"""ResNet V1 (reference: python/mxnet/gluon/model_zoo/vision/resnet.py).

The PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py:
22-36,104-183,254-302,363-401``: ``BasicBlockV1``, ``BottleneckV1``,
``ResNetV1``, ``get_resnet`` and ``resnet{18,34,50,101,152}_v1``. The
convolutions, batch norms, pooling and the classifier run through torch
(cuDNN and cuBLAS on the card), as the JAX package leaves them to XLA.
Blocks default to NCHW; ``layout="NHWC"`` keeps the channel last
throughout (convs with (O, kh, kw, I) filters, BatchNorm over the last
axis, pooling over the middle axes). The structural parameter names
(``features.0.weight``, ``features.5.0.body.1.running_mean``,
``output.bias``, ...) are the JAX package's, so
``convert.params_from_numpy`` carries every weight and both running
statistics across.

Not ported yet (ROADMAP): the V2 (pre-activation) family, the TPU's
space-to-depth stem (``stem_s2d=True`` raises :class:`MXNetError`), a
``norm_layer`` other than ``BatchNorm`` (``SyncBatchNorm``), and
pretrained weights.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout)


def _bn_axis(layout):
    return -1 if layout == "NHWC" else 1


def _make_norm(ax, norm_layer=None, norm_kwargs=None, **extra):
    """A block's norm layer: BatchNorm over the channel axis, with
    ``norm_kwargs``."""
    if norm_layer is not None and not (isinstance(norm_layer, type) and
                                       issubclass(norm_layer, BatchNorm)):
        raise MXNetError(f"norm_layer {norm_layer!r}: the port has BatchNorm "
                         "only (SyncBatchNorm comes with the multi-device "
                         "slice)")
    kw = dict(norm_kwargs or {})
    kw.setdefault("axis", ax)
    kw.update(extra)
    return (norm_layer or BatchNorm)(**kw)


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions with a residual (reference: resnet.py
    BasicBlockV1)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", norm_layer=None, norm_kwargs=None, **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)

        def norm():
            return _make_norm(ax, norm_layer, norm_kwargs)

        self.body = HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(norm())
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(norm())
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels,
                                       layout=layout))
            self.downsample.add(norm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 → 3x3 → 1x1 convolutions with a residual (reference:
    resnet.py BottleneckV1). As in the reference, the first and last
    1x1 convolutions keep their bias."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", norm_layer=None, norm_kwargs=None, **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)

        def norm():
            return _make_norm(ax, norm_layer, norm_kwargs)

        self.body = HybridSequential(prefix="")
        self.body.add(Conv2D(channels // 4, kernel_size=1, strides=stride,
                             layout=layout))
        self.body.add(norm())
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(norm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels, kernel_size=1, strides=1,
                             layout=layout))
        self.body.add(norm())
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels,
                                       layout=layout))
            self.downsample.add(norm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.activation(x + residual, act_type="relu")


class ResNetV1(HybridBlock):
    """Reference: resnet.py ResNetV1. ``thumbnail=True`` replaces the
    7x7/2 stem, its norm and the 3x3/2 max-pool with one 3x3/1
    convolution (for 32x32 inputs)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", norm_layer=None, norm_kwargs=None,
                 stem_s2d=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV1: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{len(channels)}")
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"ResNetV1: layout {layout!r} (NCHW or NHWC)")
        if stem_s2d:
            raise MXNetError("ResNetV1: the space-to-depth stem "
                             "(stem_s2d=True) is a TPU layout and is not "
                             "ported; use the plain 7x7/2 stem")
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3,
                                         use_bias=False, layout=layout))
                self.features.add(_make_norm(ax, norm_layer, norm_kwargs))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i], layout=layout,
                    norm_layer=norm_layer, norm_kwargs=norm_kwargs))
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW", norm_layer=None,
                    norm_kwargs=None):
        layer = HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            norm_layer=norm_layer, norm_kwargs=norm_kwargs,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, norm_layer=norm_layer,
                                norm_kwargs=norm_kwargs, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


# depth -> (block, units per stage, channels)
resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

_BLOCKS_V1 = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 only, so far) of depth ``num_layers``
    (reference: resnet.py get_resnet). ``pretrained`` weights are not
    shipped: carry weights in with ``convert.params_from_numpy``."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version != 1:
        raise MXNetError(f"ResNet v{version}: only v1 is ported so far "
                         "(the V2 family waits, ROADMAP)")
    if pretrained:
        raise MXNetError("pretrained weights are not shipped with the port; "
                         "load them with convert.params_from_numpy")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS_V1[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
