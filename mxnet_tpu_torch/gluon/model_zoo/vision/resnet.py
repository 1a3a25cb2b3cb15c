"""ResNet V1 and V2 (reference:
python/mxnet/gluon/model_zoo/vision/resnet.py).

The PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
``BasicBlockV1``, ``BottleneckV1``, ``ResNetV1``, the pre-activation
``BasicBlockV2``, ``BottleneckV2`` and ``ResNetV2``, ``get_resnet`` and
``resnet{18,34,50,101,152}_v{1,2}``. The convolutions, batch norms,
pooling and the classifier run through torch (cuDNN and cuBLAS on the
card), as the JAX package leaves them to XLA. Blocks default to NCHW;
``layout="NHWC"`` keeps the channel last throughout (convs with (O, kh,
kw, I) filters, BatchNorm over the last axis, pooling over the middle
axes). ``stem_s2d=True`` computes the 7x7/2 stem as a 4x4/1 convolution
over a 2x space-to-depth input (``_S2DStemConv``): the same function
with the same parameter. The structural parameter names
(``features.0.weight``, ``features.5.0.body.1.running_mean``,
``output.bias``, ...) are the JAX package's, so
``convert.params_from_numpy`` carries every weight and both running
statistics across.

Not ported yet (ROADMAP): a ``norm_layer`` other than ``BatchNorm``
(``SyncBatchNorm``, slice 9b) and pretrained weights (the model store,
slice 11).
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _pretrained_error(name):
    return MXNetError(f"{name}: pretrained weights come with the model "
                      "store (ROADMAP A, slice 11); carry weights in with "
                      "convert.params_from_numpy")


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout)


def _bn_axis(layout):
    return -1 if layout == "NHWC" else 1


def _stem_conv(channels, stem_s2d, **kw):
    """The full-size stem: the plain 7x7/2 convolution, or its
    space-to-depth form."""
    return _S2DStemConv(channels, **kw) if stem_s2d \
        else Conv2D(channels, 7, 2, 3, **kw)


class _S2DStemConv(Conv2D):
    """The stem's 7x7/2 convolution computed as a 4x4/1 convolution over
    a 2x space-to-depth input (``mxnet_tpu/gluon/model_zoo/vision/
    resnet.py:31-103``, the MLPerf ResNet stem). Its parameter is the
    plain ``Conv2D``'s (same name, shape and checkpoint bytes); the
    packing of the input and the filter is recomputed on every call.

    With o(i, j) = sum_{u,v<7} w[u, v] x[2i+u-3, 2j+v-3], write h = 2I + r
    (r the parity) and pad w with one leading zero to 8 taps, so that
    u + 1 = 2q + r: the sum becomes 4 taps at unit stride over the
    (I, r)-packed input, padded by (4, 2 or 3) at the input's resolution.
    A traced symbol (``export``) emits the plain 7x7/2 convolution."""

    def __init__(self, channels, layout="NCHW", **kwargs):
        super().__init__(channels, 7, 2, 3, layout=layout, **kwargs)

    def hybrid_forward(self, F, x, weight, bias=None):
        from .... import symbol as _sym

        if isinstance(x, _sym.Symbol):
            return super().hybrid_forward(F, x, weight, bias)
        nhwc = self._channel_last
        O = self._channels
        if nhwc:
            N, H, W, C = x.shape
        else:
            N, C, H, W = x.shape
        # the left pad is 4; the right one makes the padded size even, so
        # odd inputs pack too and the output stays ceil(H/2)
        rh, rw = 2 + (H % 2), 2 + (W % 2)
        Ip, Jp = (H + 4 + rh) // 2, (W + 4 + rw) // 2
        if nhwc:
            x = F.pad(x, mode="constant",
                      pad_width=(0, 0, 4, rh, 4, rw, 0, 0))
            xs = F.reshape(x, (N, Ip, 2, Jp, 2, C))
            xs = F.transpose(xs, axes=(0, 1, 3, 5, 2, 4))
            xs = F.reshape(xs, (N, Ip, Jp, C * 4))
            w = F.transpose(weight, axes=(0, 3, 1, 2))  # (O, C, 7, 7)
        else:
            x = F.pad(x, mode="constant",
                      pad_width=(0, 0, 0, 0, 4, rh, 4, rw))
            xs = F.reshape(x, (N, C, Ip, 2, Jp, 2))
            xs = F.transpose(xs, axes=(0, 1, 3, 5, 2, 4))
            xs = F.reshape(xs, (N, C * 4, Ip, Jp))
            w = weight
        # one leading zero tap splits the kernel index as u + 1 = 2q + r
        w = F.pad(w, mode="constant", pad_width=(0, 0, 0, 0, 1, 0, 1, 0))
        w = F.reshape(w, (O, C, 4, 2, 4, 2))
        w = F.transpose(w, axes=(0, 1, 3, 5, 2, 4))  # (O, C, ry, rx, qy, qx)
        w = F.reshape(w, (O, C * 4, 4, 4))
        if nhwc:
            w = F.transpose(w, axes=(0, 2, 3, 1))  # (O, 4, 4, 4C)
        out = F.convolution(xs, w, bias, kernel=(4, 4), stride=(1, 1),
                            dilate=(1, 1), pad=(0, 0), num_filter=O,
                            no_bias=bias is None, layout=self._layout)
        if self.act is not None:
            out = self.act(out)
        return out


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


class BasicBlockV2(HybridBlock):
    """Pre-activation: norm and ReLU before each of two 3x3 convolutions,
    the shortcut taken after the first ReLU (reference: resnet.py
    BasicBlockV2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", norm_layer=None, norm_kwargs=None, **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = _make_norm(ax, norm_layer, norm_kwargs)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = _make_norm(ax, norm_layer, norm_kwargs)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """Pre-activation 1x1 → 3x3 → 1x1 bottleneck, no biases (reference:
    resnet.py BottleneckV2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", norm_layer=None, norm_kwargs=None, **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = _make_norm(ax, norm_layer, norm_kwargs)
        self.conv1 = Conv2D(channels // 4, kernel_size=1, strides=1,
                            use_bias=False, layout=layout)
        self.bn2 = _make_norm(ax, norm_layer, norm_kwargs)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = _make_norm(ax, norm_layer, norm_kwargs)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, layout=layout)
        if downsample:
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


def _check_spec(name, layers, channels, layout):
    if len(layers) != len(channels) - 1:
        raise MXNetError(f"{name}: {len(layers)} stages need "
                         f"{len(layers) + 1} channel counts, got "
                         f"{len(channels)}")
    if layout not in ("NCHW", "NHWC"):
        raise MXNetError(f"{name}: layout {layout!r} (NCHW or NHWC)")


class ResNetV1(HybridBlock):
    """Reference: resnet.py ResNetV1. ``thumbnail=True`` replaces the
    7x7/2 stem, its norm and the 3x3/2 max-pool with one 3x3/1
    convolution (for 32x32 inputs)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", norm_layer=None, norm_kwargs=None,
                 stem_s2d=False, **kwargs):
        super().__init__(**kwargs)
        _check_spec("ResNetV1", layers, channels, layout)
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(_stem_conv(channels[0], stem_s2d,
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


class ResNetV2(HybridBlock):
    """Reference: resnet.py ResNetV2: a parameter-free batch norm on the
    input, the stem, pre-activation stages, then norm, ReLU and global
    pooling before the classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", norm_layer=None, norm_kwargs=None,
                 stem_s2d=False, **kwargs):
        super().__init__(**kwargs)
        _check_spec("ResNetV2", layers, channels, layout)
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_make_norm(ax, norm_layer, norm_kwargs,
                                         scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(_stem_conv(channels[0], stem_s2d,
                                             use_bias=False, layout=layout))
                self.features.add(_make_norm(ax, norm_layer, norm_kwargs))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels, layout=layout,
                    norm_layer=norm_layer, norm_kwargs=norm_kwargs))
                in_channels = channels[i + 1]
            self.features.add(_make_norm(ax, norm_layer, norm_kwargs))
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.features.add(Flatten())
            self.output = Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


# depth -> (block, units per stage, channels)
resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 or 2) of depth ``num_layers`` (reference:
    resnet.py get_resnet). ``pretrained=True`` raises: the weights come
    with the model store; carry weights in with
    ``convert.params_from_numpy``."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise MXNetError(f"Invalid resnet version: {version}. Options are "
                         "1 and 2.")
    if pretrained:
        raise _pretrained_error(f"resnet{num_layers}_v{version}")
    block_type, layers, channels = resnet_spec[num_layers]
    return resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][block_type], layers, channels,
        **kwargs)


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


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
