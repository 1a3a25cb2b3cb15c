"""MobileNet v1 (Howard et al. 2017) and v2 (Sandler et al. 2018).

The PyTorch counterparts of ``mxnet_tpu/gluon/model_zoo/vision/
mobilenet.py`` (reference: python/mxnet/gluon/model_zoo/vision/
mobilenet.py), with the JAX package's ``layout`` ("NCHW" or "NHWC").
The depthwise convolutions are grouped convolutions with one group per
channel (cuDNN on the card, in float32 inside ``cudnn_fp32()``); the 1x1
pointwise convolutions carry most of the arithmetic. ``RELU6`` is
``clip(x, 0, 6)``.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential)
from .resnet import _bn_axis, _pretrained_error

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25",
           "get_mobilenet", "get_mobilenet_v2"]


class RELU6(HybridBlock):
    """Reference: mobilenet.py RELU6 (``clip(x, 0, 6)``)."""

    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False, layout="NCHW"):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False, layout=layout))
    out.add(BatchNorm(scale=True, axis=_bn_axis(layout)))
    if active:
        out.add(RELU6() if relu6 else Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False,
                 layout="NCHW"):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6, layout=layout)
    _add_conv(out, channels, relu6=relu6, layout=layout)


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual (reference: mobilenet.py
    LinearBottleneck): 1x1 expansion by ``t``, 3x3 depthwise, linear 1x1
    projection; the residual when the stride is 1 and the widths
    match."""

    def __init__(self, in_channels, channels, t, stride, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True, layout=layout)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True,
                      layout=layout)
            _add_conv(self.out, channels, active=False, relu6=True,
                      layout=layout)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    """MobileNet v1 with width ``multiplier`` (reference: mobilenet.py
    MobileNet)."""

    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        assert layout in ("NCHW", "NHWC"), layout
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _add_conv(self.features, channels=int(32 * multiplier),
                      kernel=3, pad=1, stride=2, layout=layout)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6
                        + [1024] * 2]
            strides = [1, 2] * 3 + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                             stride=s, layout=layout)
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet v2 with width ``multiplier`` (reference: mobilenet.py
    MobileNetV2)."""

    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        assert layout in ("NCHW", "NHWC"), layout
        with self.name_scope():
            self.features = HybridSequential(prefix="features_")
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1, relu6=True, layout=layout)
            in_channels_group = [int(x * multiplier) for x in
                                 [32] + [16] + [24] * 2 + [32] * 3
                                 + [64] * 4 + [96] * 3 + [160] * 3]
            channels_group = [int(x * multiplier) for x in
                              [16] + [24] * 2 + [32] * 3 + [64] * 4
                              + [96] * 3 + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
            for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                     strides):
                self.features.add(LinearBottleneck(
                    in_channels=in_c, channels=c, t=t, stride=s,
                    layout=layout))
            last_channels = int(1280 * multiplier) if multiplier > 1.0 \
                else 1280
            _add_conv(self.features, last_channels, relu6=True,
                      layout=layout)
            self.features.add(GlobalAvgPool2D(layout=layout))

            self.output = HybridSequential(prefix="output_")
            self.output.add(Conv2D(classes, 1, use_bias=False,
                                   prefix="pred_", layout=layout))
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    if pretrained:
        raise _pretrained_error(f"mobilenet{float(multiplier)}")
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     **kwargs):
    if pretrained:
        raise _pretrained_error(f"mobilenetv2_{float(multiplier)}")
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
