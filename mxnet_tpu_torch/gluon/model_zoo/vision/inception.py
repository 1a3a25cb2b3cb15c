"""Inception v3 (reference: python/mxnet/gluon/model_zoo/vision/
inception.py; the JAX package's ``mxnet_tpu/gluon/model_zoo/vision/
inception.py``; Szegedy et al. 2015), for 3 x 299 x 299 inputs. Each
mixed block is a ``HybridConcurrent`` of branches concatenated on the
channel axis."""
from __future__ import annotations

from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   Flatten, HybridSequential, MaxPool2D)
from .resnet import _load_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(use_bias=False, **kwargs))
    out.add(BatchNorm(epsilon=0.001))
    out.add(Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {setting_names[i]: value for i, value in enumerate(setting)
                  if value is not None}
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _BranchSplit(HybridBlock):
    """One branch, then two parallel convolutions concatenated: the E
    block's 3x3 split into 1x3 and 3x1."""

    def __init__(self, head_settings, split_settings, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.head = _make_branch(None, *head_settings) \
                if head_settings else None
            self.split = HybridConcurrent(axis=1, prefix="")
            for setting in split_settings:
                self.split.add(_make_branch(None, setting))

    def hybrid_forward(self, F, x):
        if self.head is not None:
            x = self.head(x)
        return self.split(x)


def _make_E(prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (320, 1, None, None)))
        out.add(_BranchSplit([(384, 1, None, None)],
                             [(384, (1, 3), None, (0, 1)),
                              (384, (3, 1), None, (1, 0))]))
        out.add(_BranchSplit([(448, 1, None, None), (384, 3, None, 1)],
                             [(384, (1, 3), None, (0, 1)),
                              (384, (3, 1), None, (1, 0))]))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    """Reference: inception.py Inception3."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(AvgPool2D(pool_size=8))
            self.features.add(Dropout(0.5))
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        _load_pretrained(net, "inceptionv3", ctx, root)
    return net
