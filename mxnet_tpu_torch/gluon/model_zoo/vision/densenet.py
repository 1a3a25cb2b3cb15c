"""DenseNet 121, 161, 169 and 201 (reference:
python/mxnet/gluon/model_zoo/vision/densenet.py; the JAX package's
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``; Huang et al. 2016).
Each dense layer is a ``HybridConcurrent`` of the identity and the new
features, concatenated on the channel axis."""
from __future__ import annotations

from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent, Identity
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   Flatten, GlobalAvgPool2D, HybridSequential, MaxPool2D)
from .resnet import _pretrained_error

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index):
    out = HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_make_dense_layer(growth_rate, bn_size, dropout))
    return out


def _make_dense_layer(growth_rate, bn_size, dropout):
    new_features = HybridSequential(prefix="")
    new_features.add(BatchNorm())
    new_features.add(Activation("relu"))
    new_features.add(Conv2D(bn_size * growth_rate, kernel_size=1,
                            use_bias=False))
    new_features.add(BatchNorm())
    new_features.add(Activation("relu"))
    new_features.add(Conv2D(growth_rate, kernel_size=3, padding=1,
                            use_bias=False))
    if dropout:
        new_features.add(Dropout(dropout))
    out = HybridConcurrent(axis=1, prefix="")
    out.add(Identity())
    out.add(new_features)
    return out


def _make_transition(num_output_features):
    out = HybridSequential(prefix="")
    out.add(BatchNorm())
    out.add(Activation("relu"))
    out.add(Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """Reference: densenet.py DenseNet."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, kernel_size=7,
                                     strides=2, padding=3, use_bias=False))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2))
                    num_features = num_features // 2
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (num_init_features, growth_rate, layers per dense block)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None,
                 **kwargs):
    if pretrained:
        raise _pretrained_error(f"densenet{num_layers}")
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
