"""VGG (reference: python/mxnet/gluon/model_zoo/vision/vgg.py; the JAX
package's ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``): Simonyan and
Zisserman 2014, configurations A (11), B (13), D (16) and E (19), with
or without batch norm after each convolution."""
from __future__ import annotations

from ....initializer import Xavier
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Dropout, Flatten,
                   HybridSequential, MaxPool2D)
from .resnet import _pretrained_error

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    """Stages of 3x3 convolutions (``layers[i]`` of ``filters[i]``
    channels, each with a ReLU) and a 2x2 max-pool, then two 4096-wide
    layers with dropout 0.5 and the classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(Dense(4096, activation="relu",
                                    weight_initializer="normal"))
            self.features.add(Dropout(rate=0.5))
            self.features.add(Dense(4096, activation="relu",
                                    weight_initializer="normal"))
            self.features.add(Dropout(rate=0.5))
            self.output = Dense(classes, weight_initializer="normal")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(Conv2D(filters[i], kernel_size=3, padding=1,
                                      weight_initializer=Xavier(
                                          rnd_type="gaussian",
                                          factor_type="out", magnitude=2)))
                if batch_norm:
                    featurizer.add(BatchNorm())
                featurizer.add(Activation("relu"))
            featurizer.add(MaxPool2D(strides=2))
        featurizer.add(Flatten())
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (convolutions per stage, channels per stage)
vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """Reference: vgg.py get_vgg."""
    if pretrained:
        bn = "_bn" if kwargs.get("batch_norm") else ""
        raise _pretrained_error(f"vgg{num_layers}{bn}")
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
