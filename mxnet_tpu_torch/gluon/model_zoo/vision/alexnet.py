"""AlexNet (reference: python/mxnet/gluon/model_zoo/vision/alexnet.py;
the JAX package's ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``):
Krizhevsky et al. 2012 in the one-tower form of the reference zoo."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Conv2D, Dense, Dropout, Flatten, HybridSequential, MaxPool2D
from .resnet import _pretrained_error

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """Five convolutions with three max-pools, then two 4096-wide layers
    with dropout 0.5 and the classifier."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(64, kernel_size=11, strides=4,
                                     padding=2, activation="relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(Conv2D(192, kernel_size=5, padding=2,
                                     activation="relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(Conv2D(384, kernel_size=3, padding=1,
                                     activation="relu"))
            self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                     activation="relu"))
            self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                     activation="relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(Flatten())
            self.features.add(Dense(4096, activation="relu"))
            self.features.add(Dropout(0.5))
            self.features.add(Dense(4096, activation="relu"))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        raise _pretrained_error("alexnet")
    return AlexNet(**kwargs)
