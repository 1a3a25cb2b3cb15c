"""``gluon.nn``: the basic, convolution, pooling and activation layers
(reference: python/mxnet/gluon/nn/)."""
from .activations import ELU, GELU, SELU, LeakyReLU, PReLU, Swish
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "ReflectionPad2D", "Activation", "LeakyReLU",
           "PReLU", "ELU", "SELU", "Swish", "GELU"]
