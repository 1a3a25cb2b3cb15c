"""``gluon.nn``: the layers the decoder, the transformer and ResNet are
built from."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, LayerNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv2D,
                          Conv3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "HybridSequential", "LayerNorm", "Conv1D", "Conv2D",
           "Conv3D", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D"]
