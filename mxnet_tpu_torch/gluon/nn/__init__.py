"""``gluon.nn``: the layers the decoder and the transformer are built
from."""
from .basic_layers import (Activation, Dense, Dropout, Embedding,
                           HybridSequential, LayerNorm)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "HybridSequential",
           "LayerNorm"]
