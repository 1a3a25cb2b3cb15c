"""``gluon.nn``: the layers the decoder is built from."""
from .basic_layers import (Activation, Dense, Embedding, HybridSequential,
                           LayerNorm)

__all__ = ["Activation", "Dense", "Embedding", "HybridSequential",
           "LayerNorm"]
