"""Gluon recurrent cells and layers (reference: python/mxnet/gluon/rnn/;
the JAX package's ``gluon/rnn/``)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, BidirectionalCell, DropoutCell,
                       ZoneoutCell, ResidualCell, HybridRecurrentCell)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "HybridRecurrentCell"]
