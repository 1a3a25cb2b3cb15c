"""Legacy symbolic RNN API (reference: python/mxnet/rnn/__init__.py; the
JAX package's ``rnn/``)."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,  # noqa
                       SequentialRNNCell, BidirectionalCell,
                       DropoutCell, FusedRNNCell)
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
