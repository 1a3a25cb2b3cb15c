"""``mx.contrib.symbol`` (reference: python/mxnet/contrib/symbol.py): the
names of ``mx.sym.contrib``, as ``mxnet_tpu/contrib/symbol.py`` makes
them."""
from ..symbol.contrib import *  # noqa: F401,F403
