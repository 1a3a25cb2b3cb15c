"""``mx.contrib.ndarray`` (reference: python/mxnet/contrib/ndarray.py, a
re-export of the contrib op surface): the names of ``mx.nd.contrib``,
as ``mxnet_tpu/contrib/ndarray.py`` makes them."""
from ..ndarray.contrib import *  # noqa: F401,F403
