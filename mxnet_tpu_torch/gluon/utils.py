"""``gluon.utils`` (reference: python/mxnet/gluon/utils.py; the JAX
package's ``mxnet_tpu/gluon/utils.py``)."""
from ..utils import (check_sha1, clip_global_norm, download, split_and_load,
                     split_data)

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known: under the classic
    shape semantics, which the port keeps, 0 marks an unknown dimension
    (reference: gluon/utils.py shape_is_known)."""
    if shape is None:
        return False
    if len(shape) == 0:
        return False
    for d in shape:
        if d == 0:
            return False
        assert d > 0, f"invalid dim size {d} in shape {tuple(shape)}"
    return True
