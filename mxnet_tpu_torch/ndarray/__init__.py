"""``mx.nd``: NDArray, creation functions, save/load and the registered ops.

The PyTorch counterpart of ``mxnet_tpu/ndarray/__init__.py``. Every op
registered with the ``"nd"`` namespace is exposed here as a function of
NDArrays, so a block's ``hybrid_forward(F, ...)`` runs with ``F`` = this
module. ``_CAMEL_ALIASES`` maps the reference's legacy CamelCase op
names (symbol JSON) to the registered ones, as in the JAX package.
"""
from __future__ import annotations

import sys as _sys
import types as _types

from . import registry
from . import (ops_basic, ops_contrib, ops_contrib2, ops_contrib3,  # noqa: F401 — register the ops
               ops_image, ops_index, ops_legacy, ops_linalg, ops_nn,
               ops_optim, ops_quant, ops_random)
from .ndarray import (NDArray, arange, array, concatenate, empty, expand_dims,
                      from_dlpack, from_numpy, full, load, load_frombuffer,
                      moveaxis, ones, save, to_dlpack_for_read,
                      to_dlpack_for_write, waitall, zeros)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "expand_dims", "moveaxis", "waitall", "from_numpy",
           "from_dlpack", "to_dlpack_for_read", "to_dlpack_for_write",
           "stack_list", "save", "load", "load_frombuffer", "registry",
           "random", "Custom", "contrib", "linalg", "image"]

# the JAX package's table (``mxnet_tpu/ndarray/__init__.py:41-85``); the
# first alias per target is the name ``Symbol.tojson`` writes
_CAMEL_ALIASES = {
    "Convolution": "convolution", "Deconvolution": "deconvolution",
    "FullyConnected": "fully_connected", "Activation": "activation",
    "Pooling": "pooling", "BatchNorm": "batch_norm", "LayerNorm": "layer_norm",
    "InstanceNorm": "instance_norm", "GroupNorm": "group_norm",
    "Dropout": "dropout", "Embedding": "embedding", "Flatten": "flatten",
    "Concat": "concat", "Reshape": "reshape", "Cast": "cast",
    "SoftmaxOutput": "softmax_output", "LeakyReLU": "leaky_relu",
    "RNN": "rnn", "SequenceMask": "sequence_mask",
    "SequenceLast": "sequence_last", "SequenceReverse": "sequence_reverse",
    "SliceChannel": "slice_channel", "UpSampling": "upsampling",
    "LRN": "lrn", "Pad": "pad", "SwapAxis": "swapaxes",
    "L2Normalization": "l2_normalization", "MakeLoss": "make_loss",
    "SoftmaxActivation": "softmax",
    "LinearRegressionOutput": "linear_regression_output",
    "MAERegressionOutput": "mae_regression_output",
    "LogisticRegressionOutput": "logistic_regression_output",
    "SVMOutput": "svm_output", "ROIPooling": "roi_pooling",
    "SpatialTransformer": "spatial_transformer",
    "BilinearSampler": "bilinear_sampler", "GridGenerator": "grid_generator",
    "Correlation": "correlation", "Crop": "crop",
    "BatchNorm_v1": "batch_norm",
    "IdentityAttachKLSparseReg": "identity_attach_kl_sparse_reg",
    "_slice_assign": "slice_assign",
    "_slice_assign_scalar": "slice_assign_scalar",
    "_scatter_set_nd": "scatter_set_nd",
    "_contrib_arange_like": "arange_like",
    "_unravel_index": "unravel_index",
    "_ravel_multi_index": "ravel_multi_index",
    "_rnn_param_concat": "rnn_param_concat",
    "_split_v2": "split_v2",
    "_shuffle": "shuffle",
    "_sample_multinomial": "sample_multinomial",
    # the reference's names of the quantization ops: legacy-only, they
    # load but ``tojson`` writes the first alias per target
    "_contrib_quantize": "quantize",
    "_contrib_quantize_v2": "quantize_v2",
    "_contrib_dequantize": "dequantize",
    "_contrib_requantize": "requantize",
    # the two-stage detector ops' CamelCase names (``nd.contrib``'s
    # aliases): they load, but ``tojson`` writes the op's own name, as the
    # JAX package (whose table lacks them) does
    "Proposal": "proposal", "MultiProposal": "multi_proposal",
    "PSROIPooling": "psroi_pooling",
    "DeformableConvolution": "deformable_convolution",
    "DeformablePSROIPooling": "deformable_psroi_pooling",
}
# aliases ``tojson`` never writes: SoftmaxActivation is another op in the
# reference, and the JAX package's table has no contrib names
_LOAD_ONLY = frozenset({"SoftmaxActivation", "Proposal", "MultiProposal",
                        "PSROIPooling", "DeformableConvolution",
                        "DeformablePSROIPooling"})


def Custom(*args, op_type=None, **kwargs):
    """Run the custom op registered as ``op_type`` (``operator.register``)
    on NDArrays ``args`` (reference: the autogen ``Custom`` op of
    src/operator/custom/custom.cc)."""
    if op_type is None:
        raise ValueError("op_type is required")
    from ..operator import invoke_custom

    return invoke_custom(op_type, args, kwargs)


def _make_op_function(opdef):
    def op(*args, **kwargs):
        return registry.invoke(opdef, args, kwargs)

    op.__name__ = opdef.name
    op.__doc__ = opdef.doc
    return op


def _populate(names=None):
    """Install the ops ``names`` (default: every registered op) of the
    ``nd`` namespace as functions of this module (at import, and for the
    ops a ``library.load`` adds)."""
    mod = globals()
    for name in registry.list_ops() if names is None else names:
        opdef = registry.get_op(name)
        if "nd" in opdef.namespaces:
            mod[name] = _make_op_function(opdef)
            if name not in __all__:
                __all__.append(name)


_populate()

# the reference's CamelCase spellings of the registered ops, as the JAX
# package's ``mx.nd`` has them (``nd.Activation``, ``nd.LeakyReLU``)
for _alias, _target in _CAMEL_ALIASES.items():
    if _alias not in globals() and _target in globals():
        globals()[_alias] = globals()[_target]


def stack_list(arrays, axis=0):
    """:func:`stack` of a list of NDArrays."""
    return stack(*arrays, axis=axis)  # noqa: F821 — registered above


# ``mx.nd.random`` (reference: python/mxnet/ndarray/random.py; the JAX
# package's ``ndarray/__init__.py:95-112``): the samplers of ``mx.random``
from .. import random as _mxrandom  # noqa: E402

random = _types.ModuleType(__name__ + ".random")
for _name in ("uniform", "normal", "randn", "randint", "exponential",
              "poisson", "gamma", "negative_binomial",
              "generalized_negative_binomial", "multinomial", "shuffle"):
    setattr(random, _name, getattr(_mxrandom, _name))
_sys.modules[random.__name__] = random


def _prefix_namespace(short):
    """``mx.nd.<short>``: every registered op named ``<short>_*``, the
    prefix stripped (reference: the autogen's split by registered-name
    prefix; ``mxnet_tpu/ndarray/__init__.py:115-135``)."""
    mod = _types.ModuleType(__name__ + "." + short)
    pre = short + "_"
    for name in registry.list_ops():
        if name.startswith(pre):
            setattr(mod, name[len(pre):],
                    _make_op_function(registry.get_op(name)))
    _sys.modules[mod.__name__] = mod
    return mod


# ``mx.nd.linalg`` (reference: python/mxnet/ndarray/linalg.py) and
# ``mx.nd.image`` (the ``_image_*`` ops)
linalg = _prefix_namespace("linalg")
image = _prefix_namespace("image")

# ``mx.nd.contrib`` (reference: python/mxnet/ndarray/contrib.py): the
# detection ops and the other contrib-named ops, with their CamelCase
# spellings, and the eager control flow
from . import contrib  # noqa: E402
