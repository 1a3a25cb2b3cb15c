"""``mx.nd``: NDArray, creation functions, save/load and the registered ops.

The PyTorch counterpart of ``mxnet_tpu/ndarray/__init__.py``. Every op
registered with the ``"nd"`` namespace is exposed here as a function of
NDArrays, so a block's ``hybrid_forward(F, ...)`` runs with ``F`` = this
module. ``_CAMEL_ALIASES`` maps the reference's legacy CamelCase op
names (symbol JSON) to the registered ones, as in the JAX package.
"""
from __future__ import annotations

from . import registry
from . import ops_basic, ops_index, ops_legacy, ops_nn, ops_optim  # noqa: F401 — register the ops
from .ndarray import (NDArray, arange, array, concatenate, expand_dims, load,
                      load_frombuffer, ones, save, zeros)

__all__ = ["NDArray", "array", "zeros", "ones", "arange", "concatenate",
           "expand_dims", "save", "load", "load_frombuffer", "registry",
           "Custom"]

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
}


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


for _name in registry.list_ops():
    _opdef = registry.get_op(_name)
    if "nd" in _opdef.namespaces:
        globals()[_name] = _make_op_function(_opdef)
        __all__.append(_name)

# the reference's CamelCase spellings of the registered ops, as the JAX
# package's ``mx.nd`` has them (``nd.Activation``, ``nd.LeakyReLU``)
for _alias, _target in _CAMEL_ALIASES.items():
    if _alias not in globals() and _target in globals():
        globals()[_alias] = globals()[_target]
