"""AMP op lists (reference: python/mxnet/contrib/amp/lists/symbol.py:22-511).

The port's own copy of ``mxnet_tpu/contrib/amp/lists.py``, name for
name. A listed op the port does not register yet is inert, as in the
JAX package.

- TARGET_DTYPE_OPS: run in the low-precision target (bf16: the tensor
  cores' input type)
- FP32_OPS: numerically sensitive, always fp32
- WIDEST_TYPE_CASTS: multi-input ops computed in the widest operand type
- CONDITIONAL_FP32_OPS: fp32 only when a named attr takes listed values
  (reference symbol.py:504 CONDITIONAL_FP32_FUNCS — softrelu's exp and
  elu/selu's expm1 overflow in 16-bit)
Everything unlisted runs in whatever dtype its inputs already have.
"""

TARGET_DTYPE_OPS = [
    "convolution", "deconvolution", "fully_connected", "dot", "batch_dot",
    "rnn", "_matmul",
]

FP32_OPS = [
    "batch_norm", "layer_norm", "instance_norm", "group_norm", "l2_normalization",
    "lrn", "softmax", "log_softmax", "softmin", "softmax_cross_entropy",
    "softmax_output", "exp", "expm1", "log", "log10", "log1p", "log2",
    "linear_regression_output", "mae_regression_output",
    "logistic_regression_output", "svm_output", "make_loss", "ctc_loss",
    "erf", "erfinv", "gamma", "gammaln", "norm", "mean", "mean_all", "sum",
    "sum_axis", "nansum", "prod", "nanprod", "rsqrt", "rcbrt", "square",
    "reciprocal", "smooth_l1", "power", "broadcast_power",
]

WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
    "broadcast_mod", "elemwise_add", "elemwise_sub", "elemwise_mul",
    "elemwise_div", "add_n", "concat", "stack", "where", "maximum",
    "minimum", "batch_take", "take_along_axis",
]


CONDITIONAL_FP32_OPS = [
    ("activation", "act_type", ["softrelu"]),
    ("leaky_relu", "act_type", ["elu", "selu"]),
]
