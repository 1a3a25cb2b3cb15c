"""The op sweep: the cases that hold the NDArray and op surface's ops.

One table per op file (``BASIC``, ``INDEX``, ``NN``, ``LEGACY``): each
:class:`Case` names an op, makes its array inputs from a numpy
``RandomState`` (small shapes), gives its settings, the tolerance it is
held to, and the inputs whose gradients are checked. The CPU tests hold
the port against the JAX package with these cases
(``tests/test_torch_ops_surface.py``); on the card ``chip_smoke.py``
runs every case against the CPU port (:func:`card_sweep`), captures
every deterministic op in one CUDA graph (:func:`capture_check`), and
replays the random ops under a registered generator
(:func:`random_capture_check`).

Tolerances against the JAX package (``tol``): ``EXACT`` bitwise, ``ELEM``
(1e-6) for elementwise float math, ``REDUCE`` (1e-5) for reductions,
products and the transcendentals where XLA and torch differ, ``CTC``
(1e-4) for ``ctc_loss``. On the card against the CPU port: ``EXACT``
cases bitwise in the forward, the rest within rtol 1e-5 and atol 1e-6
(``ctc_loss`` rtol 1e-4), and every gradient within the float bound
(the card's scatter-adds sum in another order).
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..context import cuda_graph
from ..ndarray import registry

__all__ = ["Case", "EXACT", "ELEM", "REDUCE", "CTC", "BASIC", "INDEX", "NN",
           "LEGACY", "ALL", "DATA_DEPENDENT", "RANDOM", "card_sweep",
           "capture_check", "random_capture_check"]

EXACT = 0.0
ELEM = 1e-6
REDUCE = 1e-5
CTC = 1e-4


class Case:
    """One op and setting: ``make(rs)`` gives the array inputs (numpy
    arrays in their dtype), ``kw`` the settings, ``tol`` the tolerance
    against the JAX package (a tuple: one per output), ``diff`` the
    inputs whose gradients are checked, ``out`` which output the
    cotangent pulls back through."""

    def __init__(self, op, make, kw=None, tol=EXACT, diff=(), out=0,
                 grad_tol=None, tag=""):
        self.op, self.make, self.kw, self.tol = op, make, kw or {}, tol
        self.diff, self.out = diff, out
        self.grad_tol = grad_tol if grad_tol is not None else \
            max(max(tol) if isinstance(tol, tuple) else tol, ELEM)
        self.id = op + (f"-{tag}" if tag else "")

    def rng(self):
        """The case's own RandomState: its inputs, then its cotangent."""
        return onp.random.RandomState(sum(map(ord, self.id)) % 2 ** 31)

    def tols(self, n):
        return self.tol if isinstance(self.tol, tuple) else (self.tol,) * n


def f32(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype("float32")


def i32(values):
    return onp.asarray(values, dtype="int32")


def fl(values):
    return onp.asarray(values, dtype="float32")


# -- ops_basic ------------------------------------------------------------

BASIC = [
    Case("_matmul", lambda rs: [f32(rs, 2, 3, 4), f32(rs, 4, 5)],
         tol=REDUCE, diff=(0, 1)),
    Case("argmax", lambda rs: [f32(rs, 3, 5)], {"axis": 1}),
    Case("argmax", lambda rs: [f32(rs, 3, 5)], {}, tag="flat"),
    Case("argmax_channel", lambda rs: [f32(rs, 2, 4, 3)]),
    Case("argmin", lambda rs: [f32(rs, 3, 5)], {"axis": 0,
                                                "keepdims": True}),
    Case("broadcast_axes", lambda rs: [f32(rs, 2, 1, 3)],
         {"axis": 1, "size": 4}, diff=(0,)),
    Case("broadcast_axis", lambda rs: [f32(rs, 1, 3, 1)],
         {"axis": (0, 2), "size": (2, 4)}, diff=(0,)),
    Case("broadcast_like", lambda rs: [f32(rs, 1, 3), f32(rs, 4, 3)],
         diff=(0,)),
    Case("broadcast_like", lambda rs: [f32(rs, 2, 1), f32(rs, 5, 3)],
         {"lhs_axes": (1,), "rhs_axes": (1,)}, diff=(0,), tag="axes"),
    Case("broadcast_to", lambda rs: [f32(rs, 1, 3)], {"shape": (4, 0)},
         diff=(0,)),
    Case("depth_to_space", lambda rs: [f32(rs, 2, 8, 2, 3)],
         {"block_size": 2}, diff=(0,)),
    Case("diag", lambda rs: [f32(rs, 4, 4)], {"k": 1}, diff=(0,)),
    Case("diag", lambda rs: [f32(rs, 3)], {}, diff=(0,), tag="build"),
    Case("digamma", lambda rs: [f32(rs, 3, 4, lo=0.5, hi=3.0)],
         tol=REDUCE, diff=(0,)),
    Case("expand_dims", lambda rs: [f32(rs, 2, 3)], {"axis": 1}, diff=(0,)),
    Case("hypot", lambda rs: [f32(rs, 2, 3), f32(rs, 2, 3)], tol=ELEM,
         diff=(0, 1)),
    Case("identity", lambda rs: [f32(rs, 2, 3)], diff=(0,)),
    Case("identity_attach_kl_sparse_reg", lambda rs: [f32(rs, 2, 3)],
         diff=(0,)),
    Case("khatri_rao", lambda rs: [f32(rs, 3, 4), f32(rs, 2, 4)], tol=ELEM,
         diff=(0, 1)),
    Case("l2_normalization", lambda rs: [f32(rs, 2, 3, 4)], tol=REDUCE,
         diff=(0,)),
    Case("l2_normalization", lambda rs: [f32(rs, 2, 3, 4)],
         {"mode": "channel"}, tol=REDUCE, diff=(0,), tag="channel"),
    Case("l2_normalization", lambda rs: [f32(rs, 2, 3, 2, 2)],
         {"mode": "spatial"}, tol=REDUCE, diff=(0,), tag="spatial"),
    Case("ldexp", lambda rs: [f32(rs, 2, 3), f32(rs, 2, 3, lo=-3, hi=3)],
         tol=ELEM, diff=(0, 1)),
    Case("max", lambda rs: [f32(rs, 3, 4, 2)], {"axis": 1}, diff=(0,)),
    Case("max", lambda rs: [f32(rs, 3, 4)], {"axis": 0, "exclude": True,
                                             "keepdims": True},
         diff=(0,), tag="exclude"),
    Case("mean_all", lambda rs: [f32(rs, 3, 4)], tol=REDUCE, diff=(0,)),
    Case("min", lambda rs: [f32(rs, 3, 4, 2)], {"axis": (0, 2)}, diff=(0,)),
    Case("nanprod", lambda rs: [onp.where(rs.rand(3, 4) < 0.3, onp.nan,
                                          f32(rs, 3, 4, lo=0.5, hi=1.5))
                                .astype("float32")], {"axis": 1},
         tol=REDUCE),
    Case("nansum", lambda rs: [onp.where(rs.rand(3, 4) < 0.3, onp.nan,
                                         f32(rs, 3, 4)).astype("float32")],
         {"axis": 0}, tol=REDUCE),
    Case("norm", lambda rs: [f32(rs, 3, 4)], {"axis": 1}, tol=REDUCE,
         diff=(0,)),
    Case("norm", lambda rs: [f32(rs, 3, 4)], {"ord": 1}, tol=REDUCE,
         diff=(0,), tag="l1"),
    Case("pad", lambda rs: [f32(rs, 1, 2, 3, 3)],
         {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
          "constant_value": 0.5}, diff=(0,)),
    Case("pad", lambda rs: [f32(rs, 1, 2, 3, 3)],
         {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
         diff=(0,), tag="edge"),
    Case("pad", lambda rs: [f32(rs, 1, 2, 4, 4)],
         {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
         diff=(0,), tag="reflect"),
    Case("prod", lambda rs: [f32(rs, 2, 3, 4, lo=0.5, hi=1.5)],
         {"axis": (0, 2)}, tol=REDUCE, diff=(0,)),
    Case("repeat", lambda rs: [f32(rs, 2, 3)], {"repeats": 2, "axis": 1},
         diff=(0,)),
    Case("repeat", lambda rs: [f32(rs, 2, 3)], {"repeats": 3}, diff=(0,),
         tag="flat"),
    Case("reshape_like", lambda rs: [f32(rs, 2, 6), f32(rs, 3, 4)],
         diff=(0,)),
    Case("reshape_like", lambda rs: [f32(rs, 2, 12), f32(rs, 3, 4)],
         {"lhs_begin": 1, "lhs_end": 2, "rhs_begin": 0, "rhs_end": 2},
         diff=(0,), tag="ranges"),
    Case("reverse", lambda rs: [f32(rs, 2, 3, 4)], {"axis": 1}, diff=(0,)),
    Case("rnn_param_concat", lambda rs: [f32(rs, 2, 3), f32(rs, 4)],
         diff=(0, 1)),
    Case("rnn_param_concat", lambda rs: [f32(rs, 2, 3), f32(rs, 1, 3)],
         {"dim": 0}, diff=(0, 1), tag="same_rank"),
    Case("shape_array", lambda rs: [f32(rs, 2, 3, 4)]),
    Case("size_array", lambda rs: [f32(rs, 2, 3, 4)]),
    Case("slice", lambda rs: [f32(rs, 3, 5)],
         {"begin": (0, 1), "end": (2, None)}, diff=(0,)),
    Case("slice", lambda rs: [f32(rs, 3, 5)],
         {"begin": (None, 4), "end": (None, 0), "step": (1, -2)},
         diff=(0,), tag="negative_step"),
    Case("slice_like", lambda rs: [f32(rs, 3, 5), f32(rs, 2, 4)],
         diff=(0,)),
    Case("slice_like", lambda rs: [f32(rs, 3, 5), f32(rs, 2, 4)],
         {"axes": (1,)}, diff=(0,), tag="axes"),
    Case("space_to_depth", lambda rs: [f32(rs, 2, 2, 4, 6)],
         {"block_size": 2}, diff=(0,)),
    Case("sum_axis", lambda rs: [f32(rs, 3, 4)], {"axis": 1}, tol=REDUCE,
         diff=(0,)),
    Case("tile", lambda rs: [f32(rs, 2, 3)], {"reps": (2, 1, 3)},
         diff=(0,)),
    # the argument gaps: exclude on the reductions
    Case("sum", lambda rs: [f32(rs, 2, 3, 4)], {"axis": 1,
                                                "exclude": True},
         tol=REDUCE, diff=(0,), tag="exclude"),
    Case("mean", lambda rs: [f32(rs, 2, 3, 4)], {"axis": (0, 2),
                                                 "exclude": True,
                                                 "keepdims": True},
         tol=REDUCE, diff=(0,), tag="exclude"),
]


# -- ops_index ------------------------------------------------------------

INDEX = [
    Case("arange_like", lambda rs: [f32(rs, 2, 3)],
         {"start": 1.0, "step": 0.5, "repeat": 2}, tol=ELEM),
    Case("arange_like", lambda rs: [f32(rs, 2, 3)], {"axis": 1},
         tol=ELEM, tag="axis"),
    Case("argsort", lambda rs: [fl([[3, 1, 2, 1, 3], [0, 0, 1, 0, 2]])],
         {"is_ascend": False}, tag="ties_descending"),
    Case("argsort", lambda rs: [f32(rs, 3, 4)], {"axis": 0,
                                                 "dtype": "int32"}),
    Case("boolean_mask", lambda rs: [f32(rs, 4, 3), fl([1, 0, 1, 1])],
         diff=(0,)),
    Case("gather_nd", lambda rs: [f32(rs, 3, 4), i32([[0, 2], [1, 3]])],
         diff=(0,)),
    # the counts bitwise, the edges (jnp.linspace's arithmetic) as float
    # math
    Case("histogram", lambda rs: [f32(rs, 200, lo=0.0, hi=1.0)],
         {"bins": 5, "range": (0.0, 1.0)}, tol=(EXACT, ELEM)),
    Case("histogram", lambda rs: [f32(rs, 10, 20)], {"bin_cnt": 7},
         tol=(EXACT, ELEM), tag="data_range"),
    Case("index_array", lambda rs: [f32(rs, 2, 3)]),
    Case("index_array", lambda rs: [f32(rs, 2, 3, 2)], {"axes": (2, 0)},
         tag="axes"),
    Case("index_copy", lambda rs: [f32(rs, 4, 3), i32([2, 0]),
                                   f32(rs, 2, 3)], diff=(0, 2)),
    Case("one_hot", lambda rs: [fl([0, 2, 5, -1])], {"depth": 4}),
    Case("one_hot", lambda rs: [i32([[1, 0], [3, 2]])],
         {"depth": 4, "on_value": 2.0, "off_value": -1.0,
          "dtype": "int32"}, tag="values"),
    Case("ravel_multi_index", lambda rs: [fl([[0, 1, 2, 5], [1, 0, 3, 2]])],
         {"shape": (3, 4)}),
    # unique indices: MXNet leaves duplicates undefined
    Case("scatter_nd", lambda rs: [f32(rs, 2), i32([[0, 2], [1, 3]])],
         {"shape": (3, 4)}, diff=(0,)),
    Case("scatter_set_nd", lambda rs: [f32(rs, 3, 4), f32(rs, 2),
                                       i32([[0, 2], [1, 3]])],
         diff=(0, 1)),
    Case("slice_assign", lambda rs: [f32(rs, 3, 4), f32(rs, 2, 2)],
         {"begin": (0, 1), "end": (2, 3)}, diff=(0, 1)),
    Case("slice_assign", lambda rs: [f32(rs, 3, 4), f32(rs, 2, 2)],
         {"begin": (0, 3), "end": (2, 0), "step": (1, -2)}, diff=(0, 1),
         tag="negative_step"),
    Case("slice_assign_scalar", lambda rs: [f32(rs, 3, 4)],
         {"begin": (1, 0), "end": (3, 2), "scalar": 7.0}, diff=(0,)),
    Case("sort", lambda rs: [f32(rs, 3, 5)], diff=(0,)),
    Case("sort", lambda rs: [f32(rs, 3, 5)], {"axis": 0,
                                              "is_ascend": False},
         diff=(0,), tag="descending"),
    Case("take", lambda rs: [f32(rs, 4, 3), fl([[0, 3], [1, 5]])],
         diff=(0,)),
    Case("take", lambda rs: [f32(rs, 4, 3), i32([0, -1, 4])],
         {"axis": 0, "mode": "wrap"}, diff=(0,), tag="wrap"),
    Case("take", lambda rs: [f32(rs, 2, 5), i32([4, 1])], {"axis": 1},
         diff=(0,), tag="axis1"),
    Case("take_along_axis", lambda rs: [f32(rs, 3, 4),
                                        i32([[1], [3], [0]])],
         {"axis": 1}, diff=(0,)),
    Case("topk", lambda rs: [f32(rs, 3, 6)], {"k": 2}),
    Case("topk", lambda rs: [f32(rs, 3, 6)], {"k": 3, "ret_typ": "value",
                                              "axis": 0},
         diff=(0,), tag="value"),
    Case("topk", lambda rs: [f32(rs, 3, 6)], {"k": 2, "ret_typ": "both",
                                              "is_ascend": True},
         diff=(0,), tag="both"),
    Case("topk", lambda rs: [f32(rs, 3, 6)], {"k": 2, "ret_typ": "mask"},
         tag="mask"),
    # equal values: the lower index first, lax.top_k's rule
    Case("topk", lambda rs: [fl([[1, 3, 3, 2, 3], [5, 5, 5, 5, 5]])],
         {"k": 3, "ret_typ": "both"}, tag="ties"),
    Case("unravel", lambda rs: [fl([5, 7, 11, 13, -1])], {"shape": (3, 4)}),
    Case("unravel_index", lambda rs: [fl([0, 6, 11])], {"shape": (3, 4)}),
]


# -- ops_nn ---------------------------------------------------------------

def _ctc_inputs(rs):
    label = fl([[1, 2, 2], [3, 0, 1]])  # a zero inside is padding
    return [f32(rs, 6, 2, 5, lo=-2, hi=2), label]


NN = [
    Case("adaptive_avg_pooling2d", lambda rs: [f32(rs, 1, 2, 4, 6)],
         {"output_size": (2, 3)}, tol=REDUCE, diff=(0,)),
    Case("ctc_loss", _ctc_inputs, tol=CTC, diff=(0,)),
    Case("ctc_loss", lambda rs: [f32(rs, 7, 2, 4, lo=-2, hi=2),
                                 fl([[0, 1, -1], [2, 2, -1]]),
                                 fl([5, 7]), fl([2, 2])],
         {"use_data_lengths": True, "use_label_lengths": True,
          "blank_label": "last"}, tol=CTC, diff=(0,), tag="lengths_last"),
    Case("deconvolution", lambda rs: [f32(rs, 1, 2, 4, 4),
                                      f32(rs, 2, 3, 3, 3)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
          "num_filter": 3}, tol=REDUCE, diff=(0, 1)),
    Case("deconvolution", lambda rs: [f32(rs, 1, 4, 3, 3),
                                      f32(rs, 4, 1, 2, 2), f32(rs, 2)],
         {"kernel": (2, 2), "num_filter": 2, "num_group": 2,
          "no_bias": False}, tol=REDUCE, diff=(0, 1, 2), tag="groups_bias"),
    Case("deconvolution", lambda rs: [f32(rs, 2, 2, 5), f32(rs, 2, 3, 3)],
         {"kernel": (3,), "stride": (2,), "dilate": (2,), "num_filter": 3},
         tol=REDUCE, diff=(0, 1), tag="1d_dilated"),
    Case("group_norm", lambda rs: [f32(rs, 2, 4, 3, 3), f32(rs, 2),
                                   f32(rs, 2)],
         {"num_groups": 2}, tol=REDUCE, diff=(0, 1, 2)),
    Case("instance_norm", lambda rs: [f32(rs, 2, 3, 4, 4), f32(rs, 3),
                                      f32(rs, 3)],
         tol=REDUCE, diff=(0, 1, 2)),
    Case("lrn", lambda rs: [f32(rs, 1, 5, 3, 3)], {"nsize": 3,
                                                   "alpha": 0.1},
         tol=REDUCE, diff=(0,)),
    Case("softmin", lambda rs: [f32(rs, 3, 5)], tol=ELEM, diff=(0,)),
    Case("softmin", lambda rs: [f32(rs, 3, 5)], {"axis": 0}, tol=ELEM,
         diff=(0,), tag="axis0"),
    Case("upsampling", lambda rs: [f32(rs, 1, 2, 2, 3)], {"scale": 2},
         diff=(0,)),
    # align_corners=False upsampling is the JAX op's half-pixel resize
    Case("bilinear_resize2d", lambda rs: [f32(rs, 1, 2, 3, 4)],
         {"height": 6, "width": 8, "align_corners": False}, tol=ELEM,
         diff=(0,)),
    # the argument gap: log_softmax's temperature
    Case("log_softmax", lambda rs: [f32(rs, 3, 5)], {"temperature": 2.0},
         tol=ELEM, diff=(0,), tag="temperature"),
]


# -- ops_legacy -----------------------------------------------------------

def _rois(rs):
    return [f32(rs, 2, 2, 6, 6),
            fl([[0, 0, 0, 3, 3], [1, 1, 1, 5, 4], [0, 2, 0, 2, 5]])]


LEGACY = [
    Case("batch_take", lambda rs: [f32(rs, 3, 4), fl([1, 0, 3])],
         diff=(0,)),
    Case("bilinear_sampler", lambda rs: [f32(rs, 1, 2, 4, 5),
                                         f32(rs, 1, 2, 3, 3, lo=-1.2,
                                             hi=1.2)],
         tol=REDUCE, diff=(0, 1)),
    Case("correlation", lambda rs: [f32(rs, 1, 2, 6, 6),
                                    f32(rs, 1, 2, 6, 6)],
         tol=REDUCE, diff=(0, 1)),
    Case("correlation", lambda rs: [f32(rs, 1, 2, 7, 7),
                                    f32(rs, 1, 2, 7, 7)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 2, "is_multiply": False}, tol=REDUCE, diff=(0, 1),
         tag="k3_absdiff"),
    Case("crop", lambda rs: [f32(rs, 1, 2, 5, 6)], {"offset": (1, 2),
                                                    "h_w": (2, 3)},
         diff=(0,)),
    Case("crop", lambda rs: [f32(rs, 1, 2, 5, 6)], {"h_w": (3, 2),
                                                    "center_crop": True},
         diff=(0,), tag="center"),
    Case("grid_generator", lambda rs: [f32(rs, 2, 6)],
         {"target_shape": (3, 4)}, tol=ELEM, diff=(0,)),
    Case("grid_generator", lambda rs: [f32(rs, 1, 2, 3, 4)],
         {"transform_type": "warp"}, tol=ELEM, diff=(0,), tag="warp"),
    Case("moments", lambda rs: [f32(rs, 3, 4, 2)], {"axes": (0, 2)},
         tol=REDUCE, diff=(0,)),
    Case("moments", lambda rs: [f32(rs, 3, 4)], {"axes": (1,),
                                                 "keepdims": True},
         tol=REDUCE, diff=(0,), out=1, tag="variance"),
    Case("roi_pooling", _rois, {"pooled_size": (2, 2)}, diff=(0,)),
    Case("roi_pooling", _rois, {"pooled_size": (3, 2),
                                "spatial_scale": 0.5}, diff=(0,),
         tag="scaled"),
    Case("smooth_l1", lambda rs: [f32(rs, 3, 4, lo=-2, hi=2)],
         {"scalar": 1.5}, tol=ELEM, diff=(0,)),
    Case("spatial_transformer",
         lambda rs: [f32(rs, 1, 2, 4, 5),
                     fl([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]])],
         {"target_shape": (3, 4)}, tol=REDUCE, diff=(0, 1)),
    Case("svm_output", lambda rs: [f32(rs, 3, 4), fl([0, 2, 1])],
         diff=(0,)),
    Case("svm_output", lambda rs: [f32(rs, 3, 4), fl([3, 0, 1])],
         {"margin": 0.5, "regularization_coefficient": 2.0,
          "use_linear": True}, diff=(0,), tag="linear"),
]

ALL = BASIC + INDEX + NN + LEGACY
# output shapes that depend on the data: the host waits for them, so no
# CUDA graph can hold them
DATA_DEPENDENT = ("boolean_mask",)
# the random ops and their settings, drawn on the card under capture
RANDOM = [
    ("random_uniform", {"low": -1.0, "high": 2.0, "shape": (4096,)}),
    ("random_normal", {"loc": 1.0, "scale": 2.0, "shape": (4096,)}),
    ("random_randint", {"low": 0, "high": 1000, "shape": (4096,)}),
    ("random_exponential", {"lam": 2.0, "shape": (4096,)}),
    ("random_poisson", {"lam": 30.0, "shape": (4096,)}),
    ("random_gamma", {"alpha": 2.5, "beta": 1.5, "shape": (4096,)}),
    ("random_negative_binomial", {"k": 3, "p": 0.2, "shape": (4096,)}),
    ("random_generalized_negative_binomial", {"mu": 20.0, "alpha": 0.5,
                                              "shape": (4096,)}),
    ("random_gumbel", {"shape": (4096,)}),
]


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _inputs(case, device):
    rs = case.rng()
    arrays = case.make(rs)
    return [torch.from_numpy(a.copy()).to(device) for a in arrays], rs


def _forward_backward(case, device):
    """The case's outputs and, for its ``diff`` inputs, the gradients of
    a random cotangent (from the case's RandomState), on ``device``."""
    xs, rs = _inputs(case, device)
    fn = registry.get_op(case.op).fn
    outs = [o.detach() for o in _outs(fn(*xs, **case.kw))]
    if not case.diff:
        return outs, []
    ct = torch.from_numpy(rs.standard_normal(
        tuple(outs[case.out].shape)).astype("float32")).to(device)
    leaves = []
    for i in case.diff:
        xs[i] = xs[i].detach().requires_grad_(True)
        leaves.append(xs[i])
    with torch.enable_grad():
        y = _outs(fn(*xs, **case.kw))[case.out]
        # in the port's backward scopes: cuDNN in float32, not TF32
        grads = autograd._torch_grad([y], leaves, [ct], retain_graph=False)
    return outs, list(grads)


def _float_tol(case):
    return (CTC, 0.0) if case.tol == CTC else (1e-5, 1e-6)


def _deviation(got, want, rtol, atol):
    """The largest |got - want| over its bound (rtol |want| + atol); 0
    where equal."""
    got, want = got.double(), want.double()
    if got.numel() == 0:
        return 0.0
    over = (got - want).abs() / (rtol * want.abs() + atol)
    over = torch.where(got == want, torch.zeros_like(over), over)
    return float(over.max())


def card_sweep(device):
    """Every case on ``device`` against the CPU port on the same inputs:
    the forward bitwise for ``EXACT`` outputs, else within the float
    bound, and the gradients within the float bound. Returns one row per
    case; raises :class:`MXNetError` naming every case that disagrees."""
    rows, bad = [], []
    for case in ALL:
        outs, grads = _forward_backward(case, device)
        c_outs, c_grads = _forward_backward(case, torch.device("cpu"))
        rtol, atol = _float_tol(case)
        row = {"case": case.id, "exact_outputs": 0, "worst": 0.0}
        for t, c, tol in zip(outs, c_outs, case.tols(len(c_outs))):
            t = t.cpu()
            if t.shape != c.shape or t.dtype != c.dtype:
                bad.append(f"{case.id}: {t.dtype}{tuple(t.shape)} against "
                           f"{c.dtype}{tuple(c.shape)}")
            elif tol == EXACT:
                row["exact_outputs"] += 1
                if not torch.equal(t, c):
                    bad.append(f"{case.id}: not bitwise")
            else:
                row["worst"] = max(row["worst"], _deviation(t, c, rtol, atol))
        for t, c in zip(grads, c_grads):
            row["worst"] = max(row["worst"],
                               _deviation(t.cpu(), c, rtol, atol))
        if row["worst"] > 1.0:
            bad.append(f"{case.id}: {row['worst']:.3g} x its bound")
        rows.append(row)
    if bad:
        raise MXNetError("op sweep on the card: " + "; ".join(bad))
    return rows


def capture_check(device):
    """Every deterministic case but the ``DATA_DEPENDENT`` ones, forward,
    in one CUDA graph: warmed up eagerly on a side stream, captured, then
    replayed; each replayed output must equal the eager call bitwise (a
    host copy or sync inside an op fails the capture). Returns the count
    of captured cases."""
    cases = [c for c in ALL if c.op not in DATA_DEPENDENT]
    inputs = [_inputs(c, device)[0] for c in cases]
    fns = [registry.get_op(c.op).fn for c in cases]

    def run_all():
        return [[o for o in _outs(fn(*xs, **c.kw))]
                for c, fn, xs in zip(cases, fns, inputs)]

    # cuDNN held to deterministic algorithms, so that the eager call and
    # the replay may be compared bitwise (the port's cuDNN scope reads
    # the flag)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=True):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(side):
            eager = [[o.clone() for o in outs] for outs in run_all()]
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), cuda_graph(graph):
                static = run_all()
        except RuntimeError as e:
            raise MXNetError(f"op sweep: the one-graph capture failed "
                             f"({e}); cases that fail alone: "
                             f"{_uncapturable(cases, fns, inputs)}") from e
        graph.replay()
        torch.cuda.synchronize(device)
    bad = [c.id for c, e, s in zip(cases, eager, static)
           if any(not torch.equal(a, b) for a, b in zip(e, s))]
    if bad:
        raise MXNetError(f"op sweep: the replay differs from the eager "
                         f"call for {bad}")
    return len(cases)


def _uncapturable(cases, fns, inputs):
    """The ids of the cases whose forward fails a capture of its own."""
    bad = []
    for c, fn, xs in zip(cases, fns, inputs):
        try:
            with torch.no_grad(), cuda_graph(torch.cuda.CUDAGraph()):
                fn(*xs, **c.kw)
        except RuntimeError:
            bad.append(c.id)
    return bad


def random_capture_check(device):
    """The random ops captured in one CUDA graph with the device's
    generator registered: two replays draw different numbers; after
    ``mx.random.seed`` a replay draws what the replay after the same seed
    drew. Returns the count of random ops captured."""
    gen = _random.device_generator(device)
    ctx_kw = {"ctx": _ctx(device)}
    probs = torch.tensor([[0.1, 0.2, 0.3, 0.4]] * 64, device=device)
    low = torch.zeros(64, device=device)
    high = torch.ones(64, device=device) * 3
    rows = torch.arange(4096.0, device=device).reshape(512, 8)

    def draws():
        out = [registry.get_op(n).fn(**kw, **ctx_kw) for n, kw in RANDOM]
        out.append(registry.get_op("sample_uniform").fn(low, high,
                                                         shape=(64,)))
        out.append(registry.get_op("sample_normal").fn(low, high,
                                                        shape=(64,)))
        out.append(registry.get_op("sample_multinomial").fn(probs,
                                                             shape=(64,)))
        out.append(registry.get_op("shuffle").fn(rows))
        return out

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.stream(side):
        draws()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.no_grad(), cuda_graph(graph):
        static = draws()

    def replay():
        graph.replay()
        return [s.clone() for s in static]

    _random.seed(11)
    first = replay()
    second = replay()
    same = [i for i, (a, b) in enumerate(zip(first, second))
            if torch.equal(a, b)]
    _random.seed(11)
    again = replay()
    differ = [i for i, (a, b) in enumerate(zip(first, again))
              if not torch.equal(a, b)]
    if same or differ:
        raise MXNetError(f"random ops under capture: outputs {same} did not "
                         f"change between replays, outputs {differ} did not "
                         "repeat after the seed")
    return len(static)


def _ctx(device):
    from ..context import Context

    return Context.from_device(device)
