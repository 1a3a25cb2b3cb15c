"""Custom Python operators: ``CustomOp``, ``CustomOpProp`` and ``nd.Custom``.

The PyTorch counterpart of ``mxnet_tpu/operator.py`` (reference:
python/mxnet/operator.py over src/operator/custom/custom.cc). A user
subclasses :class:`CustomOpProp` (arguments, outputs, shape and type
inference, ``need_top_grad``) and :class:`CustomOp` (``forward`` and
``backward`` writing their outputs through :meth:`CustomOp.assign`),
registers the prop under a name with :func:`register`, and calls it as
``nd.Custom(*inputs, op_type=name, **kwargs)``.

- ``infer_shape`` and ``infer_type`` size the outputs, which are fresh,
  zeroed, contiguous tensors on the inputs' device: a kernel written for
  ``rtc.CudaModule`` writes them through raw pointers.
- ``forward`` runs under ``autograd.pause(train_mode=is_train)`` with
  ``req = ["write"] * outputs``.
- Under ``autograd.record()`` the op is one ``torch.autograd.Function``:
  its backward calls the user's ``backward`` with ``out_grad`` (the
  head gradients, zeros for an output nothing used), ``in_data``,
  ``out_data`` and fresh zeroed ``in_grad`` buffers, ``req = ["write"]``
  for every input as in the JAX package, and hands torch the gradients
  of the inputs that need one.
- ``need_top_grad`` is kept on the prop (``declare_backward_dependency``);
  the op receives the head gradients either way and may ignore them, as a
  loss head does.
- An unregistered ``op_type`` raises ``ValueError``.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError
from .context import Context
from .ndarray import NDArray
from .ndarray.ndarray import torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "invoke_custom"]

_CUSTOM_OPS = {}


class CustomOp:
    """Base class for user ops (reference: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by the request: ``"write"`` and
        ``"inplace"`` overwrite, ``"add"`` accumulates, ``"null"`` does
        nothing (reference: CustomOp.assign)."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError(f"unknown request {req!r} (expected 'write', "
                             "'inplace', 'add' or 'null')")


class CustomOpProp:
    """Reference: operator.py CustomOpProp."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Decorator registering a :class:`CustomOpProp` under ``reg_name``
    (reference: operator.py register)."""

    def deco(prop_cls):
        _CUSTOM_OPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered():
    return dict(_CUSTOM_OPS)


def _fresh_outputs(shapes, dtypes, device):
    return [NDArray(torch.zeros(tuple(s), dtype=torch_dtype(t),
                                device=device))
            for s, t in zip(shapes, dtypes)]


def _run_forward(op, is_train, n_out, out_shapes, out_types, inputs):
    out_data = _fresh_outputs(out_shapes, out_types, inputs[0].data.device)
    with autograd.pause(train_mode=is_train):
        op.forward(is_train=is_train, req=["write"] * n_out,
                   in_data=inputs, out_data=out_data, aux=[])
    return out_data


class _CustomFunction(torch.autograd.Function):
    """One tape node for the whole custom op: forward runs the user's
    ``forward``, backward the user's ``backward``."""

    @staticmethod
    def forward(ctx, op, is_train, out_shapes, out_types, *tensors):
        inputs = [NDArray(t) for t in tensors]
        outs = _run_forward(op, is_train, len(out_shapes), out_shapes,
                            out_types, inputs)
        ctx.op = op
        ctx.save_for_backward(*tensors, *[o.data for o in outs])
        ctx.n_in = len(tensors)
        return tuple(o.data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins = [NDArray(t) for t in saved[:ctx.n_in]]
        outs = [NDArray(t) for t in saved[ctx.n_in:]]
        in_grad = [NDArray(torch.zeros_like(t)) for t in saved[:ctx.n_in]]
        with autograd.pause():
            ctx.op.backward(req=["write"] * ctx.n_in,
                            out_grad=[NDArray(g) for g in grads],
                            in_data=ins, out_data=outs, in_grad=in_grad,
                            aux=[])
        return (None, None, None, None) + tuple(
            g.data if need else None
            for g, need in zip(in_grad, ctx.needs_input_grad[4:]))


def invoke_custom(op_type, args, kwargs):
    """Run the custom op registered as ``op_type`` on NDArrays ``args``
    (the ``nd.Custom`` path); keyword arguments reach the prop as
    strings, as in the reference."""
    prop_cls = _CUSTOM_OPS.get(op_type)
    if prop_cls is None:
        raise ValueError(f"custom op '{op_type}' not registered")
    prop = prop_cls(**{k: str(v) for k, v in kwargs.items()})
    n_in = len(prop.list_arguments())
    n_out = len(prop.list_outputs())
    inputs = [a if isinstance(a, NDArray) else NDArray(a) for a in args]
    if len(inputs) != n_in:
        raise MXNetError(f"{op_type} expects {n_in} inputs "
                         f"{prop.list_arguments()}, got {len(inputs)}")
    if len({a.data.device for a in inputs}) > 1:
        raise MXNetError(f"{op_type}: inputs lie on different devices")
    in_shapes, out_shapes, _ = prop.infer_shape([list(a.shape)
                                                 for a in inputs])
    _, out_types, _ = prop.infer_type([a.dtype for a in inputs])
    op = prop.create_operator(Context.from_device(inputs[0].data.device),
                              in_shapes, [a.dtype for a in inputs])
    is_train = autograd.is_training()
    if autograd.is_recording() and any(a.data.requires_grad
                                       for a in inputs):
        with torch.enable_grad():
            outs = _CustomFunction.apply(op, is_train, out_shapes, out_types,
                                         *[a.data for a in inputs])
        out_data = [NDArray(t) for t in outs]
    else:
        out_data = _run_forward(op, is_train, n_out, out_shapes, out_types,
                                inputs)
    return out_data[0] if n_out == 1 else out_data
