"""Carry weights and optimizer states across: numpy arrays into the port.

The arrays are keyed by the structural parameter names that
``Block._collect_params_with_prefix()`` gives — the names the JAX
package's ``save_parameters`` writes, e.g. ``embed.weight``,
``q_proj_0.weight``, ``ln1_0.gamma``, ``ffn1_0.bias``, ``head.weight``
for :class:`~.models.DecoderBlockLM`. ``Dense`` weights keep MXNet's
``(units, in_units)`` layout, which is also ``torch.nn.Linear``'s, so
nothing is transposed. Weights are copied, never re-drawn from a seed.
bfloat16 arrays (``ml_dtypes.bfloat16``, as the JAX package's
``asnumpy`` returns them) are carried bit for bit through an int16 view.

A symbolic :class:`~.module.Module` names its parameters by the symbol's
argument names (``fc1_weight``, ``lstm_i2h_bias``, ``rnn_parameters``):
:func:`module_params_from_numpy` loads a JAX ``Module.get_params()``
pair, as numpy, by those names. A Gluon RNN layer's parameters
(``l0_i2h_weight``, ...) load through :func:`params_from_numpy` like any
block's.
"""
from __future__ import annotations

import numpy as onp

from .base import MXNetError

__all__ = ["params_from_numpy", "module_params_from_numpy",
           "trainer_states_from_numpy"]


def params_from_numpy(block, arrays, ctx=None):
    """Load ``arrays`` (``{structural name: numpy array}``) into
    ``block``'s parameters and return ``block``.

    A parameter that is already allocated keeps its device and dtype;
    one that is not (never initialized, or deferred by ``in_units=0``)
    is allocated holding its array on its deferred device, else on
    ``ctx`` (default: the current context, ``gpu(0)``); a parameter
    with no declared shape (a ``SymbolBlock``'s) takes its array's, and
    an integer array (an offline-quantized int8 weight) gives such a
    parameter its dtype. Raises
    :class:`MXNetError` on a missing or extra name, or on a shape
    mismatch, before any parameter is written."""
    params = block._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(
            f"params_from_numpy: missing {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}, extra {extra[:5]}"
            f"{'...' if len(extra) > 5 else ''} for "
            f"{type(block).__name__}")
    values = {name: onp.asarray(arrays[name]) for name in params}
    for name, p in params.items():
        want = p.shape
        got = values[name].shape
        if want is not None and (len(want) != len(got) or any(
                w not in (0, g) for w, g in zip(want, got))):
            raise MXNetError(f"params_from_numpy: {name} has shape {got}, "
                             f"the block declares {want}")
    for name, p in params.items():
        if p._ndarray is None and values[name].dtype.kind in "iu":
            # an int8 quantized weight keeps its dtype, and takes no
            # gradient (the declared default would cast it to float32)
            p.dtype = values[name].dtype
            p.grad_req = "null"
        p.set_data(values[name], ctx=ctx)
    return block


def module_params_from_numpy(module, arg_params, aux_params=None):
    """Load ``arg_params``/``aux_params`` (``{argument name: numpy
    array}``, a JAX ``Module.get_params()`` as host arrays) into the
    symbolic ``module`` and return it: into its bound arrays, in place,
    when it is bound, else at its bind. Every parameter of the symbol
    must be given, and nothing else; raises :class:`MXNetError` before
    anything is written otherwise."""
    from .context import cpu
    from .ndarray import array

    sym = module.symbol
    inputs = set(module.data_names) | set(module.label_names)
    want = [n for n in sym.list_arguments() if n not in inputs]
    want_aux = sym.list_auxiliary_states()
    aux_params = aux_params or {}
    for what, need, got in (("arguments", want, arg_params),
                            ("aux states", want_aux, aux_params)):
        missing = sorted(set(need) - set(got))
        extra = sorted(set(got) - set(need))
        if missing or extra:
            raise MXNetError(f"module_params_from_numpy: {what} missing "
                             f"{missing[:5]}, extra {extra[:5]}")
    host = cpu()
    args = {k: array(onp.asarray(v), ctx=host) for k, v in arg_params.items()}
    aux = {k: array(onp.asarray(v), ctx=host) for k, v in aux_params.items()}
    if module.binded:
        bound = module._exec.arg_dict
        bound_aux = module._exec.aux_dict
        for k, v in list(args.items()) + list(aux.items()):
            b = bound.get(k, bound_aux.get(k))
            if b.shape != v.shape:
                raise MXNetError(f"module_params_from_numpy: {k} has shape "
                                 f"{v.shape}, the module binds {b.shape}")
    module.set_params(args, aux, force_init=True)
    return module


def trainer_states_from_numpy(trainer, states, num_update=None,
                              index_update_count=None):
    """Load optimizer states into ``trainer`` and return it: ``states``
    holds, per parameter of the trainer (in its order), None, a numpy
    array or a tuple of them nested as the optimizer builds them —
    momenta, Adam's ``(mean, var)``, ``(master, base)`` for a
    multi-precision half parameter — the JAX Trainer's ``_states`` as
    host arrays. Each lands on its parameter's device, in the layout and
    dtypes the port's optimizer makes (its own state, if the trainer has
    one, is overwritten in place). ``num_update`` and
    ``index_update_count`` set the optimizer's update counts (Adam's bias
    correction reads them). Raises :class:`MXNetError` on a layout or
    shape mismatch before anything is written."""
    import torch

    from .ndarray.ndarray import host_tensor

    if trainer._states is None:
        trainer._create_states()
    if len(states) != len(trainer._states):
        raise MXNetError(f"trainer_states_from_numpy: {len(states)} states "
                         f"for {len(trainer._states)} parameters")

    pairs = []

    def walk(mine, theirs, where):
        if mine is None or theirs is None:
            if mine is not None or theirs is not None:
                raise MXNetError(f"trainer_states_from_numpy: state "
                                 f"{where} is None on one side only")
            return
        if isinstance(mine, tuple):
            if not isinstance(theirs, (tuple, list)) or \
                    len(theirs) != len(mine):
                raise MXNetError(f"trainer_states_from_numpy: state "
                                 f"{where} is a {len(mine)}-tuple here")
            for k, (m, t) in enumerate(zip(mine, theirs)):
                walk(m, t, f"{where}[{k}]")
            return
        arr = onp.asarray(theirs)
        if tuple(arr.shape) != tuple(mine.shape):
            raise MXNetError(f"trainer_states_from_numpy: state {where} "
                             f"has shape {arr.shape}, expected "
                             f"{tuple(mine.shape)}")
        pairs.append((mine.data, arr))

    for i, (mine, theirs) in enumerate(zip(trainer._states, states)):
        walk(mine, theirs, str(i))
    with torch.no_grad():
        for dst, arr in pairs:
            dst.copy_(host_tensor(arr).to(device=dst.device,
                                          dtype=dst.dtype))
    optim = trainer._optimizer
    if num_update is not None:
        optim.num_update = optim.begin_num_update = int(num_update)
    if index_update_count is not None:
        optim._index_update_count = {int(k): int(v) for k, v in
                                     dict(index_update_count).items()}
    trainer._invalidate_fused_state()
    return trainer
