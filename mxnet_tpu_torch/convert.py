"""Carry weights across: numpy arrays into a port block.

The arrays are keyed by the structural parameter names that
``Block._collect_params_with_prefix()`` gives — the names the JAX
package's ``save_parameters`` writes, e.g. ``embed.weight``,
``q_proj_0.weight``, ``ln1_0.gamma``, ``ffn1_0.bias``, ``head.weight``
for :class:`~.models.DecoderBlockLM`. ``Dense`` weights keep MXNet's
``(units, in_units)`` layout, which is also ``torch.nn.Linear``'s, so
nothing is transposed. Weights are copied, never re-drawn from a seed.
"""
from __future__ import annotations

import numpy as onp

from .base import MXNetError

__all__ = ["params_from_numpy"]


def params_from_numpy(block, arrays, ctx=None):
    """Load ``arrays`` (``{structural name: numpy array}``) into
    ``block``'s parameters and return ``block``.

    A parameter that is already allocated keeps its device; one that is
    not (never initialized, or deferred by ``in_units=0``) is allocated
    holding its array on its deferred device, else on ``ctx`` (default:
    the current context, ``gpu(0)``). Raises :class:`MXNetError` on a
    missing or extra name, or on a shape mismatch, before any parameter
    is written."""
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
        if want is None or len(want) != len(got) or any(
                w not in (0, g) for w, g in zip(want, got)):
            raise MXNetError(f"params_from_numpy: {name} has shape {got}, "
                             f"the block declares {want}")
    for name, p in params.items():
        p.set_data(values[name], ctx=ctx)
    return block
