"""Decode-mode attention ops: ``_cache_append`` and ``_attention_decode``.

The PyTorch counterparts of ``mxnet_tpu/kernels/attention.py:76-128``,
the two registered ops a KV-cache decoder block threads through the
stateful serving stack:

- ``_cache_append`` writes one step's projected K (or V) row into the
  cache at the row's position. The JAX op is an exact XLA scatter that
  returns a new cache; this one writes the row **in place** and returns
  the same tensor, which saves a copy of the whole cache per layer and
  step. The caller therefore hands it caches it owns: the serving
  session passes its own copy of explicit states and the state store's
  gather output, never a caller's tensor.
- ``_attention_decode`` attends one query row against the positions
  ``<= pos``. ``impl="torch"`` is the plain path (the counterpart of
  ``"lax"``), ``impl="cuda"`` the hand-written kernel K2 (the
  counterpart of ``"pallas"``); on CPU tensors both run the plain
  arithmetic.
"""
from __future__ import annotations

import torch

from ..ndarray.registry import register
from .flash_attention import _decode_flash, _decode_flash_ref


@register("_cache_append", differentiable=False, namespaces=())
def _cache_append(cache, step, pos):
    """Write ``step`` (B, E) into ``cache`` (B, S, E) at per-row
    position ``pos`` (B, 1), in place; returns ``cache``. Positions
    follow the JAX op's ``.at[].set`` rule: a negative position counts
    from the end, and a position outside ``[-S, S)`` drops that row's
    write (the cache row is left as it was) instead of raising."""
    B, S = cache.shape[:2]
    idx = pos.reshape(B).to(torch.int64)
    idx = torch.where(idx < 0, idx + S, idx)
    valid = ((idx >= 0) & (idx < S)).unsqueeze(-1)
    rows = torch.arange(B, device=cache.device)
    idx = idx.clamp(0, S - 1)
    cache[rows, idx] = torch.where(valid, step.to(cache.dtype),
                                   cache[rows, idx])
    return cache


@register("_attention_decode", differentiable=False, namespaces=())
def _attention_decode(q, k_cache, v_cache, pos, num_heads=1, sm_scale=1.0,
                      impl="torch"):
    """Incremental decode attention: ONE query row (B, E) against the
    session's KV cache (B, S, E), masked to positions ``<= pos``
    (inclusive: the step's own K/V was just appended at ``pos``).
    Cache entries past the mask get exactly zero weight, so whatever
    lies beyond the prefix never leaks."""
    B, S, E = k_cache.shape
    H = int(num_heads)
    D = E // H
    n = pos.reshape(B).to(torch.int32) + 1  # visible length
    qh = q.reshape(B, H, D)
    kh = k_cache.reshape(B, S, H, D)
    vh = v_cache.reshape(B, S, H, D)
    if impl == "cuda":
        out = _decode_flash(qh.contiguous(), kh, vh, n, float(sm_scale))
    elif impl == "torch":
        out = _decode_flash_ref(qh, kh, vh, n, float(sm_scale))
    else:
        raise ValueError(f"_attention_decode: unknown impl {impl!r} "
                         "(expected 'torch' or 'cuda')")
    return out.reshape(B, E)
