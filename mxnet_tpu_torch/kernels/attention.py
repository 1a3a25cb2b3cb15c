"""Attention cluster ops: ``_fused_attention``, ``_cache_append`` and
``_attention_decode``.

The PyTorch counterparts of ``mxnet_tpu/kernels/attention.py:37-128``:

- ``_fused_attention`` is the op the fusion pass emits for the composed
  ``batch_dot(softmax(batch_dot(q, k, T) [*/ scale]), v)`` over (B, S, D)
  operands. ``impl="torch"`` replays the registered batch_dot, scalar
  scale and softmax bodies (bit-identical to the unfused subgraph), the
  counterpart of ``"lax"``; ``impl="cuda"`` runs the flash-attention
  kernel K1 on ``q[:, None]`` views (a singleton head axis), as the JAX
  op rides its Pallas flash kernel.
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

from ..ndarray.registry import get_op, register
from .flash_attention import _decode_flash, _decode_flash_ref, flash_attention


def _replay(q, k, v, scale_op, scale, softmax_kw):
    """The unfused subgraph, replayed body for body."""
    bd = get_op("batch_dot").fn
    s = bd(q, k, transpose_b=True)
    if scale_op == "mul":
        s = get_op("broadcast_mul_scalar").fn(s, scalar=scale)
    elif scale_op == "div":
        s = get_op("broadcast_div_scalar").fn(s, scalar=scale)
    p = get_op("softmax").fn(s, **dict(softmax_kw))
    return bd(p, v)


@register("_fused_attention", namespaces=())
def _fused_attention(q, k, v, scale_op="none", scale=1.0, softmax_kw=(),
                     impl="torch"):
    """Fused score→softmax→weighted-sum attention cluster over (B, S, D)
    operands, emitted by the fusion pass. ``impl="torch"`` replays the
    registered bodies (bit-identical to the unfused subgraph);
    ``impl="cuda"`` runs K1 (online softmax in fp32; documented-ulp
    against the replay). (Reference: the composed
    src/operator/tensor/dot.cc + nn/softmax.cc subgraph.)"""
    if impl == "cuda":
        sm_scale = (float(scale) if scale_op == "mul"
                    else 1.0 / float(scale) if scale_op == "div" else 1.0)
        # K1 reads every axis through its stride but the last: a
        # permuted view (the port's transpose) is copied, not refused
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        out = flash_attention(q[:, None], k[:, None], v[:, None],
                              sm_scale=sm_scale, use_kernel=True)
        return out[:, 0]
    if impl != "torch":
        raise ValueError(f"_fused_attention: unknown impl {impl!r} "
                         "(expected 'torch' or 'cuda')")
    return _replay(q, k, v, scale_op, scale, softmax_kw)


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
