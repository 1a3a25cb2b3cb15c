"""Neural-network ops the decoder uses.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_nn.py:33,206,338,411``.
The JAX package left these to XLA, so the port leaves them to torch
(``F.linear``, ``F.layer_norm``, indexing) — no hand kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register()
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """Reference: src/operator/nn/fully_connected-inl.h. ``weight`` is
    (num_hidden, input_dim) as in MXNet, which is ``F.linear``'s layout."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


@register()
def activation(data, act_type="relu"):
    """Reference: src/operator/nn/activation-inl.h. Only ``relu``, the
    decoder's activation, is ported yet."""
    if act_type == "relu":
        return torch.relu(data)
    raise ValueError(f"act_type {act_type!r} is not ported yet (relu is)")


@register()
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Reference: src/operator/nn/layer_norm.cc — population variance,
    ``(x - mean) * rsqrt(var + eps) * gamma + beta`` over ``axis``."""
    axis = axis % data.dim()
    if axis == data.dim() - 1:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


@register()
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Reference: src/operator/tensor/indexing_op.h (Embedding). Row
    lookup with the JAX package's out-of-range rule (``jnp.take``'s fill
    mode): a negative index counts from the end, and an index outside
    ``[-V, V)`` yields a row of NaN instead of raising — so a lookup
    never traps on the device."""
    V = weight.shape[0]
    idx = data.to(torch.int64)
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    out = weight[idx.clamp(0, V - 1)]
    if weight.is_floating_point():
        out = torch.where(valid.unsqueeze(-1), out,
                          torch.full_like(out, float("nan")))
    return out
