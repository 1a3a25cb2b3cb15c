"""Neural-network ops the decoder and the transformer use.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_nn.py:33,206,247,276,
338,393,411,420,727``. The JAX package left these to XLA, so the port
leaves them to torch (``F.linear``, ``F.layer_norm``, softmax,
indexing), with one exception: ``flash_attention`` runs the
hand-written CUDA kernel K1 (``kernels/flash_attention.py``), as the
JAX op runs the Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
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


@register()
def softmax(data, axis=-1):
    """Reference: src/operator/nn/softmax.cc (without the ``length``
    mask, temperature and output dtype, which no ported path uses)."""
    return torch.softmax(data, dim=axis)


@register()
def log_softmax(data, axis=-1):
    """log(softmax(x)) along ``axis``, computed stably (reference:
    softmax.cc log_softmax)."""
    return torch.log_softmax(data, dim=axis)


@register()
def softmax_cross_entropy(data, label):
    """Summed negative log-likelihood of integer ``label`` under
    softmax(``data``) over the last axis (reference:
    src/operator/loss_binary_op.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1,
                         label.to(torch.int64).unsqueeze(-1)).sum()


@register()
def dropout(data, p=0.5, axes=()):
    """Reference: src/operator/nn/dropout-inl.h. The identity at ``p ==
    0`` or outside training, as the JAX op is; otherwise each element
    (or, with ``axes``, each slice along them) is kept with probability
    1 - p, drawn from the device's generator (``mx.random``), and scaled
    by 1 / (1 - p)."""
    if p == 0 or not autograd.is_training():
        return data
    shape = tuple(1 if i in axes else n for i, n in enumerate(data.shape))
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device)) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


@register(name="flash_attention")
def flash_attention_op(query, key, value, sm_scale=None, causal=False):
    """Blockwise attention over (B, H, S, D): the hand-written kernel K1
    on CUDA tensors, its plain version on CPU tensors; the backward is
    the q-chunk recompute (``kernels/flash_attention.py``)."""
    from ..kernels.flash_attention import flash_attention

    return flash_attention(query, key, value, sm_scale=sm_scale,
                           causal=causal)
