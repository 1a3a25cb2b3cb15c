"""Per-cluster cost model: fuse or keep the 1:1 lowering, and with
which implementation.

The PyTorch counterpart of ``mxnet_tpu/kernels/cost_model.py``, with
the same decisions and reasons: ``cost_model_never`` under
``MXNET_FUSION_COST_MODEL=never``, ``too_small`` below
``MIN_CLUSTER`` ops, ``compute_bound_attention`` for a replayed
attention cluster whose score matrix reaches 64 x 64, ``bandwidth_bound``
for an elementwise chain past 2**22 elements. The thresholds are the
JAX module's declared defaults (its autotune lookups come with the
platform slice).

The viability rule replaces the TPU's 8 x 128 tile floor
(``cost_model.py:29-32,51-60``): the implementation is ``cuda``, the
hand-written kernel, when the graph runs on a CUDA device and the kernel
takes the cluster — K3 for ``norm_act`` (norm over the last axis, width
at most ``norm_act.MAX_C``, float32 or bfloat16), K1 for ``attention``
(q (B, S_q, D) against k and v of one shape (B, S_k, D), head dim at
most 256, float32 or bfloat16); every operand of the cluster's dtype.
Otherwise it is ``torch``, the replay of the member ops. A cluster on a
CUDA device that a kernel does not take is still fused, as a replay, and
its ``Decision.reason`` names why (the fusion pass counts it as
``replay_<reason>``), except ``shape_unknown``, on which the fusion pass
raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

#: a fused elementwise cluster must absorb at least this many ops
MIN_CLUSTER = 2
#: score length from which a replayed attention cluster is compute-bound
_ATTN_COMPUTE_BOUND_SEQ = 64
#: past 2**this elements an elementwise chain is bandwidth-bound
_ELEMENTWISE_BANDWIDTH_LOG2 = 22

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@dataclass(frozen=True)
class Decision:
    """One cluster decision: ``fuse=False`` keeps the 1:1 lowering,
    ``impl`` is ``torch`` or ``cuda`` when fusing, ``reason`` names a
    rejection, or why a CUDA cluster is replayed."""
    fuse: bool
    impl: str = "torch"
    reason: str = "ok"


def _kernel_refusal(pattern, out_shape, dtype, norm_axis, operands):
    """None when the pattern's CUDA kernel takes the cluster, else the
    reason it does not. ``operands`` are the cluster inputs' ``(shape,
    dtype)`` pairs (data, gamma, beta for ``norm_act``; q, k, v for
    ``attention``), or None when the caller has none to give."""
    from .flash_attention import _MAX_D
    from .norm_act import MAX_C

    if pattern not in ("norm_act", "attention"):
        return "no_kernel"
    if not out_shape or dtype is None or any(
            s is None or d is None for s, d in operands or ()):
        return "shape_unknown"
    if dtype not in _KERNEL_DTYPES:
        return "kernel_dtype"
    if any(d != dtype for _, d in operands or ()):
        return "operand_dtype"
    if pattern == "norm_act":
        if norm_axis not in (-1, len(out_shape) - 1):
            return "norm_axis"
        if not 0 < out_shape[-1] <= MAX_C:
            return "norm_width"
        return None
    if len(out_shape) != 3 or not 0 < out_shape[-1] <= _MAX_D \
            or out_shape[0] > 65535:
        return "attention_shape"
    if operands:
        # K1 takes (B, S_q, D) q against (B, S_k, D) k and v
        q, k, v = (tuple(s) for s, _ in operands)
        if len(q) != 3 or len(k) != 3 or v != k or q[0] != k[0] \
                or q[2] != k[2]:
            return "attention_operands"
    return None


def decide(pattern, n_nodes, out_shape=None, device=None, mode="heuristic",
           score_shape=None, dtype=None, norm_axis=-1, operands=None):
    """``Decision(fuse, impl, reason)`` for one cluster.

    ``pattern`` is the cluster kind, ``n_nodes`` its op count,
    ``out_shape``/``dtype`` the cluster output's when inference resolved
    them, ``device`` the device the graph runs on, ``mode`` the
    ``MXNET_FUSION_COST_MODEL`` knob, ``score_shape`` the (..., S_q,
    S_k) score shape of an attention cluster, ``norm_axis`` a norm
    cluster's axis, ``operands`` the cluster inputs' ``(shape, dtype)``
    pairs (see :func:`_kernel_refusal`)."""
    if mode == "never":
        return Decision(False, reason="cost_model_never")
    impl, why = "torch", "ok"
    if device is not None and torch.device(device).type == "cuda":
        refusal = _kernel_refusal(pattern, out_shape, dtype, norm_axis,
                                  operands)
        if refusal is None:
            impl = "cuda"
        elif refusal != "no_kernel":
            why = refusal
    if mode == "always":
        return Decision(True, impl=impl, reason=why)
    if n_nodes < MIN_CLUSTER:
        return Decision(False, reason="too_small")
    if (pattern == "attention" and impl == "torch"
            and score_shape is not None and len(score_shape) >= 2
            and score_shape[-2] >= _ATTN_COMPUTE_BOUND_SEQ
            and score_shape[-1] >= _ATTN_COMPUTE_BOUND_SEQ):
        return Decision(False, reason="compute_bound_attention")
    if pattern == "elementwise" and out_shape is not None:
        size = 1
        for d in out_shape:
            size *= int(d)
        if size > (1 << _ELEMENTWISE_BANDWIDTH_LOG2):
            return Decision(False, reason="bandwidth_bound")
    return Decision(True, impl=impl, reason=why)
