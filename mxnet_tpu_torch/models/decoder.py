"""Decoder-block LM for incremental (KV-cache) serving.

The PyTorch counterpart of ``mxnet_tpu/models/decoder.py:54-159``, with
the same constructor, state protocol and step contract: a **decode
step** ``forward(token, *kv_caches, pos)`` consumes one token per stream
and threads its per-layer KV caches as explicit state tensors, the flat
``(*inputs, *states) -> (*outputs, *new_states)`` contract a stateful
:class:`~mxnet_tpu_torch.serving.session.InferenceSession` drives.

Attention per step is the registered ``_cache_append`` /
``_attention_decode`` pair (``kernels/attention.py``): append this
step's projected K/V at ``pos``, attend against positions ``<= pos``.
"""
from __future__ import annotations

import math

from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import kernels as _kernels  # noqa: F401 — registers the decode ops
from ..ndarray import registry as _registry

__all__ = ["DecoderBlockLM"]


def _op(F, name, *args, **kwargs):
    """Dispatch a privately-registered op (one without an ``nd``
    namespace entry) through the registry."""
    return _registry.invoke(_registry.get_op(name), args, kwargs)


class DecoderBlockLM(HybridBlock):
    """Pre-norm transformer decoder as an incremental decode step.

    Step contract::

        logits, (k'_0, v'_0, ..., k'_{L-1}, v'_{L-1}, pos+1) =
            forward(token, k_0, v_0, ..., k_{L-1}, v_{L-1}, pos)

    ``token``: (B, 1) int32 — one token id per live stream.
    ``k_l / v_l``: (B, max_len, embed_dim) fp32 KV caches.
    ``pos``: (B, 1) int32 — tokens already decoded (the step writes
    its K/V at index ``pos`` and returns ``pos + 1``).

    Unlike the JAX block, the step writes each new K/V row into the
    cache tensors it is given (``_cache_append`` works in place) and
    returns those same tensors; the serving session always hands it
    tensors it owns.

    ``impl`` selects the attention path: ``"cuda"`` (the K2 kernel) or
    ``"torch"`` (its plain version). The default, ``None``, picks
    ``"cuda"`` when the step's tensors are on a CUDA device and
    ``"torch"`` only when they are on the CPU.
    """

    def __init__(self, vocab_size, embed_dim=64, num_layers=2,
                 num_heads=4, ffn_dim=None, max_len=256, impl=None,
                 **kwargs):
        super().__init__(**kwargs)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must divide by "
                             f"num_heads {num_heads}")
        if impl not in (None, "cuda", "torch"):
            raise ValueError(f"impl must be None, 'cuda' or 'torch', got "
                             f"{impl!r}")
        ffn_dim = ffn_dim or 2 * embed_dim
        self._e = int(embed_dim)
        self._h = int(num_heads)
        self._l = int(num_layers)
        self._s = int(max_len)
        self._scale = math.sqrt(embed_dim)
        self._sm_scale = 1.0 / math.sqrt(embed_dim // num_heads)
        self._impl = impl
        self._layers = []
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, embed_dim)
            self.pos_embed = nn.Embedding(max_len, embed_dim)
            for i in range(num_layers):
                layer = {}
                for attr, blk in (
                        ("ln1", nn.LayerNorm()),
                        ("q_proj", nn.Dense(embed_dim, use_bias=False,
                                            flatten=False)),
                        ("k_proj", nn.Dense(embed_dim, use_bias=False,
                                            flatten=False)),
                        ("v_proj", nn.Dense(embed_dim, use_bias=False,
                                            flatten=False)),
                        ("o_proj", nn.Dense(embed_dim, use_bias=False,
                                            flatten=False)),
                        ("ln2", nn.LayerNorm()),
                        ("ffn1", nn.Dense(ffn_dim, flatten=False,
                                          activation="relu")),
                        ("ffn2", nn.Dense(embed_dim, flatten=False))):
                    # setattr registers the child; the list keeps
                    # per-layer access positional
                    setattr(self, f"{attr}_{i}", blk)
                    layer[attr] = blk
                self._layers.append(layer)
            self.ln_f = nn.LayerNorm()
            self.head = nn.Dense(vocab_size, use_bias=False,
                                 flatten=False)

    # -- the serving state protocol ------------------------------------

    def state_row_shapes(self):
        """Per-session state rows (no batch axis): K and V cache per
        layer, then the position counter."""
        rows = []
        for _ in range(self._l):
            rows.extend([(self._s, self._e), (self._s, self._e)])
        rows.append((1,))
        return rows

    def state_row_dtypes(self):
        return ["float32"] * (2 * self._l) + ["int32"]

    def state_row_pageable(self):
        """Which state rows grow along a token axis (axis 0) — the
        paged SessionStateStore of a later slice stores those as pages."""
        return [True] * (2 * self._l) + [False]

    # -- the decode step -----------------------------------------------

    def hybrid_forward(self, F, token, *states):
        caches, pos = states[:-1], states[-1]
        impl = self._impl or ("cuda" if token.data.is_cuda else "torch")
        # flatten to (B,) so (B,) and (B, 1) token layouts embed alike
        x = (self.embed(token.reshape((-1,))) * self._scale
             + self.pos_embed(pos.reshape((-1,))))  # (B, E)
        new_states = []
        for i, layer in enumerate(self._layers):
            h = layer["ln1"](x)
            q = layer["q_proj"](h)
            kc = _op(F, "_cache_append", caches[2 * i],
                     layer["k_proj"](h), pos)
            vc = _op(F, "_cache_append", caches[2 * i + 1],
                     layer["v_proj"](h), pos)
            attn = _op(F, "_attention_decode", q, kc, vc, pos,
                       num_heads=self._h, sm_scale=self._sm_scale,
                       impl=impl)
            x = x + layer["o_proj"](attn)
            x = x + layer["ffn2"](layer["ffn1"](layer["ln2"](x)))
            new_states.extend([kc, vc])
        logits = self.head(self.ln_f(x))  # (B, vocab)
        new_states.append(pos + 1)
        return (logits, *new_states)
