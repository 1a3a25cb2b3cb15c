"""Transformer language model, for training.

The PyTorch counterpart of ``mxnet_tpu/models/transformer.py:20-131``,
with the same constructors and structural parameter names (so
``convert.params_from_numpy`` carries JAX weights across unchanged): a
decoder-only pre-norm transformer whose attention is
``nd.flash_attention`` — on the card, the hand-written kernel K1
forward and the q-chunk recompute backward.

The sequence-parallel variants (``ring_axis``, ``sp_mode``) belong to
the multi-device slice's second half (9b, the mesh) and raise
:class:`MXNetError` here.
"""
from __future__ import annotations

import math

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["TransformerLM", "TransformerBlock", "MultiHeadSelfAttention"]


def _no_sequence_parallel(ring_axis, ring_batch_axis):
    if ring_axis is not None or ring_batch_axis is not None:
        raise MXNetError("ring/Ulysses sequence-parallel attention belongs "
                         "to the multi-device slice's mesh (slice 9b) and is "
                         "not ported yet")


class MultiHeadSelfAttention(HybridBlock):
    """Causal self-attention over (B, S, E) via flash attention."""

    def __init__(self, embed_dim, num_heads, ring_axis=None,
                 ring_batch_axis=None, sp_mode="ring", **kwargs):
        super().__init__(**kwargs)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must divide by "
                             f"num_heads {num_heads}")
        _no_sequence_parallel(ring_axis, ring_batch_axis)
        self._e = embed_dim
        self._h = num_heads
        with self.name_scope():
            self.qkv = nn.Dense(3 * embed_dim, use_bias=False,
                                flatten=False)
            self.out = nn.Dense(embed_dim, use_bias=False, flatten=False)

    def hybrid_forward(self, F, x):
        B, S, E = x.shape
        h, d = self._h, self._e // self._h
        qkv = self.qkv(x).reshape(B, S, 3, h, d)
        # (3, B, h, S, d): q, k and v are strided views of one projection,
        # which K1 reads in place
        qkv = qkv.transpose((2, 0, 3, 1, 4))
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = F.flash_attention(q, k, v, causal=True)
        attn = attn.transpose((0, 2, 1, 3)).reshape(B, S, E)
        return self.out(attn)


class TransformerBlock(HybridBlock):
    """Pre-norm block: x + attn(ln1(x)), then x + ffn(ln2(x))."""

    def __init__(self, embed_dim, num_heads, ffn_dim, dropout=0.0,
                 ring_axis=None, ring_batch_axis=None, sp_mode="ring",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = nn.LayerNorm()
            self.attn = MultiHeadSelfAttention(
                embed_dim, num_heads, ring_axis=ring_axis,
                ring_batch_axis=ring_batch_axis, sp_mode=sp_mode)
            self.ln2 = nn.LayerNorm()
            self.ffn1 = nn.Dense(ffn_dim, flatten=False, activation="relu")
            self.ffn2 = nn.Dense(embed_dim, flatten=False)
            self.drop = nn.Dropout(dropout)

    def hybrid_forward(self, F, x):
        x = x + self.drop(self.attn(self.ln1(x)))
        return x + self.drop(self.ffn2(self.ffn1(self.ln2(x))))


class TransformerLM(HybridBlock):
    """Decoder-only LM: embed -> N blocks -> LayerNorm -> head.

    With ``tie_weights`` the head is the embedding matrix itself (the
    reference word LM ties them, example/rnn/word_lm/model.py:41-50),
    so its gradient is the sum of the lookup's and the head's.
    """

    def __init__(self, vocab_size, embed_dim=256, num_layers=2, num_heads=4,
                 ffn_dim=None, max_len=1024, dropout=0.0, tie_weights=False,
                 ring_axis=None, ring_batch_axis=None, sp_mode="ring",
                 **kwargs):
        super().__init__(**kwargs)
        _no_sequence_parallel(ring_axis, ring_batch_axis)
        ffn_dim = ffn_dim or 4 * embed_dim
        self._scale = math.sqrt(embed_dim)
        self._max_len = max_len
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, embed_dim)
            self.pos_embed = nn.Embedding(max_len, embed_dim)
            self.blocks = nn.HybridSequential(prefix="blocks_")
            for _ in range(num_layers):
                self.blocks.add(TransformerBlock(
                    embed_dim, num_heads, ffn_dim, dropout))
            self.ln_f = nn.LayerNorm()
            self._tie = tie_weights
            if not tie_weights:
                self.head = nn.Dense(vocab_size, flatten=False,
                                     use_bias=False)

    def hybrid_forward(self, F, tokens):
        B, S = tokens.shape
        if S > self._max_len:
            raise ValueError(f"sequence length {S} exceeds max_len "
                             f"{self._max_len} (positional table size)")
        pos = F.arange(S, ctx=tokens.context).reshape(1, S)
        x = self.embed(tokens) * self._scale + self.pos_embed(pos)
        x = self.blocks(x)
        x = self.ln_f(x)
        if self._tie:
            w = self.embed.weight.data()
            E = w.shape[1]
            return F.dot(x.reshape(-1, E), w,
                         transpose_b=True).reshape(B, S, -1)
        return self.head(x)  # (B, S, vocab)
