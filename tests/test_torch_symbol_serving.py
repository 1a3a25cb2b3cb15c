"""Serving an exported symbol graph: the port against the JAX package.

A small wav2vec2 CTC (3 conv layers of width 32, hidden 64, 2 layers, 4
heads; ``mxnet_tpu_torch/tools/profile_predict.py``) is exported by the
JAX package (``sym.save`` and ``nd.save``, weights drawn with numpy from
a seed) and served by both packages through ``InferenceSession.load``
under ``MXNET_GRAPH_OPT=1``, on the CPU, with buckets 1 and 4. Requests
of 1 and 3 clips of 0.25 s (the second padded to bucket 4 and sliced
back) must agree within 1e-4 (float32: XLA and torch sum the
convolutions and matmuls in different orders, through the whole
network). The port's optimized graph must hold the fused ops the JAX
package's holds: 3 ``_fused_norm_act`` (one per feature-encoder layer)
and 2 ``_fused_attention`` (one per encoder layer), here as torch
replays. The strides keep the encoder's sequence at 50 frames, below the
64 at which both cost models keep a replayed attention unfused.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, serving
from mxnet_tpu_torch.tools.profile_predict import (
    WAV2VEC2_LARGE_LV60, export_wav2vec2, frames)

SMALL = dict(WAV2VEC2_LARGE_LV60, conv_dim=(32,) * 3, conv_kernel=(10, 3, 3),
             conv_stride=(5, 4, 4), hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
SAMPLES = 4000  # 0.25 s at 16 kHz
TOL = 1e-4


@pytest.fixture
def export(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    # the JAX session compiles in memory only: its disk tier would record
    # the fused bucket slice's fingerprint process-wide, and a later
    # bundle export in the same process would then look for it
    monkeypatch.setenv("MXNET_COMPILE_CACHE", "0")
    for knob in ("MXNET_FUSION", "MXNET_FUSION_PATTERNS",
                 "MXNET_FUSION_COST_MODEL"):
        monkeypatch.delenv(knob, raising=False)
    prefix = str(tmp_path / "wav2vec2-small")
    export_wav2vec2(prefix, jmx.sym, jmx.nd, SMALL, 11)
    return prefix


def _fused(graph):
    return sorted(s._op for s in graph._walk()
                  if s._op and s._op.startswith("_fused"))


def test_served_logits_match_jax(export):
    clips = onp.random.RandomState(4).randn(4, SAMPLES, 1).astype("float32")
    jsess = jserving.InferenceSession.load(
        export, input_shapes=[(1, SAMPLES, 1)], buckets=[1, 4], warm=False)
    sess = serving.InferenceSession.load(
        export, input_shapes=[(1, SAMPLES, 1)], buckets=[1, 4], ctx=mx.cpu())
    serving.METRICS.reset()
    T = frames(SMALL, SAMPLES)[-1]
    for rows in (clips[:1], clips[1:4]):
        want = jsess.predict(rows).asnumpy()
        got = sess.predict(rows).asnumpy()
        assert got.shape == want.shape == (len(rows), T, 32)
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    snap = serving.METRICS.snapshot()
    assert (snap["bucket_execs"], snap["padded_rows"],
            snap["true_rows"]) == (2, 1, 4)
    graph = sess._block._optimized_outputs(
        nd.zeros((4, SAMPLES, 1), ctx=mx.cpu()))
    fused = _fused(graph)
    assert fused.count("_fused_norm_act") == 3
    assert fused.count("_fused_attention") == 2
    assert {s._kwargs["impl"] for s in graph._walk()
            if s._op in ("_fused_norm_act", "_fused_attention")} == {"torch"}
    assert fused == _fused(jsess._block._optimized_outputs())


def test_device_inputs_pad_on_device_and_fusion_off_is_bitwise(export,
                                                               monkeypatch):
    """NDArray inputs pad through ``pad_all`` and slice back; the fused
    graph's replays equal the unfused graph bit for bit."""
    from mxnet_tpu_torch import kernels

    sess = serving.InferenceSession.load(
        export, input_shapes=[(1, SAMPLES, 1)], buckets=[1, 4], ctx=mx.cpu())
    x = onp.random.RandomState(5).randn(3, SAMPLES, 1).astype("float32")
    kernels.reset_counters()
    fused = sess.predict(nd.array(x, ctx=mx.cpu())).asnumpy()
    c = kernels.counters()
    assert c["serving_pad_fused"] == 1 and c["serving_slice_fused"] == 1
    monkeypatch.setenv("MXNET_FUSION", "0")
    plain = sess.predict(x).asnumpy()
    assert (fused == plain).all()
    graph = sess._block._optimized_outputs(nd.zeros((4, SAMPLES, 1),
                                                    ctx=mx.cpu()))
    assert _fused(graph) == []


def test_optimized_graph_keyed_by_device_and_shape(export, monkeypatch):
    """The graph optimized for the CPU (replays) is never the one built
    for the card, and each bucket's shapes get their own."""
    from mxnet_tpu_torch.gluon import SymbolBlock

    blk = SymbolBlock.imports(f"{export}-symbol.json", None,
                              f"{export}-0000.params", ctx=mx.cpu())
    one = blk._optimized_outputs(nd.zeros((1, SAMPLES, 1), ctx=mx.cpu()))
    assert blk._optimized_outputs(nd.zeros((1, SAMPLES, 1),
                                           ctx=mx.cpu())) is one
    assert blk._optimized_outputs(nd.zeros((4, SAMPLES, 1),
                                           ctx=mx.cpu())) is not one
    tags = {tag[1] for tag in blk._graph_opt_cache}
    assert tags == {"cpu"}
    monkeypatch.setenv("MXNET_GRAPH_OPT", "0")
    assert blk._optimized_outputs() is blk._outputs


def test_load_errors_name_the_mistake(export, tmp_path):
    with pytest.raises(mx.MXNetError, match="not found"):
        serving.InferenceSession.load(str(tmp_path / "nope"),
                                      input_shapes=[(1, SAMPLES, 1)],
                                      ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="CUDA"):
        serving.InferenceSession.load(export, input_shapes=[(1, SAMPLES, 1)])
    sess = serving.InferenceSession.load(
        export, input_shapes=[(1, SAMPLES, 1)], buckets=[1], ctx=mx.cpu(),
        warm=False)
    assert not sess.stateful and sess.input_specs[0].name == "data"
    with pytest.raises(mx.MXNetError, match="stateless"):
        sess.step(onp.zeros((1, SAMPLES, 1), "float32"), states=[])
    with pytest.raises(ValueError, match="row shape"):
        sess.predict(onp.zeros((1, 10, 1), "float32"))
    # a batch above the largest bucket is chunked
    x = onp.random.RandomState(6).randn(3, SAMPLES, 1).astype("float32")
    out = sess.predict(x).asnumpy()
    assert out.shape[0] == 3 and onp.isfinite(out).all()
