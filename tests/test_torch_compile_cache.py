"""The program cache and shape bucketing (``utils/compile_cache.py``,
``utils/lru.py``): the port against the JAX package.

The twins of ``tests/test_compile_cache.py`` wherever the behaviour
exists in the port: the cache directory stays inside the test's tmpdir,
a corrupt or version-drifted entry is a miss and is removed, the
``MXNET_COMPILE_CACHE=0`` knob, stable and unstable fingerprints,
function bodies salting them, the size cap's pruning (also against a
concurrent pruner), the fused step's plan persisted and reloaded
bitwise, shape bucketing (bitwise rows, the mult policy, vetoed
configs, recording), the profiler and runtime surfaces and the shared
``CountedLRUCache`` under threads. The JAX package's dispatch and
executor caches have no counterpart: the port dispatches eagerly.

Against the JAX package on the same inputs: ``bucket_size``,
``plan_bucketing``'s decision for every ``_BATCH_SAFE`` op, and
``pad_batch``/``slice_batch``. The port's own: a program survives the
JSON envelope bitwise, a serving session's programs and a calibrated
int8 graph load in a later session with no graph optimizer and no
calibration, and the kernel libraries are keyed through
``compile_cache.fingerprint``.
"""
import contextlib
import json
import os
import threading

import numpy as onp
import pytest

from mxnet_tpu.utils import compile_cache as jcc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, profiler, runtime, serving
from mxnet_tpu_torch.gluon import fused_step as fs
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.utils import compile_cache as cc
from mxnet_tpu_torch.utils.lru import CountedLRUCache

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """A cache dir of the test's own, zeroed counters, empty caches."""
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    monkeypatch.delenv("MXNET_SHAPE_BUCKETS", raising=False)
    monkeypatch.delenv("MXNET_COMPILE_CACHE", raising=False)
    fs.reset_fused_step_cache()
    cc.reset_compile_cache_counters()
    yield
    fs.reset_fused_step_cache()
    cc.reset_compile_cache_counters()


def _entries():
    d = cc.cache_dir()
    if not os.path.isdir(d):
        return []
    return [f for f in os.listdir(d) if f.endswith(cc.SUFFIX)]


def _arr(a):
    return nd.array(onp.asarray(a, "float32"), ctx=CPU)


# -- the disk tier ------------------------------------------------------------

def _make_net(seed=7):
    mx.random.seed(seed)
    net = nn.Sequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(ctx=CPU)
    with autograd.pause(train_mode=False):
        net(nd.zeros((8, 10), ctx=CPU))
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    return net, tr


def _train(net, tr, steps=3):
    for i in range(steps):
        x = _arr(onp.random.RandomState(i).rand(8, 10))
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(8)
    return [p.data().asnumpy()
            for _, p in sorted(net.collect_params().items())]


def test_tier1_cache_dir_is_hermetic():
    d = cc.cache_dir()
    home_cache = os.path.join(
        os.environ.get("MXNET_HOME",
                       os.path.join(os.path.expanduser("~"), ".mxnet")),
        "compile_cache")
    assert d != home_cache and not d.startswith(home_cache)
    before = set(os.listdir(home_cache)) if os.path.isdir(home_cache) \
        else set()
    _train(*_make_net(), steps=1)
    assert _entries(), "the fused step's plan was not persisted"
    after = set(os.listdir(home_cache)) if os.path.isdir(home_cache) \
        else set()
    assert after == before


def _stored(payload=None):
    fp = cc.fingerprint("test", ("entry", 1))
    assert cc.disk_store(fp, payload or {"a": (1, 2.5)}, meta={"n": 3})
    return fp, os.path.join(cc.cache_dir(), fp + cc.SUFFIX)


def test_corrupt_entry_is_a_miss_and_removed():
    fp, path = _stored()
    assert cc.disk_load(fp) == ({"a": (1, 2.5)}, {"n": 3})
    with open(path, "wb") as f:
        f.write(b"not json")
    cc.reset_compile_cache_counters()
    assert cc.disk_load(fp) is None
    s = cc.compile_cache_stats()
    assert s["disk_corrupt"] == 1 and s["disk_hits"] == 0, s
    assert not os.path.exists(path), "corrupt entry must be removed"


def test_version_mismatch_is_a_miss():
    fp, path = _stored()
    with open(path) as f:
        env = json.load(f)
    env["salt"] = cc.encode_value(("different",))  # torch/card drifted
    with open(path, "w") as f:
        json.dump(env, f)
    cc.reset_compile_cache_counters()
    assert cc.disk_load(fp) is None
    s = cc.compile_cache_stats()
    assert s["disk_corrupt"] == 1 and s["disk_hits"] == 0, s
    assert not os.path.exists(path)


def test_knob_disables_disk_tier(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_CACHE", "0")
    fp = cc.fingerprint("test", ("k",))
    assert not cc.disk_store(fp, {"x": 1})
    assert cc.disk_load(fp) is None
    _train(*_make_net(), steps=1)
    assert _entries() == []
    s = cc.compile_cache_stats()
    assert s["disk_writes"] == 0 and s["disk_misses"] == 0
    assert s["enabled"] is False
    assert not runtime.Features().is_enabled("COMPILE_CACHE")


def test_fingerprint_stability_and_unstable_keys():
    k = ("dot", (("a", 0),), (), (), (((4, 8), "float32", False),), 0)
    assert cc.fingerprint("dispatch", k) == cc.fingerprint("dispatch", k)
    assert cc.fingerprint("dispatch", k) != cc.fingerprint("fused", k)
    k2 = ("dot", (("a", 0),), (), (), (((4, 9), "float32", False),), 0)
    assert cc.fingerprint("dispatch", k) != cc.fingerprint("dispatch", k2)
    assert cc.fingerprint("dispatch", (lambda: 1,)) is None
    assert cc.fingerprint("d", (1,)) != cc.fingerprint("d", (1.0,))
    # the salt names torch, CUDA, the card and the port; never jax
    salt = repr(cc._salt())
    assert "torch" in salt and "jax" not in salt


def test_fingerprint_salts_function_bodies_and_files(tmp_path):
    def body_a(x):
        return x + 1

    def body_b(x):
        return x + 2

    def body_a2(x):
        return x + 1

    key = ("someop", (((4,), "float32", False),))
    fa = cc.fingerprint("dispatch", key, code_of=(body_a,))
    assert fa != cc.fingerprint("dispatch", key, code_of=(body_b,))
    assert fa == cc.fingerprint("dispatch", key, code_of=(body_a2,))
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    f1 = cc.fingerprint("kernel", key, code_of=(str(src),))
    src.write_text("__global__ void k() { }\n")
    assert f1 != cc.fingerprint("kernel", key, code_of=(str(src),))


def _fill(d, n, size):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        p = os.path.join(d, f"stale{i:02d}{cc.SUFFIX}")
        with open(p, "wb") as f:
            f.write(b"x" * size)
        os.utime(p, (1000 + i, 1000 + i))


def test_disk_cache_prunes_to_size_cap(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MAX_MB", "1")
    monkeypatch.setattr(cc, "_PRUNE_EVERY", 1)
    d = cc.cache_dir()
    _fill(d, 12, 128 * 1024)
    fp, path = _stored()
    files = _entries()
    total = sum(os.path.getsize(os.path.join(d, f)) for f in files)
    assert total <= 1024 * 1024, (total, files)
    assert not os.path.exists(os.path.join(d, f"stale00{cc.SUFFIX}"))
    assert os.path.exists(path)


def test_prune_survives_concurrent_pruner(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MAX_MB", "1")
    monkeypatch.setattr(cc, "_PRUNE_EVERY", 1)
    d = str(tmp_path / "shared")
    _fill(d, 12, 256 * 1024)
    real_scandir = os.scandir
    vanish = {f"stale00{cc.SUFFIX}": "pre-stat",
              f"stale01{cc.SUFFIX}": "pre-stat",
              f"stale02{cc.SUFFIX}": "pre-remove"}

    class _RacyEntry:
        def __init__(self, e, race):
            self._e, self._race = e, race
            self.name, self.path = e.name, e.path

        def stat(self):
            if self._race == "pre-stat":
                os.remove(self.path)
                raise FileNotFoundError(self.path)
            st = self._e.stat()
            if self._race == "pre-remove":
                os.remove(self.path)
            return st

    @contextlib.contextmanager
    def racy_scandir(path):
        with real_scandir(path) as it:
            yield (_RacyEntry(e, vanish.get(e.name)) for e in it)

    monkeypatch.setattr(cc.os, "scandir", racy_scandir)
    before = cc.compile_cache_stats()
    cc._maybe_prune(d)
    monkeypatch.setattr(cc.os, "scandir", real_scandir)
    stats = cc.compile_cache_stats()
    assert stats["prunes"] - before["prunes"] == 1
    assert stats["disk_evicted"] > before["disk_evicted"]
    left = [f for f in os.listdir(d) if f.endswith(cc.SUFFIX)]
    assert sum(os.path.getsize(os.path.join(d, f)) for f in left) \
        <= 1024 * 1024
    assert f"stale11{cc.SUFFIX}" in left


def test_transient_io_fault_is_a_miss_and_keeps_the_entry():
    from mxnet_tpu_torch.resilience import faults

    fp, path = _stored()
    with faults.inject("compile_cache_io", every=1):
        assert cc.disk_load(fp) is None
    assert os.path.exists(path)
    assert cc.disk_load(fp) is not None


def test_encoded_values_round_trip():
    v = {"f": 0.1, "t": (1, (2.5, None)), "l": [True, "s"],
         "a": onp.arange(6, dtype="int8").reshape(2, 3),
         "n": onp.float32(1.25), "nested": {"k": (onp.int64(3),)}}
    back = cc.decode_value(json.loads(json.dumps(cc.encode_value(v))))
    assert back["t"] == v["t"] and back["l"] == v["l"]
    assert back["f"] == 0.1 and isinstance(back["t"], tuple)
    assert onp.array_equal(back["a"], v["a"]) and back["a"].dtype == "int8"
    assert back["n"] == v["n"] and back["n"].dtype == onp.float32
    assert back["nested"]["k"] == (3,)
    with pytest.raises(cc._Unstable):
        cc.encode_value(object())


# -- the fused step's plan --------------------------------------------------------

def test_fused_step_warm_start_bitwise():
    net, tr = _make_net()
    p_cold = _train(net, tr)
    assert cc.compile_cache_stats()["disk_writes"] >= 1
    fs.reset_fused_step_cache()
    cc.reset_compile_cache_counters()
    net, tr = _make_net()
    p_warm = _train(net, tr)
    s = cc.compile_cache_stats()
    assert s["disk_hits"] >= 1 and s["disk_writes"] == 0, s
    for a, b in zip(p_cold, p_warm):
        assert onp.array_equal(a, b)


def test_knob_disables_fused_disk_layer(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_CACHE", "0")
    _train(*_make_net(), steps=1)
    assert fs.fused_step_stats()["size"] == 1
    assert _entries() == []
    assert cc.compile_cache_stats()["disk_misses"] == 0


# -- shape bucketing against the JAX package -----------------------------------

@pytest.mark.parametrize("spec,n", [
    (("pow2",), 1), (("pow2",), 2), (("pow2",), 5), (("pow2",), 9),
    (("pow2",), 64), (("mult", 4), 5), (("mult", 4), 8), (("mult", 3), 10)])
def test_bucket_size_equals_jax(spec, n):
    assert cc.bucket_size(n, spec) == jcc.bucket_size(n, spec)


def _plan_cases(op):
    """(datas, arg_template, kwargs) cases for one op of the table."""
    a53, a13 = onp.zeros((5, 3), "f"), onp.zeros((1, 3), "f")
    b53 = onp.zeros((5, 3), "f")
    v3, w = onp.zeros((3,), "f"), onp.zeros((3, 4), "f")
    rule = jcc._BATCH_SAFE[op]
    if rule == "ew":
        return [([a53, b53], [("arr", 0), ("arr", 1)], {}),
                ([a53, a13], [("arr", 0), ("arr", 1)], {}),
                ([a53, onp.zeros((4, 3), "f")],
                 [("arr", 0), ("arr", 1)], {}),
                ([a53, v3], [("arr", 0), ("arr", 1)], {}),
                ([v3], [("arr", 0)], {}),
                ([onp.zeros((1, 3), "f")], [("arr", 0)], {}),
                ([onp.zeros((8, 3), "f")], [("arr", 0)], {})]
    cases = [([a53], [("arr", 0)], {}), ([v3], [("arr", 0)], {}),
             ([onp.zeros((8, 3), "f")], [("arr", 0)], {})]
    if op == "dot":
        cases += [([a53, w], [("arr", 0), ("arr", 1)], {}),
                  ([a53, w], [("arr", 0), ("arr", 1)],
                   {"transpose_a": True}),
                  ([a53, w], [("arr", 0), ("arr", 1), ("lit", True)], {})]
    if op in ("softmax", "log_softmax"):
        cases += [([a53], [("arr", 0)], {"axis": 0}),
                  ([a53], [("arr", 0)], {"axis": -2}),
                  ([a53], [("arr", 0)], {"axis": 1}),
                  ([a53], [("arr", 0), ("lit", None), ("lit", 0)], {}),
                  ([a53], [("arr", 0)], {"use_length": True})]
    if op == "fully_connected":
        cases += [([a53, w.T, v3[:4] if False else onp.zeros((4,), "f")],
                   [("arr", 0), ("arr", 1), ("arr", 2)],
                   {"num_hidden": 4, "flatten": False}),
                  ([a53, w.T], [("arr", 0), ("arr", 1)],
                   {"num_hidden": 4, "no_bias": True})]
    return cases


@pytest.mark.parametrize("policy", ["pow2", "mult:4"])
@pytest.mark.parametrize("op", sorted(jcc._BATCH_SAFE))
def test_plan_bucketing_equals_jax_for_every_batch_safe_op(
        monkeypatch, op, policy):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", policy)
    assert sorted(cc._BATCH_SAFE) == sorted(jcc._BATCH_SAFE)
    for datas, template, kwargs in _plan_cases(op):
        got = cc.plan_bucketing(op, datas, template, kwargs)
        want = jcc.plan_bucketing(op, datas, template, kwargs)
        assert got == want, (op, [d.shape for d in datas], template,
                             kwargs)


def test_pad_and_slice_equal_jax():
    import jax.numpy as jnp
    import torch

    x = onp.arange(15, dtype="float32").reshape(5, 3)
    want = onp.asarray(jcc.pad_batch(jnp.asarray(x), 8))
    got = cc.pad_batch(torch.from_numpy(x), 8).numpy()
    assert onp.array_equal(got, want) and got.shape == (8, 3)
    assert onp.array_equal(cc.pad_batch(x, 8), want)
    assert cc.pad_batch(x, 5) is x
    assert onp.array_equal(
        cc.slice_batch(torch.from_numpy(want), 8, 5).numpy(),
        onp.asarray(jcc.slice_batch(jnp.asarray(want), 8, 5)))
    y = onp.zeros((4, 2), "f")  # axis 0 is not the padded batch: kept
    assert cc.slice_batch(y, 8, 5) is y


_STREAM = (5, 6, 7, 9, 11, 13, 15, 8)


def _stream_outputs():
    w = nd.ones((8, 8), ctx=CPU)
    outs = {}
    for b in _STREAM:
        x = _arr(onp.arange(b * 8, dtype="float32").reshape(b, 8) / 100.0)
        h = nd.FullyConnected(x, w, nd.ones((8,), ctx=CPU), num_hidden=8)
        outs[b] = nd.softmax(nd.tanh(nd.broadcast_add(
            nd.dot(h, w), nd.ones((8,), ctx=CPU))))
    return outs


def test_bucketing_rows_bitwise(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "pow2")
    bucketed = _stream_outputs()
    s = cc.compile_cache_stats()
    assert s["bucketed_calls"] > 0
    assert 0.0 < s["pad_ratio"] < 1.0
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "0")
    cc.reset_compile_cache_counters()
    plain = _stream_outputs()
    assert cc.compile_cache_stats()["bucketed_calls"] == 0
    for b in plain:
        assert bucketed[b].shape == plain[b].shape
        assert onp.array_equal(bucketed[b].asnumpy(), plain[b].asnumpy()), \
            f"batch {b} not bitwise identical under bucketing"


def test_bucketing_mult_policy(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "mult:4")
    assert cc.bucket_size(5, cc.bucket_spec()) == 8
    assert cc.bucket_size(9, cc.bucket_spec()) == 12
    x5 = _arr(onp.arange(5 * 4).reshape(5, 4) - 7)
    x7 = _arr(onp.arange(7 * 4).reshape(7, 4) - 7)
    r5, r7 = nd.relu(x5), nd.relu(x7)
    assert r5.shape == (5, 4) and r7.shape == (7, 4)
    assert cc.compile_cache_stats()["bucketed_calls"] == 2
    assert onp.array_equal(r5.asnumpy(), onp.maximum(x5.asnumpy(), 0))


def test_non_whitelisted_ops_never_bucketed(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "pow2")
    x = _arr(onp.arange(5 * 4).reshape(5, 4))
    s = nd.sum(x, axis=0)
    assert onp.array_equal(s.asnumpy(), x.asnumpy().sum(axis=0))
    sm = nd.softmax(x, axis=0)
    ref = onp.exp(x.asnumpy()) / onp.exp(x.asnumpy()).sum(0)
    assert onp.allclose(sm.asnumpy(), ref, atol=1e-6)
    assert cc.compile_cache_stats()["bucketed_calls"] == 0


def test_bucketing_resolves_negative_and_positional_axis(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "pow2")
    x = _arr(onp.arange(3 * 2).reshape(3, 2) / 10.0)
    ref = onp.exp(x.asnumpy()) / onp.exp(x.asnumpy()).sum(0)
    assert onp.allclose(nd.softmax(x, axis=-2).asnumpy(), ref, atol=1e-6)
    assert onp.allclose(nd.softmax(x, None, 0).asnumpy(), ref, atol=1e-6)
    a = _arr(onp.arange(3 * 2).reshape(3, 2))
    b = _arr(onp.arange(3 * 2).reshape(3, 2))
    got = nd.dot(a, b, True)
    assert onp.array_equal(got.asnumpy(), a.asnumpy().T @ b.asnumpy())
    assert cc.compile_cache_stats()["bucketed_calls"] == 0


def test_bucketing_skips_rank1_row_operands(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "pow2")
    v = _arr([0.0, 1.0, 2.0])
    m = nd.ones((3, 2), ctx=CPU)
    assert onp.array_equal(nd.dot(v, m).asnumpy(),
                           v.asnumpy() @ m.asnumpy())
    assert onp.allclose(nd.softmax(v).asnumpy(),
                        onp.exp(v.asnumpy()) / onp.exp(v.asnumpy()).sum(),
                        atol=1e-6)
    assert cc.compile_cache_stats()["bucketed_calls"] == 0


def test_bucketing_skips_recording(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "pow2")
    x = _arr(onp.ones((5, 4)))
    x.attach_grad()
    with autograd.record():
        y = nd.tanh(x)
    y.backward()
    assert cc.compile_cache_stats()["bucketed_calls"] == 0
    assert x.grad.shape == (5, 4)


# -- programs: serving buckets and the calibrated int8 graph -----------------------

SMALL_W2V = None


def _small_w2v(tmp_path):
    from mxnet_tpu_torch.tools.profile_predict import (
        WAV2VEC2_LARGE_LV60, export_wav2vec2)

    cfg = dict(WAV2VEC2_LARGE_LV60, conv_dim=(32,) * 3,
               conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4),
               hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=4)
    prefix = str(tmp_path / "w2v")
    export_wav2vec2(prefix, mx.sym, nd, cfg, 11)
    return prefix


def test_program_survives_the_envelope_bitwise(monkeypatch, tmp_path):
    from mxnet_tpu_torch.artifact.program import decode_symbol, encode_symbol

    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    sess = serving.InferenceSession.load(
        _small_w2v(tmp_path), input_shapes=[(1, 4000, 1)], buckets=[2],
        ctx=CPU)
    x = nd.array(onp.random.RandomState(2).randn(2, 4000, 1)
                 .astype("float32"), ctx=CPU)
    opt = sess._block.optimized_program(x)
    fused = sorted(s._op for s in opt._walk()
                   if s._op and s._op.startswith("_fused"))
    assert fused.count("_fused_attention") == 2
    text = json.dumps(encode_symbol(opt))
    back = decode_symbol(json.loads(text))
    feed = sess._block._feed([x])
    assert onp.array_equal(back.eval_with(feed).asnumpy(),
                           opt.eval_with(feed).asnumpy())
    assert [s._op for s in back._walk()] == [s._op for s in opt._walk()]


def test_session_programs_load_with_no_graph_optimizer(monkeypatch,
                                                        tmp_path):
    from mxnet_tpu_torch.analysis import graph_opt

    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    prefix = _small_w2v(tmp_path)
    x = onp.random.RandomState(4).randn(3, 4000, 1).astype("float32")
    cold = serving.InferenceSession.load(
        prefix, input_shapes=[(1, 4000, 1)], buckets=[1, 4], ctx=CPU)
    assert cc.compile_cache_stats()["disk_writes"] == 2
    assert len(cold.artifact_fingerprints()) == 2
    want = cold.predict(x).asnumpy()
    cc.reset_compile_cache_counters()
    runs = graph_opt.counters()["graphs_seen"]
    warm = serving.InferenceSession.load(
        prefix, input_shapes=[(1, 4000, 1)], buckets=[1, 4], ctx=CPU)
    s = cc.compile_cache_stats()
    assert s["disk_hits"] == 2 and s["retraces"] == 0, s
    assert s["captures"] == 0  # eager on the CPU
    assert graph_opt.counters()["graphs_seen"] == runs
    assert onp.array_equal(warm.predict(x).asnumpy(), want)
    assert warm.artifact_fingerprints() == cold.artifact_fingerprints()
    assert warm.kernel_libraries() == []  # nothing loaded on the CPU
    assert warm.warmup()["disk_hits"] == 0  # resolved: nothing reloads


def test_gluon_block_session_is_memory_only():
    net = nn.Dense(3)
    net.initialize(ctx=CPU)
    sess = serving.InferenceSession(net, input_shapes=[(1, 4)], buckets=[2],
                                    ctx=CPU)
    assert sess.artifact_fingerprints() == []
    assert _entries() == []


def test_calibrated_int8_graph_loads_with_no_calibration():
    from mxnet_tpu_torch.contrib.quantization import quantize_net_graph
    from mxnet_tpu_torch.gluon.model_zoo import vision

    def build():
        mx.random.seed(3)
        # a fixed prefix: the traced graph and the weights' names key the
        # program, as they do across processes
        net = vision.resnet18_v1(thumbnail=True, classes=10,
                                 prefix="r18_")
        net.initialize(mx.init.Xavier(), ctx=CPU)
        x = _arr(onp.random.RandomState(0).randn(2, 3, 32, 32))
        net(x)
        return quantize_net_graph(net, calib_data=[x], calib_mode="naive"), x

    qb, x = build()
    s = cc.compile_cache_stats()
    assert s["calibrations"] == 1 and s["disk_writes"] == 1
    want = qb(x).asnumpy()
    cc.reset_compile_cache_counters()
    qb2, _ = build()
    s = cc.compile_cache_stats()
    assert s["calibrations"] == 0 and s["retraces"] == 0, s
    assert s["disk_hits"] == 1
    assert qb2._program_fps == qb._program_fps
    assert onp.array_equal(qb2(x).asnumpy(), want)


# -- kernel libraries ---------------------------------------------------------------

def test_kernel_libraries_are_keyed_through_fingerprint(monkeypatch,
                                                         tmp_path):
    libdir = tmp_path / "libs"
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(libdir))
    assert _build.library_dir() == str(libdir)
    fp = _build.library_fingerprint("decode_attention", "nvcc 12.9")
    assert fp == cc.fingerprint(
        "kernel_library", ("decode_attention", _build.NVCC_FLAGS,
                           "nvcc 12.9", cc._capability()),
        code_of=_build._code_of("decode_attention"))
    assert fp != _build.library_fingerprint("decode_attention", "nvcc 13")
    # a host without nvcc loads a library built elsewhere through its
    # sidecar, and raises without one
    monkeypatch.setenv("PATH", str(tmp_path / "nobin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(mx.MXNetError, match="nvcc"):
        _build._library_path("decode_attention")
    os.makedirs(libdir)
    so, side = _build._paths("decode_attention", fp)
    open(so, "wb").close()
    with open(side, "w") as f:
        json.dump({"name": "decode_attention", "fingerprint": fp,
                   "nvcc": "nvcc 12.9"}, f)
    assert _build._library_path("decode_attention") == so
    with open(side, "w") as f:  # a sidecar of another source: refused
        json.dump({"name": "decode_attention", "fingerprint": fp,
                   "nvcc": "nvcc 13"}, f)
    with pytest.raises(mx.MXNetError, match="nvcc"):
        _build._library_path("decode_attention")


# -- surfaces --------------------------------------------------------------------

def test_profiler_and_runtime_surfaces():
    _stored()
    counters = profiler.compile_cache_counters()
    jkeys = set(jcc.compile_cache_stats())
    assert jkeys <= set(counters)
    for k in ("captures", "kernel_builds", "calibrations"):
        assert k in counters
    assert counters["disk_writes"] == 1
    assert runtime.Features().is_enabled("COMPILE_CACHE")


def test_lru_cache_thread_safety():
    cache = CountedLRUCache(maxsize=32)
    errors = []
    barrier = threading.Barrier(8)
    N = 400

    def worker(tid):
        try:
            barrier.wait()
            for i in range(N):
                k = (tid * 7 + i) % 48
                if cache.lookup(k) is None:
                    cache.insert(k, ("v", tid, i))
                if i % 97 == 0:
                    cache.remove((tid + i) % 48)
                if i % 131 == 0:
                    cache.stats()
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    s = cache.stats()
    assert s["size"] <= 32
    assert s["hits"] + s["misses"] == 8 * N
    cache.insert("probe", 1)
    assert cache.lookup("probe") == 1


def test_fused_step_cache_sits_on_the_counted_lru():
    assert isinstance(fs._CACHE, CountedLRUCache)
    _train(*_make_net(), steps=2)
    st = fs.fused_step_stats()
    assert st["misses"] == 1 and st["hits"] >= 1 and st["fallbacks"] == 0
