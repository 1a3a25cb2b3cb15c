"""The artifact layer (``artifact/``): the port against the JAX package.

The twins of ``tests/test_artifact.py``: salt providers (registration,
declared order, unknown names, the built-ins), ``CompiledArtifact``
fingerprints (salt-free kinds equal the raw compile cache's, a ``None``
key is memory-only, declared salts fold in) and the tiered resolve
(build, then disk, then remote), the remote tier over ``file://`` and
the reference HTTP server (publish knob, GC by size and by age with
bundle protection, a concurrent pruner, a flaky host's retries, the
breaker), bundles (export and import, a stale salt skipping every
entry, non-bundles refused, the repository's export) and the
``artifact`` family on ``/metrics``. The port's payload is a program
(JSON), not an XLA executable, so the resolve tests build a payload.

The slice as a whole: the small wav2vec2 symbol graph of
``tests/test_torch_symbol_serving.py``, exported by the JAX package and
served by a repository under ``MXNET_GRAPH_OPT=1``, is held against the
JAX package's session; its bundle holds the bucket's optimized graph; a
child process on the CPU imports it and serves from it with zero
graph-optimizer runs, bitwise equal to the exporting session.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import artifact as jartifact
from mxnet_tpu import serving as jserving
from mxnet_tpu.artifact import salts as jsalts

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import artifact, nd, serving
from mxnet_tpu_torch.artifact import remote as art_remote
from mxnet_tpu_torch.artifact import salts as art_salts
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import compile_cache as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _fresh_artifact_state(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cc0"))
    for knob in ("MXNET_ARTIFACT_REMOTE", "MXNET_ARTIFACT_GC_PROTECT",
                 "MXNET_ARTIFACT_GC_MAX_AGE_S",
                 "MXNET_ARTIFACT_REMOTE_MAX_MB"):
        monkeypatch.delenv(knob, raising=False)
    artifact.reset_artifact_counters()
    artifact.reset_remote_state()
    artifact.reset_protected_fingerprints()
    cc.reset_compile_cache_counters()
    yield
    artifact.reset_artifact_counters()
    artifact.reset_remote_state()
    artifact.reset_protected_fingerprints()


# ---------------------------------------------------------------------------
# salt providers

def test_register_salt_provider_rejects_duplicates_and_noncallables():
    name = "unit_test_salt_a"
    art_salts.register_salt_provider(name, lambda ctx: ("a", 1))
    assert name in artifact.salt_providers()
    with pytest.raises(MXNetError, match="already registered"):
        art_salts.register_salt_provider(name, lambda ctx: ("b",))
    art_salts.register_salt_provider(name, lambda ctx: ("b", 2),
                                     replace=True)
    assert art_salts.resolve_salts((name,)) == (("b", 2),)
    with pytest.raises(MXNetError, match="not callable"):
        art_salts.register_salt_provider("unit_test_salt_bad", 7)


def test_resolve_salts_order_and_context_equal_jax():
    for mod in (art_salts, jsalts):
        mod.register_salt_provider(
            "unit_test_salt_x", lambda ctx: ("x", ctx.get("n", 0)),
            replace=True)
        mod.register_salt_provider(
            "unit_test_salt_y", lambda ctx: (), replace=True)
    names = ("unit_test_salt_y", "unit_test_salt_x")
    got = art_salts.resolve_salts(names, {"n": 9})
    assert got == ((), ("x", 9)) == jsalts.resolve_salts(names, {"n": 9})
    assert art_salts.resolve_salts(names[::-1], {"n": 9}) == \
        (("x", 9), ())


def test_unknown_salt_provider_raises():
    with pytest.raises(MXNetError, match="unknown salt provider"):
        art_salts.resolve_salts(("no_such_provider",))


def test_builtin_providers_resolve():
    ctx = {"optimizable": False, "shard": None, "graph_signature": None}
    got = art_salts.resolve_salts(("graph_opt", "sharding", "quantize",
                                   "paged_state", "autotune"), ctx)
    # graph_opt and quantize as the JAX package's; sharding contributes
    # nothing until the port shards (slice 9b)
    want = jsalts.resolve_salts(("graph_opt", "quantize"), ctx)
    assert (got[0], got[2]) == want
    assert got[1] == () and got[3] == () and got[4] == ()
    q = art_salts.resolve_salts(("quantize",), {
        "graph_signature": '{"op": "_contrib_quantized_conv"}',
        "device": "cpu"})
    assert q == (("quantize", "dequant"),)
    assert art_salts.resolve_salts(("graph_opt",), {
        "optimizable": True, "opt_level": 1})[0][:2] == ("graph_opt", 1)


# ---------------------------------------------------------------------------
# CompiledArtifact

def test_salt_free_fingerprint_matches_raw_compile_cache():
    key = ("unit", 1, (2, 3))
    art = artifact.CompiledArtifact("dispatch_compat", key)
    assert art.fingerprint == cc.fingerprint("dispatch_compat", key)


def test_none_key_is_memory_only():
    art = artifact.CompiledArtifact("serving", None)
    assert art.fingerprint is None
    assert art.load() is None
    payload, _, source = art.resolve(lambda: {"p": 1})
    assert source == "build" and payload == {"p": 1}
    assert cc.compile_cache_stats()["disk_writes"] == 0


def test_declared_salts_fold_into_fingerprint():
    art_salts.register_salt_provider(
        "unit_test_salt_lvl", lambda ctx: ("lvl", ctx["lvl"]),
        replace=True)

    def fp(lvl):
        return artifact.CompiledArtifact(
            "unit_salted", ("k",), salts=("unit_test_salt_lvl",),
            salt_ctx={"lvl": lvl}).fingerprint

    assert fp(0) == fp(0)
    assert fp(0) != fp(1)
    assert fp(0) != artifact.CompiledArtifact(
        "unit_salted", ("k",)).fingerprint


def _f(x):
    return x * 2.0 + 1.0


def test_artifact_resolve_build_then_disk(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    built = []

    def build():
        built.append(1)
        return {"program": (1.5, "x"), "w": onp.arange(3, dtype="f")}

    art = artifact.CompiledArtifact("unit_resolve", ("k1",),
                                    code_of=(_f,))
    payload, meta, source = art.resolve(build, meta={"n": 7})
    assert source == "build" and built == [1]
    art2 = artifact.CompiledArtifact("unit_resolve", ("k1",),
                                     code_of=(_f,))
    payload2, meta2, source2 = art2.resolve(build)
    assert source2 == "disk" and built == [1]
    assert meta2 == {"n": 7}
    assert payload2["program"] == payload["program"]
    assert onp.array_equal(payload2["w"], payload["w"])


def test_remote_file_tier_fleet_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "l1"))
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE",
                       "file://" + str(tmp_path / "shared"))

    def make():
        return artifact.CompiledArtifact("unit_remote", ("k",),
                                         code_of=(_f,))

    _, _, source = make().resolve(lambda: {"v": 1})
    assert source == "build"
    assert artifact.artifact_stats()["remote_publishes"] == 1
    # a fresh replica: empty local cache, the same shared remote
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "l2"))
    payload, _, source2 = make().resolve(lambda: {"v": 2})
    assert source2 == "remote" and payload == {"v": 1}
    st = artifact.artifact_stats()
    assert st["remote_hits"] == 1 and st["fetch_bytes"] > 0
    _, _, source3 = make().resolve(lambda: {"v": 3})
    assert source3 == "disk"


def test_stale_remote_entry_is_a_counted_miss(monkeypatch, tmp_path):
    shared = tmp_path / "shared"
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", "file://" + str(shared))
    art = artifact.CompiledArtifact("unit_stale", ("k",))
    os.makedirs(shared)
    (shared / (art.fingerprint + cc.SUFFIX)).write_bytes(
        json.dumps({"format": 1, "salt": "another stack",
                    "payload": 1}).encode())
    assert art.load() is None
    assert artifact.artifact_stats()["remote_corrupt"] == 1
    assert not os.path.exists(cc._entry_path(art.fingerprint))


def test_remote_publish_disabled_by_knob(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE",
                       "file://" + str(tmp_path / "shared"))
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE_PUBLISH", "0")
    assert not art_remote.publish("aa", b"blob")
    assert artifact.artifact_stats()["remote_publishes"] == 0
    assert not os.path.exists(str(tmp_path / "shared" / ("aa" + cc.SUFFIX)))


def test_remote_file_gc_prunes_oldest(monkeypatch, tmp_path):
    """A size-bounded file:// store sheds oldest-used entries down to
    80% of MXNET_ARTIFACT_REMOTE_MAX_MB on publish — same contract as
    the local tier's _maybe_prune; the fresh publish survives."""
    shared = str(tmp_path / "shared")
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", "file://" + shared)
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE_MAX_MB", "1")
    monkeypatch.setattr(art_remote, "_GC_EVERY", 1)
    os.makedirs(shared)
    # an overgrown fleet store: ~1.5 MB of stale artifacts, distinct
    # mtimes so eviction order is deterministic
    for i in range(12):
        p = os.path.join(shared, f"stale{i:02d}{cc.SUFFIX}")
        with open(p, "wb") as f:
            f.write(b"x" * (128 * 1024))
        os.utime(p, (1000 + i, 1000 + i))
    assert art_remote.publish("freshfp", b"y" * 1024)
    files = [f for f in os.listdir(shared) if f.endswith(cc.SUFFIX)]
    total = sum(os.path.getsize(os.path.join(shared, f)) for f in files)
    assert total <= 0.8 * 1024 * 1024, (total, files)
    assert "freshfp" + cc.SUFFIX in files          # never the entry just pushed
    assert "stale00" + cc.SUFFIX not in files      # oldest went first
    assert "stale11" + cc.SUFFIX in files          # newest stale survived
    st = artifact.artifact_stats()
    assert st["gc_runs"] == 1 and st["gc_evicted"] >= 6
    assert st["gc_bytes"] >= 6 * 128 * 1024


def test_remote_file_gc_survives_concurrent_pruner(monkeypatch,
                                                   tmp_path):
    """Two replicas publishing into one shared dir GC concurrently —
    entries the other pruner already removed vanish between
    scandir/stat and stat/remove. The sweep tolerates every per-entry
    race and still bounds what remains."""
    import contextlib

    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE_MAX_MB", "1")
    monkeypatch.setattr(art_remote, "_GC_EVERY", 1)
    d = str(tmp_path)
    for i in range(12):
        p = os.path.join(d, f"stale{i:02d}{cc.SUFFIX}")
        with open(p, "wb") as f:
            f.write(b"x" * (256 * 1024))
        os.utime(p, (1000 + i, 1000 + i))

    real_scandir = os.scandir
    vanish = {"stale00" + cc.SUFFIX: "pre-stat", "stale01" + cc.SUFFIX: "pre-stat",
              "stale02" + cc.SUFFIX: "pre-remove"}

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

    monkeypatch.setattr(art_remote.os, "scandir", racy_scandir)
    art_remote._maybe_gc_file(d)  # must not raise
    monkeypatch.setattr(art_remote.os, "scandir", real_scandir)
    st = artifact.artifact_stats()
    assert st["gc_runs"] == 1 and st["gc_evicted"] > 0
    left = [f for f in os.listdir(d) if f.endswith(cc.SUFFIX)]
    total = sum(os.path.getsize(os.path.join(d, f)) for f in left)
    assert total <= 1024 * 1024, (total, left)


def test_remote_file_gc_age_bound_and_bundle_protection(monkeypatch,
                                                        tmp_path):
    """Entries older than MXNET_ARTIFACT_GC_MAX_AGE_S are
    reclaimed even while the store is under its byte cap — only age
    can collect a dead fingerprint nobody re-publishes — and
    fingerprints named by a live bundle manifest (here via the
    MXNET_ARTIFACT_GC_PROTECT knob) survive the sweep."""
    import pickle
    import time

    shared = str(tmp_path / "shared")
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", "file://" + shared)
    monkeypatch.setenv("MXNET_ARTIFACT_GC_MAX_AGE_S", "3600")
    monkeypatch.setattr(art_remote, "_GC_EVERY", 1)
    os.makedirs(shared)
    now = time.time()
    for name, age in (("old0", 7200.0), ("old1", 7200.0),
                      ("fresh0", 10.0)):
        p = os.path.join(shared, name + cc.SUFFIX)
        with open(p, "wb") as f:
            f.write(b"x" * 64)
        os.utime(p, (now - age, now - age))
    # a live bundle manifest pins old1 (the knob path is deliberately
    # salt-agnostic: a shared mount serves replicas of every salt)
    bp = str(tmp_path / "pin.bundle")
    with open(bp, "wb") as f:
        pickle.dump({"format": artifact.BUNDLE_FORMAT, "salt": "any",
                     "manifest": {}, "entries": {"old1": b""}}, f)
    monkeypatch.setenv("MXNET_ARTIFACT_GC_PROTECT", bp)
    assert art_remote.publish("freshfp", b"z" * 16)
    left = {f[:-len(cc.SUFFIX)] for f in os.listdir(shared)
            if f.endswith(cc.SUFFIX)}
    assert left == {"old1", "fresh0", "freshfp"}
    st = artifact.artifact_stats()
    assert st["gc_runs"] == 1
    assert st["gc_evicted"] == 1 and st["gc_age_evicted"] == 1
    assert st["gc_protected"] == 1


def test_remote_http_fetch_publish_and_miss(monkeypatch):
    with artifact.ArtifactCacheServer() as srv:
        monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", srv.url)
        assert art_remote.fetch("deadbeef") is None  # 404: clean miss
        assert artifact.artifact_stats()["remote_misses"] == 1
        assert art_remote.publish("deadbeef", b"envelope-bytes")
        assert srv.store["deadbeef"] == b"envelope-bytes"
        assert art_remote.fetch("deadbeef") == b"envelope-bytes"
        st = artifact.artifact_stats()
        assert st["remote_hits"] == 1
        assert st["publish_bytes"] == len(b"envelope-bytes")


def test_artifact_server_evicts_least_recently_fetched(monkeypatch):
    """The reference server is byte-bounded: a PUT over the cap evicts
    the least-recently-ACCESSED blob (a GET refreshes recency), never
    the blob just written; an evicted fingerprint is a clean 404."""
    with artifact.ArtifactCacheServer(max_bytes=300) as srv:
        monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", srv.url)
        assert art_remote.publish("aa", b"a" * 100)
        assert art_remote.publish("bb", b"b" * 100)
        assert art_remote.fetch("aa") == b"a" * 100   # aa is now warm
        assert art_remote.publish("cc", b"c" * 100)   # exactly at cap
        assert srv.gc_evicted == 0
        assert art_remote.publish("dd", b"d" * 100)   # over: bb coldest
        assert set(srv.store) == {"aa", "cc", "dd"}
        assert srv.gc_evicted == 1 and srv.store_bytes == 300
        st = artifact.artifact_stats()
        assert st["gc_runs"] == 1 and st["gc_evicted"] == 1
        assert st["gc_bytes"] == 100
        assert art_remote.fetch("bb") is None  # evicted = clean miss


def test_artifact_server_age_eviction_skips_live_bundle(monkeypatch,
                                                        tmp_path):
    """The reference server mirrors the file:// pruner's rules: a PUT drops entries untouched for max_age_s whatever the
    byte total, but a fingerprint a live (imported) bundle references
    is pinned."""
    import pickle

    # importing a salt-matching bundle registers its fingerprints as
    # protected in-process
    bp = str(tmp_path / "pin.bundle")
    with open(bp, "wb") as f:
        pickle.dump({"format": artifact.BUNDLE_FORMAT,
                     "salt": cc._salt(), "manifest": {},
                     "entries": {"bb": b"pinned-blob"}}, f)
    assert artifact.import_bundle(bp)["stale"] is False
    assert "bb" in artifact.protected_fingerprints()

    clock = [0.0]
    with artifact.ArtifactCacheServer(max_bytes=0, max_age_s=100,
                                      clock=lambda: clock[0]) as srv:
        monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", srv.url)
        assert art_remote.publish("aa", b"a" * 10)
        assert art_remote.publish("bb", b"b" * 10)
        clock[0] = 200.0  # both aa and bb are now past the age bound
        assert art_remote.publish("cc", b"c" * 10)
        assert set(srv.store) == {"bb", "cc"}
        st = artifact.artifact_stats()
        assert st["gc_age_evicted"] == 1 and srv.gc_evicted == 1
        assert st["gc_protected"] == 1
        assert art_remote.fetch("aa") is None


def test_remote_http_flaky_host_retries(monkeypatch):
    with artifact.ArtifactCacheServer() as srv:
        monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", srv.url)
        srv.store["aa"] = b"blob"
        srv.fail_requests = 1  # first attempt 503s, the retry lands
        assert art_remote.fetch("aa") == b"blob"
        assert srv.requests == 2
        assert artifact.artifact_stats()["remote_errors"] == 0


def test_remote_breaker_opens_and_degrades(monkeypatch):
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE_RETRIES", "1")
    with artifact.ArtifactCacheServer() as srv:
        monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", srv.url)
        srv.fail_requests = 10 ** 6  # host is down for good
        for _ in range(5):  # MXNET_BREAKER_THRESHOLD default
            assert art_remote.fetch("aa") is None  # degrade, not raise
        st = artifact.artifact_stats()
        assert st["remote_errors"] == 5
        assert art_remote.breaker_state() == "open"
        served = srv.requests
        assert art_remote.fetch("aa") is None  # skipped, no round-trip
        assert srv.requests == served
        assert artifact.artifact_stats()["remote_skipped"] >= 1
    # repointing the knob must not inherit the dead host's streak
    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE", "file:///nowhere")
    assert art_remote.breaker_state() == "closed"


def test_no_remote_configured_is_free(monkeypatch):
    monkeypatch.delenv("MXNET_ARTIFACT_REMOTE", raising=False)
    assert art_remote.fetch("aa") is None
    assert not art_remote.publish("aa", b"x")
    st = artifact.artifact_stats()
    assert st["remote_misses"] == 0 and st["remote_errors"] == 0


def _seed_cache_entries(d, entries):
    os.makedirs(d, exist_ok=True)
    for name, blob in entries.items():
        with open(os.path.join(d, name + cc.SUFFIX), "wb") as f:
            f.write(blob)


def test_bundle_export_import_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "c1"))
    _seed_cache_entries(cc.cache_dir(), {"aa": b"A", "bb": b"BB"})
    path = str(tmp_path / "m.bundle")
    report = artifact.export_bundle(
        path, ["bb", "aa", "aa", None, "gone"],
        manifest={"model": "m", "version": 1})
    assert report["entries"] == 2  # deduped, None dropped
    assert report["missing"] == ["gone"]
    assert report["bytes"] == os.path.getsize(path)

    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "c2"))
    res = artifact.import_bundle(path)
    assert res == {"written": 2, "skipped": 0, "stale": False,
                   "libraries": 0,
                   "manifest": {"model": "m", "version": 1}}
    for name, blob in (("aa", b"A"), ("bb", b"BB")):
        with open(os.path.join(cc.cache_dir(), name + cc.SUFFIX),
                  "rb") as f:
            assert f.read() == blob
    st = artifact.artifact_stats()
    assert st["bundle_exports"] == 1 and st["bundle_imports"] == 1
    assert st["bundle_entries_written"] == 2


def test_bundle_stale_salt_skips_everything(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "c1"))
    _seed_cache_entries(cc.cache_dir(), {"aa": b"A"})
    path = str(tmp_path / "m.bundle")
    artifact.export_bundle(path, ["aa"])
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "c2"))
    # the importer runs another torch/CUDA/card/format generation
    monkeypatch.setattr(cc, "_salt", lambda: ("other-generation",))
    res = artifact.import_bundle(path)
    assert res["stale"] and res["written"] == 0 and res["skipped"] == 1
    assert not os.path.exists(os.path.join(cc.cache_dir(), "aa" + cc.SUFFIX))


def test_import_bundle_rejects_non_bundles(tmp_path):
    junk = tmp_path / "junk.bundle"
    junk.write_bytes(b"not a pickle")
    with pytest.raises(MXNetError, match="cannot read bundle"):
        artifact.import_bundle(str(junk))
    import pickle

    notb = tmp_path / "notb.bundle"
    notb.write_bytes(pickle.dumps({"something": "else"}))
    with pytest.raises(MXNetError, match="not a format"):
        artifact.import_bundle(str(notb))
    with pytest.raises(MXNetError):
        artifact.import_bundle(str(tmp_path / "absent.bundle"))




def _small_w2v_export(tmp_path):
    from mxnet_tpu_torch.tools.profile_predict import (
        WAV2VEC2_LARGE_LV60, export_wav2vec2)

    cfg = dict(WAV2VEC2_LARGE_LV60, conv_dim=(32,) * 3,
               conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4),
               hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=4)
    prefix = str(tmp_path / "wav2vec2-small")
    export_wav2vec2(prefix, jmx.sym, jmx.nd, cfg, 11)
    return prefix


def test_repository_export_bundle(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    prefix = _small_w2v_export(tmp_path)
    sess = serving.InferenceSession.load(
        prefix, input_shapes=[(1, 4000, 1)], buckets=[1, 2], ctx=CPU)
    with serving.ModelRepository(admission=False) as repo:
        repo.deploy("m", sess)
        with pytest.raises(MXNetError, match="unknown model"):
            repo.export_bundle("ghost", str(tmp_path / "g.bundle"))
        with pytest.raises(MXNetError, match="no version"):
            repo.export_bundle("m", str(tmp_path / "g.bundle"), version=9)
        report = repo.export_bundle("m", str(tmp_path / "m.bundle"))
    assert report["model"] == "m" and report["version"] == 1
    assert report["entries"] == 2 and report["missing"] == []
    assert report["libraries"] == []  # the CPU loads no kernel library
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "c2"))
    res = artifact.import_bundle(str(tmp_path / "m.bundle"))
    assert res["manifest"] == {"model": "m", "version": 1,
                               "buckets": [1, 2]}
    assert res["written"] == 2


def test_artifact_family_renders_in_prometheus(monkeypatch, tmp_path):
    from mxnet_tpu_torch import telemetry

    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE",
                       "file://" + str(tmp_path / "empty"))
    assert art_remote.fetch("aa" * 8) is None
    text = telemetry.prometheus_text()
    assert "mxnet_artifact_remote_misses 1" in text
    assert "mxnet_artifact_remote_hits 0" in text
    assert "mxnet_compile_cache_disk_evicted" in text
    assert set(artifact.artifact_stats()) == set(jartifact.artifact_stats())


# ---------------------------------------------------------------------------
# the slice as a whole: a bundle-warm process on the CPU

def test_bundle_warm_child_serves_bitwise_with_no_graph_optimizer(
        monkeypatch, tmp_path):
    from mxnet_tpu_torch.tools import deploy_chain as dc

    from mxnet_tpu_torch.contrib import amp

    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    # an AMP policy turned on and off earlier in this process: the
    # programs key on the policy, not on this process's count of changes
    amp.init("bfloat16")
    amp.disable()
    prefix = _small_w2v_export(tmp_path)
    x = onp.random.RandomState(4).randn(4, 4000, 1).astype("float32")
    jsess = jserving.InferenceSession.load(
        prefix, input_shapes=[(1, 4000, 1)], buckets=[4], warm=False)
    jwant = jsess.predict(x).asnumpy()
    spec = {"kind": "symbol", "prefix": prefix, "samples": 4000,
            "bucket": 4}
    sess = dc.build_session(spec, CPU)
    with serving.ModelRepository(admission=False) as repo:
        repo.deploy("w2v", sess)
        want = repo.predict("w2v", x)
        report = repo.export_bundle("w2v", str(tmp_path / "w2v.bundle"))
    want = onp.asarray(want)
    onp.testing.assert_allclose(want, jwant, rtol=1e-4, atol=1e-4)
    assert report["entries"] >= 1
    with open(tmp_path / "w2v.bundle", "rb") as f:
        env = pickle.load(f)
    program = cc.decode_value(
        json.loads(next(iter(env["entries"].values())))["payload"])
    assert program["version"] == 1 and any(
        n["op"] == "_fused_attention" for n in program["nodes"])
    onp.savez(tmp_path / "in.npz", w2v=x)
    cspec = {"ctx": "cpu", "bundles": [str(tmp_path / "w2v.bundle")],
             "models": {"w2v": spec}, "inputs": str(tmp_path / "in.npz"),
             "out": str(tmp_path / "out.npz"), "spawn_wall": time.time()}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(cspec, f)
    env = dict(os.environ, MXNET_COMPILE_CACHE_DIR=str(tmp_path / "child"),
               MXNET_HOME=str(tmp_path / "home"))
    proc = subprocess.run(
        [sys.executable, "-m", dc.__name__, "serve",
         str(tmp_path / "spec.json")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    c = child["counters"]
    assert c["graph_opt_runs"] == 0 and c["compile_cache"]["retraces"] == 0
    assert c["compile_cache"]["disk_hits"] == report["entries"]
    assert c["compile_cache"]["kernel_builds"] == 0
    assert child["imports"][0]["written"] == report["entries"]
    got = onp.load(tmp_path / "out.npz")["w2v/out"]
    assert onp.array_equal(got, want)
