"""Autotune (``autotune/``, ``benchmark/_measure.py``): the port against
the JAX package.

The twins of ``tests/test_autotune.py``: the decision registry, the
``MXNET_AUTOTUNE`` modes, records through memory and disk (and a remote
tier: one process tunes and publishes, another consults with zero
measurements and writes through to its disk), corrupt, drifted or
out-of-candidate records as removed misses, trial overrides, the
consults in the fusion cost model and the quantize lowering, the
autotune salt leaving record-free fingerprints alone, and the tuner's
sweep, no-win pin, budget and fault seam. The port's cost model keys
its consults by the device type where the JAX package's reads
``jax.default_backend()``.

Against the JAX package: the decision catalogue (names, candidates,
defaults), ``lookup``'s precedence (an explicit knob beats a record,
which beats the heuristic), ``paired_overhead``/``paired_speedup`` on
the same timing lists, and a record's JSON fields.
"""
import json
import os

import pytest

from mxnet_tpu import autotune as jautotune
from mxnet_tpu.autotune import records as jrecords
from mxnet_tpu.benchmark import _measure as jmeasure
from mxnet_tpu.ndarray import ops_quant as jops_quant

from mxnet_tpu_torch import autotune
from mxnet_tpu_torch.autotune import records, registry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.benchmark import _measure

DEC = "unit.synthetic"


def _declare():
    return autotune.declare_decision(
        DEC, candidates=(1, 2, 3), default=2, key_doc="(backend,)")


@pytest.fixture
def tuned(tmp_path, monkeypatch):
    """Isolated record dir + clean counters; mode = consult."""
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "atr"))
    monkeypatch.setenv("MXNET_AUTOTUNE", "consult")
    autotune.reset_autotune_state()
    _declare()
    yield autotune
    autotune.reset_autotune_state()


# ---------------------------------------------------------------------------
# registry

def test_declare_returns_default_and_is_idempotent(tuned):
    assert _declare() == 2  # same declaration: fine, returns default
    point = autotune.get_point(DEC)
    assert point.candidates == (1, 2, 3) and point.default == 2


def test_conflicting_redeclaration_raises(tuned):
    with pytest.raises(MXNetError, match="already declared"):
        autotune.declare_decision(DEC, candidates=(1, 2), default=1)


def test_builtin_decision_points_cataloged(tuned):
    names = autotune.decision_points()
    assert list(names) == sorted(names)
    for expect in ("fusion.min_cluster", "fusion.attn_compute_bound_seq",
                   "fusion.elementwise_bandwidth_log2",
                   "quantize.lowering"):
        assert expect in names


def test_unknown_point_raises(tuned):
    with pytest.raises(MXNetError, match="unknown decision"):
        autotune.get_point("no.such.decision")


# ---------------------------------------------------------------------------
# mode knob

def test_mode_values(tuned, monkeypatch):
    assert autotune.mode() == "consult"
    for raw, want in (("0", "0"), ("off", "0"), ("false", "0"),
                      ("tune", "tune"), ("CONSULT", "consult")):
        monkeypatch.setenv("MXNET_AUTOTUNE", raw)
        assert autotune.mode() == want
    monkeypatch.setenv("MXNET_AUTOTUNE", "bogus")
    with pytest.raises(MXNetError, match="MXNET_AUTOTUNE"):
        autotune.mode()


def test_mode_off_short_circuits_lookup(tuned, monkeypatch):
    records.store_record(DEC, ("cpu",), 3)
    monkeypatch.setenv("MXNET_AUTOTUNE", "0")
    assert autotune.lookup(DEC, ("cpu",)) is None
    c = autotune.counters()
    assert c["lookups"] == 1 and c["hits"] == 0
    # and the salt provider contributes nothing when off
    assert autotune.autotune_salt() == ()


def test_tune_requires_tune_mode(tuned):
    with pytest.raises(MXNetError, match="MXNET_AUTOTUNE=tune"):
        autotune.tune(DEC, ("cpu",), lambda choice: (lambda: 1.0))


# ---------------------------------------------------------------------------
# record lifecycle: memory / disk tiers

def test_store_then_consult_and_disk_roundtrip_bitwise(tuned):
    rec = records.store_record(DEC, ("cpu",), 3,
                               extra={"speedup": 1.25, "won": True})
    fp = records.record_fingerprint(DEC, ("cpu",))
    path = os.path.join(records.records_dir(), fp + ".atr")
    with open(path, "rb") as f:
        blob1 = f.read()
    assert json.loads(blob1) == rec  # what's on disk IS the record
    # storing the same record again is byte-identical (sorted keys,
    # fixed indent — the file format is canonical)
    records.store_record(DEC, ("cpu",), 3,
                         extra={"speedup": 1.25, "won": True})
    with open(path, "rb") as f:
        assert f.read() == blob1
    assert autotune.lookup(DEC, ("cpu",)) == 3
    assert autotune.counters()["hits"] == 1


def test_records_survive_restart(tuned):
    records.store_record(DEC, ("cpu",), 1)
    # "restart": drop every in-memory tier, keep the disk files
    records.reset_record_state()
    assert records.consult(DEC, ("cpu",)) == 1
    assert autotune.counters()["record_load"] == 1


def test_store_rejects_choice_outside_candidates(tuned):
    with pytest.raises(MXNetError, match="outside the declared"):
        records.store_record(DEC, ("cpu",), 99)


def test_unfingerprintable_key_is_heuristic_only(tuned):
    key = (object(),)  # repr carries a memory address: not stable
    assert records.record_fingerprint(DEC, key) is None
    assert records.store_record(DEC, key, 1) is None
    assert records.consult(DEC, key) is None


# ---------------------------------------------------------------------------
# corrupt / drifted records: miss + removal, never a crash

def _plant(tuned, blob):
    fp = records.record_fingerprint(DEC, ("cpu",))
    d = records.records_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, fp + ".atr")
    with open(path, "wb") as f:
        f.write(blob)
    return path


def test_corrupt_record_is_miss_and_removed(tuned):
    path = _plant(tuned, b"{not json")
    assert records.consult(DEC, ("cpu",)) is None
    assert not os.path.exists(path), "corrupt file must be removed"
    assert autotune.counters()["record_corrupt"] == 1


def test_version_drifted_record_is_miss_and_removed(tuned):
    stale = {"version": 0, "decision": DEC, "key": "('cpu',)",
             "choice": 3}
    path = _plant(tuned, json.dumps(stale).encode())
    assert records.consult(DEC, ("cpu",)) is None
    assert not os.path.exists(path)
    assert autotune.counters()["record_corrupt"] == 1


def test_out_of_candidates_record_is_miss_and_removed(tuned):
    bad = {"version": records.RECORD_VERSION, "decision": DEC,
           "key": "('cpu',)", "choice": 99}
    path = _plant(tuned, json.dumps(bad).encode())
    assert records.consult(DEC, ("cpu",)) is None
    assert not os.path.exists(path)


def test_corrupt_record_never_breaks_decide(tuned):
    """A consult inside the fusion cost model degrades to the heuristic
    when the stored record is garbage — the decision still returns."""
    from mxnet_tpu_torch.kernels import cost_model

    fp = records.record_fingerprint("fusion.min_cluster", ("cpu",))
    d = records.records_dir()
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, fp + ".atr"), "wb") as f:
        f.write(b"\x00garbage\xff")
    dec = cost_model.decide("elementwise", 3, out_shape=(8, 8),
                            device="cpu")
    assert dec.fuse  # heuristic default (min_cluster=2) applied
    assert autotune.counters()["record_corrupt"] == 1


# ---------------------------------------------------------------------------
# trial overrides

def test_trial_overrides_and_shadows_stored_record(tuned):
    records.store_record(DEC, ("cpu",), 1)
    with records.trial(DEC, ("cpu",), 3):
        assert records.trial_active()
        assert autotune.lookup(DEC, ("cpu",)) == 3
        # the salt carries the trial, marked distinctly from a record
        entries = records.active_entries()
        assert any(c == "trial:3" for _, _, c in entries), entries
    assert autotune.lookup(DEC, ("cpu",)) == 1
    assert not records.trial_active()


def test_nested_trial_same_key_raises(tuned):
    with records.trial(DEC, ("cpu",), 1):
        with pytest.raises(MXNetError, match="nested trial"):
            with records.trial(DEC, ("cpu",), 2):
                pass
    assert not records.trial_active()  # cleanly unwound


# ---------------------------------------------------------------------------
# consult hooks in the shipped policies

def test_decide_consults_min_cluster_record(tuned):
    from mxnet_tpu_torch.kernels import cost_model

    assert cost_model.decide("elementwise", 3, out_shape=(8, 8),
                             device="cpu").fuse
    with records.trial("fusion.min_cluster", ("cpu",), 4):
        dec = cost_model.decide("elementwise", 3, out_shape=(8, 8),
                                device="cpu")
    assert not dec.fuse and dec.reason == "too_small"


def test_decide_consults_attention_bound_by_feat_bucket(tuned):
    from mxnet_tpu_torch.kernels import cost_model

    kw = dict(out_shape=(4, 64, 48), device="cpu",
              score_shape=(4, 64, 64))
    # default bound 64: seq 64 is compute-bound -> unfused
    assert cost_model.decide("attention", 5, **kw).reason == \
        "compute_bound_attention"
    # a record for THIS feat bucket (48 -> 64) flips it
    with records.trial("fusion.attn_compute_bound_seq",
                       ("cpu", 64), 4096):
        assert cost_model.decide("attention", 5, **kw).fuse
    # a record for a DIFFERENT bucket does not
    with records.trial("fusion.attn_compute_bound_seq",
                       ("cpu", 128), 4096):
        assert not cost_model.decide("attention", 5, **kw).fuse


def test_decide_consults_elementwise_bandwidth_cap(tuned):
    from mxnet_tpu_torch.kernels import cost_model

    big = (2048, 4096)  # 2**23 elements: above the default 2**22 cap
    assert cost_model.decide("elementwise", 7, out_shape=big,
                             device="cpu").reason == "bandwidth_bound"
    with records.trial("fusion.elementwise_bandwidth_log2",
                       ("cpu",), 24):
        assert cost_model.decide("elementwise", 7, out_shape=big,
                                 device="cpu").fuse


def test_quantize_lowering_consults_record(tuned, monkeypatch):
    from mxnet_tpu_torch.ndarray import ops_quant

    monkeypatch.delenv("MXNET_QUANTIZE_LOWERING", raising=False)
    heuristic = ops_quant.lowering()  # dequant on cpu
    assert heuristic == "dequant"
    with records.trial("quantize.lowering", ("cpu",), "native"):
        assert ops_quant.lowering() == "native"
    # an explicit env choice always beats the record
    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", "dequant")
    with records.trial("quantize.lowering", ("cpu",), "native"):
        assert ops_quant.lowering() == "dequant"


# ---------------------------------------------------------------------------
# salt coexistence: record-absent fingerprints stay byte-identical

def test_autotune_salt_declared_but_inactive_keeps_fingerprint(tuned):
    from mxnet_tpu_torch import artifact

    key = ("unit", "coexist")
    bare = artifact.CompiledArtifact("unit_autotune", key).fingerprint
    declared = artifact.CompiledArtifact(
        "unit_autotune", key, salts=("autotune",)).fingerprint
    # no active record: adding the salt to the declaration must NOT
    # move the fingerprint (warm pre-autotune caches stay warm)
    assert declared == bare

    records.store_record(DEC, ("cpu",), 3)
    tuned_fp = artifact.CompiledArtifact(
        "unit_autotune", key, salts=("autotune",)).fingerprint
    assert tuned_fp != bare  # a live record separates the executables
    undeclared = artifact.CompiledArtifact(
        "unit_autotune", key).fingerprint
    assert undeclared == bare  # undeclared artifacts unaffected


def test_salt_content_and_graph_opt_tag_form(tuned):
    assert autotune.autotune_salt() == ()
    records.store_record(DEC, ("cpu",), 3)
    salt = autotune.autotune_salt()
    assert salt[0] == "autotune" and salt[1] == records.RECORD_VERSION
    assert (DEC, "('cpu',)", "3") in salt[2:]
    # dropping the directory empties the salt again (scan authority)
    for fn in os.listdir(records.records_dir()):
        os.remove(os.path.join(records.records_dir(), fn))
    records.reset_record_state()
    assert autotune.autotune_salt() == ()


# ---------------------------------------------------------------------------
# tuner: sweep, no-win pin, budget, fault seam

def _fake_measure(costs):
    """make_measure returning constant synthetic 'timings': choice ->
    seconds per window (None = the heuristic default workload)."""
    def factory(choice):
        cost = costs[choice]
        return lambda: cost
    return factory


def test_tune_persists_winner_and_consults_back(tuned, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "tune")
    rec = autotune.tune(DEC, ("cpu",),
                        _fake_measure({None: 1.0, 1: 1.0, 2: 1.0,
                                       3: 0.5}),
                        pairs=2)
    assert rec["choice"] == 3 and rec["won"] is True
    assert rec["speedup"] == pytest.approx(2.0)
    monkeypatch.setenv("MXNET_AUTOTUNE", "consult")
    assert autotune.lookup(DEC, ("cpu",)) == 3
    c = autotune.counters()
    assert c["measurements"] == 3 and c["wins"] == 1


def test_tune_no_win_pins_default_identity(tuned, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "tune")
    rec = autotune.tune(DEC, ("cpu",),
                        _fake_measure({None: 1.0, 1: 1.01, 2: 1.0,
                                       3: 1.005}),
                        pairs=2)
    # nothing beat the default by min_speedup: the DEFAULT is pinned
    # with identity speedup so consults hit without changing behavior
    assert rec["choice"] == 2 and rec["won"] is False
    assert rec["speedup"] == 1.0
    assert autotune.counters()["wins"] == 0
    assert records.consult(DEC, ("cpu",)) == 2


def test_tune_budget_stops_between_candidates(tuned, monkeypatch):
    import time as _time

    monkeypatch.setenv("MXNET_AUTOTUNE", "tune")

    def factory(choice):
        def window():
            _time.sleep(0.02)
            return 1.0
        return window

    rec = autotune.tune(DEC, ("cpu",), factory, pairs=1, budget_ms=1)
    # the first candidate always completes; the budget stops the rest
    assert rec["budget_stopped"] is True
    assert len(rec["measured"]) == 1


def test_tune_fault_seam_skips_candidate(tuned, monkeypatch):
    from mxnet_tpu_torch.resilience import faults

    monkeypatch.setenv("MXNET_AUTOTUNE", "tune")
    with faults.inject("autotune_measure", at=1):
        rec = autotune.tune(DEC, ("cpu",),
                            _fake_measure({None: 1.0, 1: 1.0, 2: 1.0,
                                           3: 0.5}),
                            pairs=2)
    # candidate 1 was skipped by the injected fault; the sweep degraded
    # to the remaining candidates instead of crashing
    assert rec["skipped"] == [1]
    assert [m["choice"] for m in rec["measured"]] == [2, 3]
    assert rec["choice"] == 3
    assert autotune.counters()["measure_failures"] == 1


def test_tune_all_candidates_failing_raises(tuned, monkeypatch):
    from mxnet_tpu_torch.resilience import faults

    monkeypatch.setenv("MXNET_AUTOTUNE", "tune")
    with faults.inject("autotune_measure", every=1, times=3):
        with pytest.raises(MXNetError, match="measured no candidate"):
            autotune.tune(DEC, ("cpu",),
                          _fake_measure({None: 1.0, 1: 1.0, 2: 1.0,
                                         3: 1.0}))



# ---------------------------------------------------------------------------
# fleet sharing through the remote tier (in one process: a fresh record
# directory and empty memory tiers stand for the second replica)

def test_fleet_record_sharing_zero_measurements(tuned, monkeypatch,
                                                tmp_path):
    from mxnet_tpu_torch import artifact

    monkeypatch.setenv("MXNET_ARTIFACT_REMOTE",
                       "file://" + str(tmp_path / "fleet"))
    monkeypatch.setenv("MXNET_AUTOTUNE", "tune")
    rec = autotune.tune(DEC, ("cpu",),
                        _fake_measure({None: 1.0, 1: 1.0, 2: 1.0,
                                       3: 0.5}), pairs=2)
    assert rec["choice"] == 3
    assert artifact.artifact_stats()["remote_publishes"] == 1
    # replica B: its own empty directory, the same remote
    monkeypatch.setenv("MXNET_AUTOTUNE", "consult")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "atr_b"))
    autotune.reset_autotune_state()
    assert autotune.lookup(DEC, ("cpu",)) == 3
    c = autotune.counters()
    assert c["measurements"] == 0 and c["hits"] == 1
    assert len(os.listdir(records.records_dir())) == 1  # written through
    # B restarts: its disk serves, not the remote
    autotune.reset_autotune_state()
    before = artifact.artifact_stats()["remote_hits"]
    assert autotune.lookup(DEC, ("cpu",)) == 3
    assert artifact.artifact_stats()["remote_hits"] == before


# ---------------------------------------------------------------------------
# the port against the JAX package

BUILTINS = ("fusion.min_cluster", "fusion.attn_compute_bound_seq",
            "fusion.elementwise_bandwidth_log2", "quantize.lowering")


@pytest.mark.parametrize("name", BUILTINS)
def test_decision_catalogue_equals_jax(name):
    assert name in autotune.decision_points()
    assert autotune.get_point(name) == jautotune.get_point(name) or (
        autotune.get_point(name).__dict__ ==
        jautotune.get_point(name).__dict__)


def test_lookup_precedence_equals_jax(tuned, monkeypatch, tmp_path):
    from mxnet_tpu_torch.ndarray import ops_quant

    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "both"))
    monkeypatch.delenv("MXNET_QUANTIZE_LOWERING", raising=False)
    jautotune.reset_autotune_state()
    cases = []
    for env in (None, "dequant", "native"):
        if env is None:
            monkeypatch.delenv("MXNET_QUANTIZE_LOWERING", raising=False)
        else:
            monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", env)
        plain = (ops_quant.lowering(), jops_quant.lowering())
        with records.trial("quantize.lowering", ("cpu",), "native"), \
                jrecords.trial("quantize.lowering", ("cpu",), "native"):
            tried = (ops_quant.lowering(), jops_quant.lowering())
        cases.append((plain, tried))
    for (p, pj), (t, tj) in cases:
        assert p == pj and t == tj
    # heuristic, record, knob: dequant -> native -> the knob's value
    assert [c[1][0] for c in cases] == ["native", "dequant", "native"]
    assert cases[0][0][0] == "dequant"
    jautotune.reset_autotune_state()


@pytest.mark.parametrize("pairs,reps", [(1, 1), (3, 1), (4, 2), (5, 3)])
def test_paired_measures_equal_jax(pairs, reps):
    def seq(values):
        it = iter(values)
        return lambda: next(it)

    n = pairs * reps
    base = [1.0 + 0.01 * i for i in range(n)]
    test = [0.8 + 0.03 * (i % 3) for i in range(n)]
    for fn in ("paired_overhead", "paired_speedup"):
        got = getattr(_measure, fn)(seq(base), seq(test), pairs, reps)
        want = getattr(jmeasure, fn)(seq(base), seq(test), pairs, reps)
        assert got == want


def test_record_json_has_the_jax_fields(tuned, monkeypatch, tmp_path):
    jautotune.reset_autotune_state()
    jautotune.declare_decision(DEC, candidates=(1, 2, 3), default=2,
                               key_doc="(backend,)")
    extra = {"speedup": 1.25, "won": True, "pairs": 3}
    rec = records.store_record(DEC, ("cpu",), 3, extra=dict(extra))
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "jax"))
    jrec = jrecords.store_record(DEC, ("cpu",), 3, extra=dict(extra))
    # the JAX fields, and the port's one more: the stack it was taken on
    assert {k: rec[k] for k in jrec} == jrec
    assert set(rec) - set(jrec) == {"stack"}
    path = os.path.join(str(tmp_path / "atr"),
                        records.record_fingerprint(DEC, ("cpu",)) + ".atr")
    with open(path) as f:
        assert json.load(f) == rec
    jautotune.reset_autotune_state()


def test_a_jax_record_in_the_directory_is_left_alone(tuned, monkeypatch,
                                                     tmp_path):
    # both packages default to $MXNET_HOME/autotune: the JAX package's
    # records neither salt the port's programs nor get removed
    jautotune.declare_decision(DEC, candidates=(1, 2, 3), default=2,
                               key_doc="(backend,)")
    jrecords.store_record(DEC, ("cpu",), 3)
    assert autotune.autotune_salt() == ()
    assert len(os.listdir(records.records_dir())) == 1
    records.store_record(DEC, ("cpu",), 1)
    assert len(autotune.autotune_salt()) == 3  # the port's record alone
    jautotune.reset_autotune_state()
