"""Unified metrics registry: every counter family in one place.

The PyTorch counterpart of ``mxnet_tpu/telemetry/metrics.py``. The
port's counters lived on separate per-module surfaces
(``fused_step_stats``, ``pipeline_counters``, ``kernels.counters``,
``serving_stats``, ``retry_counters``, the analysis counters, ...);
this registry reads them all:

- **Owned families** (:class:`CounterFamily`): a subsystem whose state
  IS a flat counter dict binds it here
  (``_COUNTERS = telemetry.counter_family("pipeline", zeros)``) and
  keeps mutating it with the same code, under the family's lock;
- **Probed families** (:func:`register_family`): a subsystem whose
  snapshot is computed (an LRU's stats, latency quantiles, live
  gauges) registers a snapshot callable, called at read time only.

Both surface alike: :func:`family_snapshot` / :func:`snapshot` feed the
``profiler.*_counters()`` views and the counter samples of
``profiler.dump()`` / ``telemetry.dump_trace``, and
:func:`prometheus_text` renders ONE text exposition: the serving
block as the serving registry renders it, then every other family as
``mxnet_<family>_<name>`` gauges. Nothing here reads the card.
"""
from __future__ import annotations

from ..utils import locks as _locks

__all__ = ["labeled_lines",
           "CounterFamily", "MetricsRegistry", "REGISTRY",
           "counter_family", "register_family", "register_exposition",
           "family_snapshot", "snapshot", "prometheus_text"]


class CounterFamily:
    """A registry-owned, thread-safe, flat numeric counter dict.

    Implements the mapping slice the subsystems' counter code already
    uses (``[]``, ``get``, ``items``, ``clear``, iteration), so
    adopting the registry is a one-line binding change. Every mutation
    takes the family lock — the previous per-module locks moved here.
    """

    __slots__ = ("name", "_lock", "_zeros", "_data")

    def __init__(self, name, zeros=None):
        self.name = name
        # guards: _data
        self._lock = _locks.RankedLock("telemetry.counters")
        self._zeros = dict(zeros) if zeros else {}
        self._data = dict(self._zeros)

    # -- mutation (hot path: a lock + a couple of int ops) ------------

    def __setitem__(self, key, value):
        with self._lock:
            self._data[key] = value

    def add(self, key, delta=1):
        with self._lock:
            self._data[key] = self._data.get(key, 0) + delta

    def set(self, key, value):
        self[key] = value

    def clear(self):
        with self._lock:
            self._data.clear()

    def reset(self):
        """Back to the zero template (tests, benchmarks)."""
        with self._lock:
            self._data = dict(self._zeros)

    # -- reading ------------------------------------------------------

    def __getitem__(self, key):
        with self._lock:
            return self._data[key]

    def get(self, key, default=None):
        with self._lock:
            return self._data.get(key, default)

    def __contains__(self, key):
        with self._lock:
            return key in self._data

    def __iter__(self):
        return iter(self.snapshot())

    def __len__(self):
        with self._lock:
            return len(self._data)

    def items(self):
        return self.snapshot().items()

    def snapshot(self):
        with self._lock:
            return dict(self._data)


class MetricsRegistry:
    """Named counter/gauge families + pluggable Prometheus expositions.

    One process-wide instance (:data:`REGISTRY`); families register
    lazily at subsystem import, probes resolve at read time, and
    nothing here imports a subsystem — the registry must be importable
    before (and without) any of them."""

    def __init__(self):
        # guards: _owned, _probes, _expositions
        self._lock = _locks.RankedLock("telemetry.registry")
        self._owned = {}        # name -> CounterFamily
        self._probes = {}       # name -> callable() -> flat dict
        self._expositions = []  # (name, callable() -> prometheus text)

    def counter_family(self, name, zeros=None):
        """Create-or-fetch the owned family ``name``. Idempotent so a
        module reimport (tests) rebinds to the same live family."""
        with self._lock:
            fam = self._owned.get(name)
            if fam is None:
                fam = self._owned[name] = CounterFamily(name, zeros)
            return fam

    def register_family(self, name, probe):
        """Register (or replace) a probed family: ``probe()`` returns
        the family's flat numeric snapshot; it is called at read time
        only. Returns ``probe`` so import-time registration can
        decorate."""
        with self._lock:
            self._probes[name] = probe
        return probe

    def register_exposition(self, name, render):
        """Register a purpose-built Prometheus text block (the serving
        registry's histogram exposition) appended verbatim by
        :meth:`prometheus_text`. Idempotent by name."""
        with self._lock:
            self._expositions = [(n, r) for n, r in self._expositions
                                 if n != name]
            self._expositions.append((name, render))
        return render

    def families(self):
        """Public family names. A leading underscore marks an internal
        family (a sub-dict some probe already merges into its public
        view) — owned and mutable, but not separately surfaced."""
        with self._lock:
            return sorted(n for n in set(self._owned) | set(self._probes)
                          if not n.startswith("_"))

    def family_snapshot(self, name):
        """Flat numeric dict for one family ({} for unknown names —
        the profiler compatibility views must never raise). A probed
        family shadows an owned one of the same name: the probe is the
        richer, derived view."""
        with self._lock:
            probe = self._probes.get(name)
            fam = self._owned.get(name)
        if probe is not None:
            try:
                return dict(probe())
            except Exception:  # noqa: BLE001
                # a probe touching a half-torn-down subsystem (interp
                # shutdown) must not take the whole surface with it
                return {}
        return fam.snapshot() if fam is not None else {}

    def snapshot(self):
        """{family: {name: value}} across every registered family."""
        return {name: self.family_snapshot(name)
                for name in self.families()}

    # -- prometheus ---------------------------------------------------

    @staticmethod
    def _sanitize(name):
        out = []
        for ch in name:
            out.append(ch if ch.isalnum() or ch == "_" else "_")
        s = "".join(out)
        return s if not s[:1].isdigit() else "_" + s

    def prometheus_text(self):
        """ONE text exposition: every registered exposition block
        (serving's histograms and labels, as the serving registry
        renders them),
        then every OTHER family as ``mxnet_<family>_<name>`` gauges.
        Families already covered by an exposition block are skipped —
        the serving counters must not appear twice under two names."""
        with self._lock:
            expositions = list(self._expositions)
        parts = []
        covered = set()
        for name, render in expositions:
            covered.add(name)
            try:
                parts.append(render().rstrip("\n"))
            except Exception:  # noqa: BLE001
                pass  # a broken block must not 500 the /metrics scrape
        for family in self.families():
            if family in covered:
                continue
            snap = self.family_snapshot(family)
            if not snap:
                continue
            fam_prefix = f"mxnet_{self._sanitize(family)}"
            lines = [f"# HELP {fam_prefix} {family} counters "
                     "(mxnet_tpu_torch telemetry registry)",
                     f"# TYPE {fam_prefix} gauge"]
            for key in sorted(snap):
                val = snap[key]
                if isinstance(val, bool):
                    val = int(val)
                if not isinstance(val, (int, float)):
                    continue
                lines.append(
                    f"{fam_prefix}_{self._sanitize(key)} {val}")
            parts.append("\n".join(lines))
        return "\n".join(parts) + "\n"


#: the process-wide registry (module-level: importable before any
#: subsystem, and exactly one per process like serving's METRICS)
REGISTRY = MetricsRegistry()


def counter_family(name, zeros=None):
    """Module-level convenience for ``REGISTRY.counter_family``."""
    return REGISTRY.counter_family(name, zeros)


def register_family(name, probe):
    return REGISTRY.register_family(name, probe)


def register_exposition(name, render):
    return REGISTRY.register_exposition(name, render)


def family_snapshot(name):
    return REGISTRY.family_snapshot(name)


def snapshot():
    return REGISTRY.snapshot()


def prometheus_text():
    """The unified exposition (the serving ``/metrics`` body): serving
    histograms + every training-side family."""
    _bootstrap_probes()
    return REGISTRY.prometheus_text()


def labeled_lines(metric, rows, help_text=None):
    """Render one LABELED gauge metric as Prometheus text lines (the
    JAX fleet router's per-replica series). ``rows`` is an
    iterable of ``(labels_dict, value)``; returns ``[]`` when empty so
    an exposition block can concatenate unconditionally. Label values
    are escaped per the text-format rules (backslash, quote,
    newline); non-numeric values are skipped like the gauge pass."""
    rows = list(rows)
    if not rows:
        return []
    san = MetricsRegistry._sanitize
    name = f"mxnet_{san(metric)}"
    lines = [f"# HELP {name} {help_text or metric}",
             f"# TYPE {name} gauge"]
    for labels, value in rows:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        lab = ",".join(
            '{}="{}"'.format(
                san(str(k)),
                str(v).replace("\\", r"\\").replace('"', r'\"')
                .replace("\n", r"\n"))
            for k, v in sorted(labels.items()))
        lines.append(f"{name}{{{lab}}} {value}")
    return lines


# -- probe bootstrap --------------------------------------------------------

# guards: _BOOTED
_BOOT_LOCK = _locks.RankedLock("telemetry.boot")
_BOOTED = False

#: the JAX package's probed families the port has a subsystem for, with
#: the port's own reader; ``sharding`` (slice 9b) and ``eager_jit_cache``
#: (the port has no dispatch executable cache) are not registered.
#: ``kernel_launches`` is the port's own: its hand kernels' launch
#: counts. (The port's ``cached_op`` and ``executor`` families, its
#: CUDA-graph captures and replays, ``quantize``, ``artifact``,
#: ``autotune`` and ``fleet`` are owned, registered at import; their
#: modules are imported here so that a read surface shows them.)
PROBED_FAMILIES = (
    ("fused_step", "mxnet_tpu_torch.gluon.fused_step", "fused_step_stats"),
    ("serving", "mxnet_tpu_torch.serving.metrics", "serving_stats"),
    ("pipeline", "mxnet_tpu_torch.pipeline", "pipeline_counters"),
    ("resilience", "mxnet_tpu_torch.resilience", "resilience_counters"),
    ("graph_verify", "mxnet_tpu_torch.analysis", "counters"),
    ("graph_opt", "mxnet_tpu_torch.analysis.graph_opt", "counters"),
    ("fusion", "mxnet_tpu_torch.kernels", "counters"),
    ("kernel_launches", "mxnet_tpu_torch.kernels._build", "launch_counts"),
    ("compile_cache", "mxnet_tpu_torch.utils.compile_cache",
     "compile_cache_stats"),
    ("artifact", "mxnet_tpu_torch.artifact", "artifact_stats"),
    ("autotune", "mxnet_tpu_torch.autotune", "counters"),
    ("fleet", "mxnet_tpu_torch.serving.fleet", "fleet_counters"),
)


def _bootstrap_probes():
    """Register the probed families (:data:`PROBED_FAMILIES`) and the
    serving exposition. Lazy and idempotent: called before a full read
    surface (prometheus, dump_trace, the profiler views), never at
    import, so the registry imports no subsystem (and no torch)."""
    global _BOOTED
    with _BOOT_LOCK:
        if _BOOTED:
            return
        _BOOTED = True

    def _probe(modpath, attr):
        def probe():
            import importlib

            mod = importlib.import_module(modpath)
            return getattr(mod, attr)()
        return probe

    for family, modpath, attr in PROBED_FAMILIES:
        REGISTRY.register_family(family, _probe(modpath, attr))
    REGISTRY.register_exposition(
        "serving", _probe("mxnet_tpu_torch.serving.metrics",
                          "prometheus_text"))
