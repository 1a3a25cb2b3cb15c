"""Declarative fingerprint-salt providers.

The PyTorch counterpart of ``mxnet_tpu/artifact/salts.py``. A subsystem
whose state changes the program a call site persists registers a
provider here (``register_salt_provider``): ``provider(ctx) -> tuple``,
process-stable, empty when it contributes nothing. A call site building
a :class:`~.core.CompiledArtifact` declares the provider names it
depends on and a context dict; they resolve in declared order.

Built-in providers (registered by their owning modules at import):

===========  ==========================  =================================
name         registered by               context keys read
===========  ==========================  =================================
graph_opt    analysis/graph_opt.py       ``optimizable`` (bool),
                                         ``opt_level`` (optional int)
quantize     analysis/quantize.py        ``graph_signature`` (the
                                         graph's JSON or None), ``device``
paged_state  serving/state.py            ``paged``, ``page_tokens``,
                                         ``kv_int8``
autotune     autotune/records.py         (none: the active records)
sharding     here                        (none: ``()`` until the port
                                         shards, slice 9b)
===========  ==========================  =================================
"""
from __future__ import annotations

import importlib

from ..base import MXNetError
from ..utils import locks as _locks

__all__ = ["register_salt_provider", "salt_providers", "resolve_salts"]

# guards: _PROVIDERS
_LOCK = _locks.RankedLock("artifact.salts")
_PROVIDERS = {}

# lazy built-ins: the provider lives with its subsystem, which registers
# it at import; resolving a declared-but-unregistered built-in imports
# the owning module instead of failing on import order
_BUILTIN_MODULES = {
    "graph_opt": "mxnet_tpu_torch.analysis.graph_opt",
    "quantize": "mxnet_tpu_torch.analysis.quantize",
    "paged_state": "mxnet_tpu_torch.serving.state",
    "autotune": "mxnet_tpu_torch.autotune",
}


def register_salt_provider(name, provider, replace=False):
    """Register ``provider(ctx) -> tuple`` under ``name``. Re-binding an
    existing name requires ``replace=True``."""
    if not callable(provider):
        raise MXNetError(f"salt provider {name!r} is not callable")
    with _LOCK:
        if not replace and name in _PROVIDERS \
                and _PROVIDERS[name] is not provider:
            raise MXNetError(
                f"salt provider {name!r} is already registered; pass "
                "replace=True to rebind")
        _PROVIDERS[name] = provider
    return provider


def salt_providers():
    """Registered provider names, sorted."""
    with _LOCK:
        return sorted(_PROVIDERS)


def _provider(name):
    with _LOCK:
        fn = _PROVIDERS.get(name)
    if fn is None and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
        with _LOCK:
            fn = _PROVIDERS.get(name)
    if fn is None:
        raise MXNetError(
            f"unknown salt provider {name!r} (registered: "
            f"{salt_providers()})")
    return fn


def resolve_salts(names, ctx=None):
    """Resolve declared provider names against ``ctx``, in declared
    order: a tuple of per-provider salt tuples."""
    ctx = ctx or {}
    return tuple(tuple(_provider(name)(ctx)) for name in names)


def _sharding_salt(ctx):
    """The port serves unsharded (``shard_params`` comes with slice 9b),
    so sharding contributes nothing yet."""
    return ()


register_salt_provider("sharding", _sharding_salt)
