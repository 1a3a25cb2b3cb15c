"""The artifact layer: one path from salt declaration to a deployable
program.

The PyTorch counterpart of ``mxnet_tpu/artifact/``. What the port
persists is not machine code for a graph (the JAX package's XLA
executables) but what it builds before a first response:

- **programs** — symbol graphs after the graph optimizer and the
  quantize pass, the calibrated int8 graph, the fused step's plan — as
  JSON envelopes in the compile cache (``utils/compile_cache.py``);
- **kernel libraries** — each hand-written CUDA source built by
  ``nvcc`` (``kernels/_build.py``).

Pieces:

- :mod:`.salts` — declarative fingerprint-salt providers;
- :mod:`.core` — :class:`CompiledArtifact`: fingerprint → local tier →
  remote tier → build → persist;
- :mod:`.bundle` — a model version's programs and libraries as one
  file; a bundle-warm replica builds nothing before its first response
  (it still captures its CUDA graphs);
- :mod:`.remote` — the fleet-shared remote tier (``file://`` or
  ``http(s)://``) under the retry policy and a circuit breaker.

Counters: the ``artifact`` family (:func:`artifact_stats`), rendered as
``mxnet_artifact_*`` on ``/metrics``.
"""
from ._counters import artifact_stats, reset_artifact_counters
from .salts import register_salt_provider, resolve_salts, salt_providers
from .core import CompiledArtifact
from .bundle import (BUNDLE_FORMAT, export_bundle, import_bundle,
                     protected_fingerprints,
                     reset_protected_fingerprints)
from .remote import (ArtifactCacheServer, fetch, publish, publish_path,
                     remote_url, reset_remote_state)

__all__ = [
    "CompiledArtifact",
    "register_salt_provider", "resolve_salts", "salt_providers",
    "BUNDLE_FORMAT", "export_bundle", "import_bundle",
    "protected_fingerprints", "reset_protected_fingerprints",
    "ArtifactCacheServer", "fetch", "publish", "publish_path",
    "remote_url", "reset_remote_state",
    "artifact_stats", "reset_artifact_counters",
]
