"""Environment-variable knob registry.

The PyTorch counterpart of ``mxnet_tpu/env.py`` (reference:
docs/static_site/src/pages/api/faq/env_var.md). Every ``MXNET_*`` name
the port reads is a row of :data:`KNOBS`, with one of three statuses:

- **wired**: the port reads it and it changes what the port does;
- **accepted**: read or recognized, and intentionally a no-op on the
  card, because torch, cuDNN or the CUDA caching allocator owns that
  concern;
- **unported**: the JAX package wires it, and the module that reads it
  is not ported yet; the consumer column names the slice that brings
  it.

``describe()`` prints the table; ``check()`` warns about set but
unknown ``MXNET_*`` variables, so a typo does not silently do nothing.
``python -m mxnet_tpu_torch.env`` writes the table as markdown
(``mxnet_tpu_torch/ENV_VARS.md``).
"""
from __future__ import annotations

import logging
import os

__all__ = ["KNOBS", "describe", "check", "get_int", "get_float",
           "get_bool", "get_str", "markdown_table"]

_9B = "slice 9b"

# name -> (status, consumer, description)
KNOBS = {
    # -- observability and the platform core --------------------------------
    "MXNET_LOCK_CHECK": (
        "wired", "utils.locks",
        "ranked-lock witness: 0 (off, raw threading primitives) / warn "
        "(count out-of-rank and cycle violations) / error (raise "
        "LockOrderError at the violating acquire); read once at import"),
    "MXNET_TELEMETRY": (
        "wired", "telemetry.tracer",
        "span tracing detail: 0 off (default; cost is one env read per "
        "site), 1 structural spans (fused step, serving lifecycle, "
        "pipeline), 2 adds per-op dispatch and per-pass graph-opt spans"),
    "MXNET_TELEMETRY_BUFFER": (
        "wired", "telemetry.tracer",
        "span ring-buffer capacity (default 65536 events); on overflow "
        "the oldest events drop and dropped_spans counts them"),
    "MXNET_SEED": (
        "wired", "__init__ / random",
        "global seed (torch, numpy, python) applied at import"),
    "MXNET_PROFILER_AUTOSTART": (
        "wired", "profiler",
        "start the profiler at import when 1 (host aggregate table on, "
        "and torch.profiler's device trace when a card is present)"),
    "MXNET_PROFILER_MODE": (
        "accepted", "profiler", "always all events"),
    # -- training -----------------------------------------------------------
    "MXNET_FUSED_STEP": (
        "wired", "gluon.Trainer",
        "fused train step: every parameter of a group updated by one "
        "step function, captured as a CUDA graph on the card; 0 = the "
        "eager per-parameter loop"),
    "MXNET_FUSED_STEP_CACHE_SIZE": (
        "wired", "gluon.fused_step",
        "LRU bound on cached fused step functions (default 16)"),
    "MXNET_FUSED_STEP_DONATE": (
        "accepted", "gluon.fused_step",
        "read and ignored: torch updates parameters in place, so there "
        "is no buffer to donate"),
    "MXNET_OPTIMIZER_AGGREGATION_SIZE": (
        "wired", "optimizer.Optimizer",
        "multi-tensor update group size (default 4)"),
    "MXNET_BACKWARD_DO_MIRROR": (
        "wired", "gluon CachedOp",
        "recompute a hybridized block's activations in backward "
        "(torch.utils.checkpoint)"),
    "MXNET_CUDNN_AUTOTUNE_DEFAULT": (
        "wired", "ndarray.ops_nn",
        "cuDNN algorithm search: 0 off, 1 or 2 on "
        "(torch.backends.cudnn.benchmark; default 1)"),
    "MXNET_DEVICE_PREFETCH": (
        "wired", "pipeline.DeviceFeed",
        "device-feed prefetch depth (default 2): batches staged onto the "
        "card ahead of the step on a side stream by a background "
        "thread; 0 = synchronous inline staging"),
    "MXNET_ASYNC_GRAD_SYNC": (
        "wired", "pipeline.grad_sync / gluon.Trainer",
        "dispatch-as-ready bucketed gradient all-reduce (default 1); 0 = "
        "one coalesced collective at step() time"),
    "MXNET_GRAD_BUCKET_KB": (
        "wired", "pipeline.grad_sync",
        "async grad-sync bucket size in KiB (default 512)"),
    "MXNET_DATALOADER_PREFETCH": (
        "wired", "gluon DataLoader",
        "default worker-pool prefetch depth when the constructor's "
        "prefetch=None (default 2*num_workers)"),
    "MXNET_MP_WORKER_NTHREADS": (
        "wired", "gluon DataLoader", "default data-loading workers"),
    # -- distributed --------------------------------------------------------
    "MXNET_COORDINATOR": (
        "wired", "tools.launch / _rendezvous",
        "rendezvous address (host:port) of the process group"),
    "MXNET_NUM_PROCESSES": (
        "wired", "tools.launch / _rendezvous", "world size"),
    "MXNET_PROCESS_ID": (
        "wired", "tools.launch / _rendezvous", "process rank"),
    "MXNET_LOCAL_RANK": (
        "wired", "tools.launch / _rendezvous",
        "rank on this host (picks the card; default the rank)"),
    "MXNET_LOCAL_SIZE": (
        "wired", "tools.launch / _rendezvous",
        "ranks on this host (default the world size)"),
    "MXNET_DIST_DEVICE": (
        "wired", "_rendezvous",
        "gpu (default; NCCL when every rank has a card of its own, gloo "
        "when ranks share one) or cpu (gloo)"),
    "MXNET_DIST_TIMEOUT": (
        "wired", "_rendezvous",
        "process-group timeout in seconds (default 300)"),
    "MXNET_KVSTORE_BIGARRAY_BOUND": (
        "wired", "kvstore", "row-shard stored values above this size"),
    "MXNET_KVSTORE_GC_TYPE": (
        "wired", "kvstore", "gradient compression type via env"),
    "MXNET_KVSTORE_GC_THRESHOLD": (
        "wired", "kvstore", "gradient compression threshold via env"),
    "MXNET_KVSTORE_ASYNC": (
        "wired", "kvstore",
        "OPT-IN (default 0): apply local kvstore pushes on a background "
        "applier thread; pull/barrier flush pending updates"),
    "MXNET_KVSTORE_GAP_TOLERANCE": (
        "wired", "kvstore_ps",
        "dist_async: seconds rank 0 waits on a missing gradient seq "
        "before abandoning it (default 30)"),
    "MXNET_KVSTORE_USETREE": (
        "accepted", "-", "NCCL picks the reduction topology"),
    "MXNET_KVSTORE_REDUCTION_NTHREADS": (
        "accepted", "-", "the reduction is one NCCL or gloo all-reduce"),
    "MXNET_KVSTORE_SLICE_THRESHOLD": (
        "accepted", "kvstore", "BIGARRAY_BOUND covers sharding"),
    "MXNET_ENABLE_GPU_P2P": ("accepted", "-", "NCCL decides peer access"),
    "MXNET_ENABLE_GPU_P2P_CHECK": ("accepted", "-", "NCCL decides"),
    "MXNET_IS_WORKER": ("accepted", "tools.launch", "all processes rank"),
    "MXNET_IS_SERVER": (
        "accepted", "tools.launch",
        "the async parameter server runs inside rank 0"),
    "MXNET_IS_SCHEDULER": (
        "accepted", "tools.launch", "the rendezvous TCPStore instead"),
    "MXNET_MODULE_UPDATE_ON_KVSTORE": (
        "accepted", "module", "Module always updates via kvstore updater"),
    "MXNET_UPDATE_ON_KVSTORE": (
        "accepted", "gluon.Trainer", "Trainer decides from kvstore type"),
    # -- graph optimization, fusion, quantization ---------------------------
    "MXNET_GRAPH_VERIFY": (
        "wired", "analysis",
        "static graph verifier: 0 (default, off) | warn | error "
        "(raise GraphVerifyError at bind)"),
    "MXNET_GRAPH_OPT": (
        "wired", "analysis.graph_opt",
        "graph-optimization rewrite pipeline at the symbol entry points: "
        "0 (default, off) | 1 (one sweep) | 2 (fixpoint)"),
    "MXNET_FUSION": (
        "wired", "kernels + analysis.fusion",
        "fusion-clustering kill switch for the graph-opt pass (default "
        "1); 0 disables every fusion path"),
    "MXNET_FUSION_PATTERNS": (
        "wired", "kernels + analysis.fusion",
        "comma list of armed cluster patterns out of elementwise, "
        "norm_act, attention, serving (default: all four)"),
    "MXNET_FUSION_COST_MODEL": (
        "wired", "kernels.cost_model",
        "cluster profitability policy: heuristic (default) | always | "
        "never"),
    "MXNET_QUANTIZE_LOWERING": (
        "wired", "ndarray.ops_quant",
        "how quantized conv/fc/batch_dot execute: auto (default) | "
        "native (int8 operands, int32 accumulation: the card's int8 "
        "convolution kernel) | dequant (float32 inline)"),
    "MXNET_QUANTIZE_SHADOW": (
        "wired", "serving.repository",
        "fraction (0..1, default 0) of canary requests shadow-checked "
        "against the incumbent model"),
    "MXNET_QUANTIZE_SHADOW_TOL": (
        "wired", "serving.repository",
        "max relative deviation of a shadow-checked canary response "
        "(default 0.1)"),
    "MXNET_USE_FUSION": (
        "accepted", "-", "the fusion pass is MXNET_FUSION"),
    "MXNET_FUSION_VERBOSE": ("accepted", "-", "see the telemetry spans"),
    "MXNET_SUBGRAPH_BACKEND": (
        "accepted", "-", "the graph optimizer replaces subgraph backends"),
    "MXNET_SUBGRAPH_VERBOSE": ("accepted", "-", "see the telemetry spans"),
    # -- serving ------------------------------------------------------------
    "MXNET_SERVING": (
        "wired", "serving",
        "serving master switch (default 1): 0 degrades DynamicBatcher to "
        "inline pass-through execution"),
    "MXNET_SERVING_MAX_BATCH": (
        "wired", "serving",
        "largest coalesced batch / largest captured bucket (default 32)"),
    "MXNET_SERVING_MAX_LATENCY_MS": (
        "wired", "serving.batcher",
        "micro-batch flush deadline in ms from the oldest queued request "
        "(default 5)"),
    "MXNET_SERVING_QUEUE_DEPTH": (
        "wired", "serving.batcher",
        "bound on queued requests per SLO class (default 256)"),
    "MXNET_SERVING_TIMEOUT_MS": (
        "wired", "serving.batcher",
        "default per-request deadline in ms (default 2000); <= 0 "
        "disables"),
    "MXNET_SERVING_WORKERS": (
        "wired", "serving.batcher",
        "batch-formation worker threads (default 1)"),
    "MXNET_SERVING_BUCKETS": (
        "wired", "serving.session",
        "batch-size buckets captured per model: pow2 (default) | mult:N "
        "| explicit comma list"),
    "MXNET_SERVING_HOST": (
        "wired", "serving.server", "ModelServer bind address"),
    "MXNET_SERVING_PORT": (
        "wired", "serving.server",
        "ModelServer port (default 8080; 0 binds an ephemeral port)"),
    "MXNET_SERVING_ADMISSION": (
        "wired", "serving.admission",
        "SLO-aware admission control (default 1)"),
    "MXNET_SERVING_SLO_MS": (
        "wired", "serving.admission",
        "latency SLO target in ms for the protected class (default 100)"),
    "MXNET_SERVING_SHED_HEADROOM": (
        "wired", "serving.admission", "headroom floor (default 0.15)"),
    "MXNET_SERVING_RETRY_AFTER_MS": (
        "wired", "serving.admission",
        "backoff hint in ms on admission-shed 503s (default 250)"),
    "MXNET_SERVING_CANARY_FRACTION": (
        "wired", "serving.repository",
        "slice of non-critical traffic routed to a canary (default 0.1)"),
    "MXNET_SERVING_CANARY_MIN_REQUESTS": (
        "wired", "serving.repository",
        "clean canary completions required before auto-promote "
        "(default 50)"),
    "MXNET_SERVING_CANARY_THRESHOLD": (
        "wired", "serving.repository",
        "canary breaker failure budget (default 3)"),
    "MXNET_SERVING_CANARY_LATENCY_X": (
        "wired", "serving.repository",
        "latency-regression multiplier (default 3.0)"),
    "MXNET_SERVING_STATE_SLOTS": (
        "wired", "serving.state", "session-state pool size (default 64)"),
    "MXNET_SERVING_STATE_BUDGET_MB": (
        "wired", "serving.state",
        "session-state pool byte budget in MiB (default 64)"),
    "MXNET_SERVING_STATE_TTL_S": (
        "wired", "serving.state",
        "idle session time-to-live in seconds (default 600)"),
    "MXNET_SERVING_STATE_PAGE_TOKENS": (
        "wired", "serving.state",
        "KV-cache page size in tokens (default 0 = row-slot mode)"),
    "MXNET_SERVING_STATE_KV_INT8": (
        "wired", "serving.state",
        "store float32 KV pages as per-page int8 codes and a scale "
        "(default 0)"),
    "MXNET_FLEET_VNODES": (
        "wired", "serving.fleet",
        "virtual nodes per replica on the consistent-hash ring "
        "(default 64)"),
    "MXNET_FLEET_PROBE_MS": (
        "wired", "serving.fleet",
        "fleet router health-gossip interval in ms (default 100)"),
    "MXNET_FLEET_TIMEOUT_MS": (
        "wired", "serving.fleet",
        "router->replica HTTP timeout in ms (default 30000)"),
    "MXNET_FLEET_DRAIN_TIMEOUT_MS": (
        "wired", "serving.fleet",
        "drain budget in ms, and how long a parked stateful request "
        "waits (default 10000)"),
    "MXNET_FLEET_RETRIES": (
        "wired", "serving.fleet",
        "cross-replica retries for stateless requests (default 2)"),
    # -- resilience ---------------------------------------------------------
    "MXNET_RESILIENCE": (
        "wired", "resilience",
        "resilience master switch (default 1): 0 degrades to fail-fast"),
    "MXNET_RETRY_MAX_ATTEMPTS": (
        "wired", "resilience.RetryPolicy",
        "total attempts of the shared retry policy (default 4)"),
    "MXNET_RETRY_BACKOFF_MS": (
        "wired", "resilience.RetryPolicy", "base backoff in ms (default 50)"),
    "MXNET_RETRY_BACKOFF_MAX_MS": (
        "wired", "resilience.RetryPolicy", "backoff cap in ms (default 2000)"),
    "MXNET_BREAKER_THRESHOLD": (
        "wired", "resilience.CircuitBreaker",
        "consecutive failures that trip a circuit breaker (default 5)"),
    "MXNET_BREAKER_COOLDOWN_MS": (
        "wired", "resilience.CircuitBreaker",
        "open-circuit cooldown in ms (default 30000)"),
    "MXNET_FAULT_PLAN": (
        "wired", "resilience.faults",
        "deterministic fault-injection plan, e.g. "
        "'device_put:at=3;kvstore_push:every=5:times=2'"),
    "MXNET_FAULT_SEED": (
        "wired", "resilience.faults",
        "seed for probabilistic fault clauses (default 0)"),
    "MXNET_CKPT_DIR": (
        "wired", "resilience.CheckpointManager",
        "default CheckpointManager directory (else "
        "$MXNET_HOME/checkpoints)"),
    "MXNET_CKPT_KEEP": (
        "wired", "resilience.CheckpointManager",
        "keep-last-N checkpoint retention (default 3; 0 keeps all)"),
    "MXNET_CKPT_ASYNC": (
        "wired", "resilience.CheckpointManager",
        "write checkpoints on a writer thread (default 1): the step "
        "thread pays one batched device copy of the state"),
    "MXNET_RESUME_MAX_RESTARTS": (
        "wired", "resilience.AutoResume",
        "restore-and-continue budget per AutoResume.run (default 3)"),
    # -- sharding -----------------------------------------------------------
    "MXNET_SHARDING": (
        "unported", f"sharding ({_9B})", "rule-based sharding subsystem"),
    "MXNET_SHARDING_RULES": (
        "unported", f"sharding.plan ({_9B})", "declarative partition rules"),
    "MXNET_SHARDING_UNMATCHED": (
        "unported", f"sharding.plan ({_9B})",
        "unmatched-parameter policy"),
    "MXNET_SHARDING_ZERO1": (
        "unported", f"sharding.zero1 ({_9B})",
        "ZeRO-1 weight-update sharding"),
    # -- engine and storage, caches, artifacts, autotune --------------------
    "MXNET_ENGINE_TYPE": (
        "wired", "engine.get",
        "ThreadedEngine (default: the native engine, csrc/engine.cc) | "
        "NaiveEngine (synchronous, inline); a native engine that does "
        "not build raises, it never falls back"),
    "MXNET_CPU_WORKER_NTHREADS": (
        "wired", "engine.Engine",
        "host worker threads of the engine (default: the CPU count); the "
        "IO lane and every other auxiliary lane take one each"),
    "MXNET_ENGINE_NUM_LANES": (
        "wired", "engine.Engine",
        "worker-pool lanes of the engine (default 2: compute and IO)"),
    "MXNET_CPU_PRIORITY_NTHREADS": (
        "accepted", "-", "torch orders work on the CUDA stream"),
    "MXNET_GPU_WORKER_NTHREADS": ("accepted", "-", "CUDA streams"),
    "MXNET_GPU_COPY_NTHREADS": (
        "accepted", "-", "DeviceFeed's side stream covers host copies"),
    "MXNET_ENGINE_OPENMP": ("accepted", "-", "torch owns intra-op threads"),
    "MXNET_OMP_MAX_THREADS": ("accepted", "-", "torch owns intra-op threads"),
    "MXNET_USE_SIGNAL_HANDLER": (
        "wired", "initialize",
        "crash tracebacks through faulthandler (default 1)"),
    "MXNET_CPU_MEM_POOL_DISABLE": (
        "wired", "storage",
        "1 bypasses the pooled host allocator (a plain buffer per "
        "allocation)"),
    "MXNET_GPU_MEM_POOL_RESERVE": (
        "wired", "storage",
        "percent of host memory the host pool leaves unpooled (the JAX "
        "package's reading: on the card torch's caching allocator owns "
        "the memory)"),
    "MXNET_GPU_MEM_POOL_TYPE": (
        "wired", "storage",
        "host-pool strategy: Naive (default) | Round | Unpooled (the JAX "
        "package's reading: on the card torch's caching allocator "
        "owns the memory)"),
    "MXNET_GPU_MEM_POOL_ROUND_LINEAR_CUTOFF": (
        "accepted", "-", "the CUDA caching allocator rounds"),
    "MXNET_GPU_MEM_LARGE_ALLOC_ROUND_SIZE": (
        "accepted", "-", "the CUDA caching allocator rounds"),
    "MXNET_COMPILE_CACHE": (
        "wired", "utils.compile_cache",
        "persistent program cache: the disk tier of the artifact layer "
        "(default 1); 0 disables it (programs are rebuilt per process)"),
    "MXNET_COMPILE_CACHE_DIR": (
        "wired", "utils.compile_cache / kernels._build",
        "directory of the program envelopes (default "
        "$MXNET_HOME/compile_cache) and, when set, of the kernel "
        "libraries (default build/mxnet_tpu_torch/)"),
    "MXNET_COMPILE_CACHE_MAX_MB": (
        "wired", "utils.compile_cache",
        "size cap on the program directory (default 1024, 0 = "
        "unbounded); oldest-used entries are pruned to 80%"),
    "MXNET_ARTIFACT_REMOTE": (
        "wired", "artifact.remote",
        "fleet-shared remote artifact-cache URL (file:///shared/dir or "
        "http(s)://host:port speaking GET/PUT /artifacts/<fp>); unset "
        "(default) = no remote tier"),
    "MXNET_ARTIFACT_REMOTE_PUBLISH": (
        "wired", "artifact.remote",
        "push locally built programs to the remote store (default 1)"),
    "MXNET_ARTIFACT_REMOTE_TIMEOUT_MS": (
        "wired", "artifact.remote",
        "per-request timeout of the http(s) remote backend (default "
        "2000)"),
    "MXNET_ARTIFACT_REMOTE_RETRIES": (
        "wired", "artifact.remote",
        "attempts per remote round trip (default 2, the retry policy)"),
    "MXNET_ARTIFACT_REMOTE_MAX_MB": (
        "wired", "artifact.remote",
        "byte bound on the remote store (default 512, 0 = unbounded)"),
    "MXNET_ARTIFACT_GC_MAX_AGE_S": (
        "wired", "artifact.remote",
        "age bound in seconds on remote-store entries (default 0 = "
        "none)"),
    "MXNET_ARTIFACT_GC_PROTECT": (
        "wired", "artifact.bundle",
        "os.pathsep-separated bundle paths whose fingerprints the "
        "remote store's GC never evicts"),
    "MXNET_AUTOTUNE": (
        "wired", "autotune",
        "0 (heuristics only) / consult (default: read TuningRecords) / "
        "tune (also allow autotune.tune() sweeps)"),
    "MXNET_AUTOTUNE_DIR": (
        "wired", "autotune.records",
        "directory of the TuningRecords (default $MXNET_HOME/autotune), "
        "one <fingerprint>.atr JSON file each"),
    "MXNET_AUTOTUNE_BUDGET_MS": (
        "wired", "autotune.tuner",
        "wall-clock budget of one autotune sweep, checked between "
        "candidates (default 60000, 0 = unbounded)"),
    "MXNET_EAGER_JIT": (
        "accepted", "ndarray.registry",
        "the port dispatches each op eagerly to torch; a hybridized block "
        "is the compiled path (CUDA graphs)"),
    "MXNET_EAGER_JIT_CACHE_SIZE": (
        "accepted", "ndarray.registry", "no dispatch executable cache"),
    "MXNET_EAGER_JIT_DONATE": (
        "accepted", "ndarray.registry", "no dispatch executable cache"),
    "MXNET_DISPATCH_EAGER_PERSIST": (
        "accepted", "ndarray.registry", "no dispatch executable cache"),
    "MXNET_SHAPE_BUCKETS": (
        "wired", "ndarray.registry / utils.compile_cache",
        "batch-axis bucketing of row-independent eager ops outside "
        "autograd.record(): 0 (default) / pow2 / mult:N; serving "
        "buckets are MXNET_SERVING_BUCKETS"),
    # -- everything else ----------------------------------------------------
    "MXNET_HOME": (
        "wired", "utils.compile_cache / autotune.records / "
        "gluon.model_zoo.model_store",
        "home of the program cache, the TuningRecords and the model "
        "store's models/ (default ~/.mxnet)"),
    "MXNET_GLUON_REPO": (
        "accepted", "gluon.model_zoo.model_store",
        "nothing is downloaded: a weight file is placed in the store "
        "by hand"),
    "MXNET_TEST_SEED": (
        "wired", "test_utils", "fixed seed for seeded tests (with_seed)"),
    "MXNET_INT64_TENSOR_SIZE": (
        "accepted", "-", "torch tensors always take 64-bit sizes"),
    "MXNET_ENFORCE_DETERMINISM": (
        "accepted", "-",
        "data pipelines keep input order; use torch's deterministic "
        "algorithms setting for kernels"),
    "MXNET_EXEC_BULK_EXEC_INFERENCE": (
        "accepted", "-", "a hybridized block replays one CUDA graph"),
    "MXNET_EXEC_BULK_EXEC_TRAIN": (
        "accepted", "-", "a hybridized block replays one CUDA graph"),
    "MXNET_EXEC_NUM_TEMP": ("accepted", "-", "the CUDA caching allocator"),
    "MXNET_EXEC_ENABLE_INPLACE": (
        "accepted", "-", "torch updates in place where MXNet would"),
    "MXNET_EXEC_MATCH_RANGE": ("accepted", "-", "the CUDA caching allocator"),
    "MXNET_EXEC_INPLACE_GRAD_SUM_CAP": ("accepted", "-", "torch autograd"),
    "MXNET_EXEC_VERBOSE_LOGGING": ("accepted", "-", "see the telemetry"),
    "MXNET_CUDNN_AUTOTUNE_LIMIT": ("accepted", "-", "cuDNN's own search"),
    "MXNET_CUDA_ALLOW_TENSOR_CORE": (
        "accepted", "-", "tensor cores always on; bf16 via AMP"),
    "MXNET_CUDA_TENSOR_OP_MATH_ALLOW_CONVERSION": (
        "accepted", "-", "bf16 casting is explicit (AMP op lists); TF32 "
        "stays off for float32 convolutions and GEMMs"),
    "MXNET_CUDA_LIB_CHECKING": ("accepted", "-", "torch checks its libs"),
    "MXNET_CUDNN_LIB_CHECKING": ("accepted", "-", "torch checks cuDNN"),
    "MXNET_MKLDNN_ENABLED": ("accepted", "-", "torch picks its CPU kernels"),
    "MXNET_MKLDNN_CACHE_NUM": ("accepted", "-", "torch picks its CPU kernels"),
    "MXNET_CPU_NNPACK_NTHREADS": ("accepted", "-", "no NNPACK"),
    "MXNET_CPU_TEMP_COPY": ("accepted", "-", "torch-owned"),
    "MXNET_GPU_PARALLEL_RAND_COPY": (
        "accepted", "random", "torch's Philox generator"),
    "MXNET_RANDOM_RESOURCE_POOL_SIZE": (
        "accepted", "random", "torch's Philox generator needs no pool"),
    "MXNET_SAFE_ACCUMULATION": (
        "accepted", "-", "reductions accumulate in float32"),
    "MXNET_MEMORY_OPT": ("accepted", "-", "the CUDA caching allocator"),
}


def get_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        logging.warning("invalid integer for %s; using %s", name, default)
        return int(default)


def get_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        logging.warning("invalid float for %s; using %s", name, default)
        return float(default)


def get_bool(name, default=False):
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


def get_str(name, default=None):
    """String knob read."""
    return os.environ.get(name, default)


def describe():
    lines = [f"{name:42s} {status:9s} {desc}"
             for name, (status, _, desc) in sorted(KNOBS.items())]
    return "\n".join(lines)


def check():
    """Warn about set but unrecognized ``MXNET_*`` variables."""
    unknown = [k for k in os.environ
               if k.startswith("MXNET_") and k not in KNOBS]
    for k in unknown:
        logging.warning("environment variable %s is not recognized by "
                        "mxnet_tpu_torch (see mxnet_tpu_torch.env."
                        "describe())", k)
    return unknown


def markdown_table():
    """``mxnet_tpu_torch/ENV_VARS.md``, generated from :data:`KNOBS` so
    the file cannot drift from the code (a test compares them).
    Regenerate with::

        python -m mxnet_tpu_torch.env > mxnet_tpu_torch/ENV_VARS.md
    """
    lines = [
        "# `MXNET_*` environment variables of `mxnet_tpu_torch`",
        "",
        "Generated from the knob registry in `mxnet_tpu_torch/env.py`; do "
        "not edit by hand. Regenerate with "
        "`python -m mxnet_tpu_torch.env > mxnet_tpu_torch/ENV_VARS.md`.",
        "",
        "Status **wired** = changes what the port does; **accepted** = "
        "recognized and intentionally a no-op on the card (torch, cuDNN "
        "or the CUDA caching allocator owns that concern); **unported** "
        "= its consumer is not ported yet, and the consumer column names "
        "the slice that brings it.",
        "",
        "| Variable | Status | Consumer | Description |",
        "| --- | --- | --- | --- |",
    ]
    for name, (status, consumer, desc) in sorted(KNOBS.items()):
        lines.append(f"| `{name}` | {status} | {consumer} | {desc} |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    import sys

    sys.stdout.write(markdown_table())
