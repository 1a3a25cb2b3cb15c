"""mxnet_tpu_torch.analysis — graph verification and the graph optimizer.

The PyTorch counterpart of ``mxnet_tpu/analysis``, cut to the symbol
graph path: the verifier passes and their fact cache (``passes``,
``diagnostics``), the rewrite pipeline ``optimize_symbol``
(``graph_opt``: fold, cse, transpose elision, fusion, dce, gated by
``MXNET_GRAPH_OPT``), the fusion clustering pass (``fusion``) and the
int8 quantization passes (``quantize``); the execution-trace front end
(``record_trace`` + ``verify_trace``: random-stream reuse, in-place
writes into saved tensors, dead values), run on ``hybridize`` under
``MXNET_GRAPH_VERIFY``, and the in-place write guards of the dispatch
and the Trainer (``donation``). Sharding checks come with slice 9b.
"""
from __future__ import annotations

from .diagnostics import (CODES, Diagnostic, DiagnosticReport,
                          GraphVerifyError, SEV_ERROR, SEV_WARNING,
                          counters, reset_counters, verify_mode)
from .donation import check_dispatch_donation, check_param_donation
from .events import (GraphTrace, OpEvent, TRACE_PASSES, record_trace,
                     verify_trace)
from .passes import (FactError, PASSES, PassContext, register_fact,
                     run_passes, verify_symbol)
from .graph_opt import (AnalysisPass, DEFAULT_REWRITE_PIPELINE,
                        PIPELINE_VERSION, PassManager, REWRITE_PASSES,
                        RewritePass, op_is_pure, opt_level, optimize_symbol)
from .graph_opt import counters as graph_opt_counters
from .graph_opt import reset_counters as reset_graph_opt_counters
from . import quantize
from .quantize import counters as quantize_counters
from .quantize import reset_counters as reset_quantize_counters

__all__ = [
    "CODES", "Diagnostic", "DiagnosticReport", "GraphVerifyError",
    "SEV_ERROR", "SEV_WARNING", "verify_mode", "counters",
    "reset_counters", "check_dispatch_donation", "check_param_donation",
    "GraphTrace", "OpEvent", "TRACE_PASSES", "record_trace", "verify_trace",
    "verify_symbol", "verify_block_call",
    "FactError", "PASSES", "PassContext", "register_fact", "run_passes",
    "AnalysisPass", "RewritePass", "PassManager", "PIPELINE_VERSION",
    "DEFAULT_REWRITE_PIPELINE", "REWRITE_PASSES", "opt_level",
    "optimize_symbol", "op_is_pure", "graph_opt_counters",
    "reset_graph_opt_counters", "quantize", "quantize_counters",
    "reset_quantize_counters",
]


def verify_block_call(block, args, subject=None):
    """Verify a (to-be-hybridized) block by recording one paused eager
    forward and running the trace passes. Returns the undispositioned
    report; the hybridize hook dispositions it per MXNET_GRAPH_VERIFY.

    The verification forward is throwaway: every generator's state (so
    arming the verifier never shifts the draws of a seeded run) and every
    parameter's values (a training-mode forward moves batch norm's
    running statistics) are restored after it."""
    import torch

    from .. import autograd
    from .. import random as _mxrandom

    params = getattr(block, "collect_params", None)
    if params is not None and any(p._ndarray is None
                                  for _, p in params().items()):
        # finish deferred initialization first, on the real stream: its
        # draws would happen anyway
        with autograd.pause(train_mode=autograd.is_training()):
            block.forward(*args)
    with _mxrandom._LOCK:
        gens = list(_mxrandom._GENERATORS.values())
    saved_gens = [(g, g.get_state()) for g in gens]
    saved_params = []
    if params is not None:
        saved_params = [(p._ndarray._data, p._ndarray._data.detach().clone())
                        for _, p in params().items()
                        if p._ndarray is not None]
    try:
        with record_trace(subject=subject or type(block).__name__) as trace:
            with autograd.pause(train_mode=autograd.is_training()):
                out = block.forward(*args)
    finally:
        for g, st in saved_gens:
            g.set_state(st)
        with torch.no_grad():
            for data, copy in saved_params:
                data.copy_(copy)
    outs = out if isinstance(out, (list, tuple)) else [out]
    flat = []
    for o in outs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    trace.mark_outputs(flat)
    return verify_trace(trace)
