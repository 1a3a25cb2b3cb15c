"""mxnet_tpu_torch.analysis — graph verification and the graph optimizer.

The PyTorch counterpart of ``mxnet_tpu/analysis``, cut to the symbol
graph path: the verifier passes and their fact cache (``passes``,
``diagnostics``), the rewrite pipeline ``optimize_symbol``
(``graph_opt``: fold, cse, transpose elision, fusion, dce, gated by
``MXNET_GRAPH_OPT``), the fusion clustering pass (``fusion``) and the
int8 quantization passes (``quantize``). Trace verification, donation
and sharding checks come with the slices that need them.
"""
from __future__ import annotations

from .diagnostics import (CODES, Diagnostic, DiagnosticReport,
                          GraphVerifyError, SEV_ERROR, SEV_WARNING,
                          verify_mode)
from .passes import (FactError, PASSES, PassContext, register_fact,
                     run_passes)
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
    "SEV_ERROR", "SEV_WARNING", "verify_mode",
    "FactError", "PASSES", "PassContext", "register_fact", "run_passes",
    "AnalysisPass", "RewritePass", "PassManager", "PIPELINE_VERSION",
    "DEFAULT_REWRITE_PIPELINE", "REWRITE_PASSES", "opt_level",
    "optimize_symbol", "op_is_pure", "graph_opt_counters",
    "reset_graph_opt_counters", "quantize", "quantize_counters",
    "reset_quantize_counters",
]
