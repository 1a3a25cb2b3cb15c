"""Structured diagnostics of the graph verifier.

The PyTorch counterpart of ``mxnet_tpu/analysis/diagnostics.py``: every
verifier pass emits :class:`Diagnostic` records (code, severity, node,
message, fix hint) into a :class:`DiagnosticReport` instead of stopping
at the first problem. The graph optimizer compares the error count of
a graph's report before and after rewriting, and serves the original
graph when a rewrite added an error.

Not ported yet: the ``MXNET_GRAPH_VERIFY`` disposition (log or raise,
``GraphVerifyError``) and its counters, which gate the executor's bind
(the symbolic-graph slice).
"""
from __future__ import annotations

__all__ = ["Diagnostic", "DiagnosticReport", "CODES", "SEV_ERROR",
           "SEV_WARNING"]

SEV_ERROR = "error"
SEV_WARNING = "warning"

# code -> (default severity, title): GV1xx shape/dtype inference, GV4xx
# graph structure (the codes the ported passes emit)
CODES = {
    "GV101": (SEV_ERROR, "shape mismatch"),
    "GV102": (SEV_ERROR, "dtype mismatch"),
    "GV401": (SEV_WARNING, "dead node / unused output"),
    "GV403": (SEV_ERROR, "duplicate node name"),
}


class Diagnostic:
    """One finding: code, severity, where, what and how to fix it."""

    __slots__ = ("code", "severity", "node", "message", "hint")

    def __init__(self, code, message, node=None, hint=None, severity=None):
        if code not in CODES:
            raise ValueError(f"unknown diagnostic code {code!r}")
        self.code = code
        self.severity = severity or CODES[code][0]
        self.node = node
        self.message = message
        self.hint = hint

    def __repr__(self):
        loc = f" at {self.node}" if self.node else ""
        hint = f" (hint: {self.hint})" if self.hint else ""
        return (f"[{self.code} {self.severity}] "
                f"{CODES[self.code][1]}{loc}: {self.message}{hint}")


class DiagnosticReport:
    """Ordered diagnostics from one verification run."""

    def __init__(self, subject=None):
        self.subject = subject
        self._diags = []

    def emit(self, code, message, node=None, hint=None, severity=None):
        self._diags.append(Diagnostic(code, message, node=node, hint=hint,
                                      severity=severity))
        return self._diags[-1]

    def __iter__(self):
        return iter(self._diags)

    def __len__(self):
        return len(self._diags)

    def __bool__(self):
        return bool(self._diags)

    @property
    def errors(self):
        return [d for d in self._diags if d.severity == SEV_ERROR]
