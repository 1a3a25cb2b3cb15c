"""Structured diagnostics of the graph verifier.

The PyTorch counterpart of ``mxnet_tpu/analysis/diagnostics.py``: every
verifier pass emits :class:`Diagnostic` records (code, severity, node,
message, fix hint) into a :class:`DiagnosticReport` instead of stopping
at the first problem. The graph optimizer compares the error count of
a graph's report before and after rewriting, and serves the original
graph when a rewrite added an error.

``MXNET_GRAPH_VERIFY`` (:func:`verify_mode`) decides what a bind does
with a report (:meth:`DiagnosticReport.disposition`): nothing (``off``,
the default), log it (``warn``) or raise :class:`GraphVerifyError`
(``error``). Not ported yet: its counters.
"""
from __future__ import annotations

import logging

from ..base import MXNetError, getenv

__all__ = ["Diagnostic", "DiagnosticReport", "GraphVerifyError", "CODES",
           "SEV_ERROR", "SEV_WARNING", "verify_mode"]

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

    def disposition(self, mode=None):
        """Log (``warn``) or raise (``error``) the report's diagnostics
        as ``MXNET_GRAPH_VERIFY`` says; returns the report."""
        mode = mode or verify_mode()
        if mode == "off" or not self._diags:
            return self
        if mode == "error":
            raise GraphVerifyError(self)
        for d in self._diags:
            logging.warning("graph-verify %r", d)
        return self


class GraphVerifyError(MXNetError):
    """A verification report under ``MXNET_GRAPH_VERIFY=error``."""

    def __init__(self, report):
        self.report = report
        super().__init__(f"graph verification of {report.subject} found "
                         f"{len(report)} diagnostic(s): {list(report)}")


def verify_mode():
    """``MXNET_GRAPH_VERIFY``: ``off`` (0, the default), ``warn`` (1 or
    anything else) or ``error`` (2, raise)."""
    raw = str(getenv("MXNET_GRAPH_VERIFY", "0")).strip().lower()
    if raw in ("", "0", "off", "false", "none"):
        return "off"
    if raw in ("error", "raise", "2"):
        return "error"
    return "warn"
