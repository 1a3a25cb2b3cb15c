"""Automatic symbol naming.

The PyTorch counterpart of ``mxnet_tpu/name.py`` (reference:
python/mxnet/name.py). A symbol node without an explicit name gets
``{hint}{n}`` from the innermost manager's per-hint counter. Not ported
yet: the ``Prefix`` manager.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "current"]

_scope = threading.local()


def current():
    """The innermost active manager (a default one if none entered)."""
    stack = getattr(_scope, "stack", None)
    if not stack:
        _scope.stack = stack = [NameManager()]
    return stack[-1]


class NameManager:
    """Counter-based auto-namer and a re-entrant ``with`` scope."""

    def __init__(self):
        self._counts = {}

    def get(self, name, hint):
        """``name`` if given, else the next ``{hint}{n}``."""
        if name:
            return name
        n = self._counts.get(hint, 0)
        self._counts[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        current()  # make sure the default manager sits at the bottom
        _scope.stack.append(self)
        return self

    def __exit__(self, *exc):
        _scope.stack.pop()

