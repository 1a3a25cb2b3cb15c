"""Attribute scoping for symbol composition (reference:
python/mxnet/attribute.py).

The PyTorch counterpart of ``mxnet_tpu/attribute.py``.

``with AttrScope(ctx_group='dev1'):`` stamps every symbol created inside
the block with the scope's attributes (merged over enclosing scopes,
inner wins). The reference uses this for ctx_group placement,
``__wd_mult__``/``__lr_mult__`` per-layer hyperparameters, and mirroring
hints — all of which ride on symbol attrs in the exported JSON.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_scope = threading.local()


def current():
    """The innermost active scope (an empty root if none entered)."""
    stack = getattr(_scope, "stack", None)
    if not stack:
        _scope.stack = stack = [AttrScope()]
    return stack[-1]


class AttrScope:
    """A dict of symbol attributes applied to nodes created in-scope
    (reference: attribute.py AttrScope)."""

    def __init__(self, **attrs):
        for k, v in attrs.items():
            if not isinstance(v, str):
                raise ValueError(
                    f"AttrScope values must be strings; got {k}={v!r}")
        self._attrs = attrs
        self._merged = None  # set on __enter__: parent attrs + own

    def get(self, attrs=None):
        """Scope attributes merged with explicit `attrs` (explicit wins,
        matching the reference's update order)."""
        base = dict(self._merged if self._merged is not None
                    else self._attrs)
        if attrs:
            base.update(attrs)
        return base

    def __enter__(self):
        if not getattr(_scope, "stack", None):
            _scope.stack = [AttrScope()]
        parent = _scope.stack[-1]
        self._merged = parent.get(self._attrs)
        _scope.stack.append(self)
        return self

    def __exit__(self, *exc):
        _scope.stack.pop()
        self._merged = None
