"""Weight initializers.

The PyTorch counterpart of ``mxnet_tpu/initializer.py`` (reference:
python/mxnet/initializer.py): an :class:`Initializer` dispatches on the
parameter name's suffix (``weight``, ``bias``, ``gamma``, ``beta``) and
fills the parameter's tensor in place. Random draws come from the
per-device ``torch.Generator`` of :mod:`.random`; they never match the
JAX package's threefry draws, so parity tests carry weights across.
"""
from __future__ import annotations

import torch

from . import random as _random

__all__ = ["Initializer", "Uniform", "One", "Zero", "Constant", "create"]


class Initializer:
    """Base initializer; dispatches on the parameter-name suffix like
    the reference (initializer.py Initializer.__call__:155-200)."""

    def __call__(self, desc, arr):
        """Fill ``arr`` (an NDArray) for the parameter named ``desc``."""
        desc = str(desc)
        t = arr.data
        with torch.no_grad():
            if desc.endswith("weight"):
                self._init_weight(desc, t)
            elif desc.endswith(("bias", "beta", "running_mean")):
                t.zero_()
            elif desc.endswith(("gamma", "running_var")):
                t.fill_(1.0)
            else:
                self._init_weight(desc, t)

    def _init_weight(self, desc, t):
        raise NotImplementedError("virtual _init_weight")

    def __repr__(self):
        return f"{type(self).__name__}()"


class Uniform(Initializer):
    """U(-scale, scale); MXNet's default initializer."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, desc, t):
        t.uniform_(-self.scale, self.scale,
                   generator=_random.generator(t.device))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, desc, t):
        t.fill_(self.value)


class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


class One(Constant):
    def __init__(self):
        super().__init__(1.0)


_BY_NAME = {"uniform": Uniform, "constant": Constant,
            "zero": Zero, "zeros": Zero, "one": One, "ones": One}


def create(name, **kwargs):
    """An initializer from an instance or a registered name."""
    if isinstance(name, Initializer):
        return name
    try:
        return _BY_NAME[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"initializer {name!r} not registered; known: "
                         f"{sorted(_BY_NAME)}") from None
