"""Weight initializers.

The PyTorch counterpart of ``mxnet_tpu/initializer.py`` (reference:
python/mxnet/initializer.py): an :class:`Initializer` dispatches on the
parameter name's suffix (``weight``, ``bias``, ``gamma``, ``beta``) and
fills the parameter's tensor in place. Random draws come from the
per-device ``torch.Generator`` of :mod:`.random`; they never match the
JAX package's threefry draws, so parity tests carry weights across.
"""
from __future__ import annotations

import math

import torch

from . import random as _random

__all__ = ["Initializer", "Uniform", "Xavier", "One", "Zero", "Constant",
           "create"]


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


class Xavier(Initializer):
    """Xavier/Glorot: U(-s, s) or N(0, s) with s = sqrt(magnitude /
    factor), the factor being fan-in, fan-out or their mean (reference:
    initializer.py Xavier, rnd_type/factor_type/magnitude)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError(f"Xavier: unknown rnd_type {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError(f"Xavier: unknown factor_type {factor_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, t):
        shape = tuple(t.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {shape} for "
                             f"{desc}")
        hw_scale = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        gen = _random.generator(t.device)
        if self.rnd_type == "uniform":
            t.uniform_(-scale, scale, generator=gen)
        else:
            t.normal_(0.0, scale, generator=gen)

    def __repr__(self):
        return (f"Xavier(rnd_type={self.rnd_type!r}, factor_type="
                f"{self.factor_type!r}, magnitude={self.magnitude})")


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


_BY_NAME = {"uniform": Uniform, "xavier": Xavier, "constant": Constant,
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
