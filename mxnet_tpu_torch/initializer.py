"""Weight initializers.

The PyTorch counterpart of ``mxnet_tpu/initializer.py:21-260``
(reference: python/mxnet/initializer.py): an :class:`Initializer`
dispatches on the parameter name's suffix (``weight``, ``bias``,
``gamma``, ``beta``, the moving statistics) or on an ``__init__``
attribute of its :class:`InitDesc`, and fills the parameter's tensor in
place. Random draws come from the per-device ``torch.Generator`` of
:mod:`.random`; they never match the JAX package's draws, so parity
tests carry weights across.
"""
from __future__ import annotations

import json
import math
import re

import torch

from . import random as _random

__all__ = ["Initializer", "InitDesc", "Uniform", "Normal", "Xavier",
           "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias", "Mixed", "One",
           "Zero", "Constant", "register", "create"]


class InitDesc(str):
    """A parameter's name with its attributes (reference: initializer.py
    InitDesc): ``attrs["__init__"]`` names an initializer that takes
    precedence over the suffix rules."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one"}


def register(klass):
    """Register an initializer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from an instance, a registered name, or the JSON
    ``[name, kwargs]`` that :meth:`Initializer.dumps` writes."""
    if isinstance(name, Initializer):
        return name
    if name.startswith("["):
        name, kwargs = json.loads(name)
    key = name.lower()
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(f"initializer {name!r} not registered; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class Initializer:
    """Base initializer; dispatches on the parameter-name suffix like the
    reference (initializer.py Initializer.__call__:155-200)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        """Fill ``arr`` (an NDArray) for the parameter ``desc`` (a name or
        an :class:`InitDesc`)."""
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        t = arr.data
        with torch.no_grad():
            init = desc.attrs.get("__init__", "")
            if init:
                create(init)._init_weight(desc, t)
            elif desc.endswith("weight"):
                self._init_weight(desc, t)
            elif desc.endswith("bias"):
                self._init_bias(desc, t)
            elif desc.endswith("gamma"):
                self._init_gamma(desc, t)
            elif desc.endswith("beta"):
                self._init_beta(desc, t)
            elif desc.endswith(("running_mean", "moving_mean", "min",
                                "max")):
                t.zero_()
            elif desc.endswith(("running_var", "moving_var")):
                t.fill_(1.0)
            else:
                self._init_default(desc, t)

    def _init_weight(self, desc, t):
        raise NotImplementedError("virtual _init_weight")

    def _init_bias(self, desc, t):
        t.zero_()

    def _init_gamma(self, desc, t):
        t.fill_(1.0)

    def _init_beta(self, desc, t):
        t.zero_()

    def _init_default(self, desc, t):
        self._init_weight(desc, t)

    def dumps(self):
        """``[name, kwargs]`` as JSON (reference: Initializer.dumps)."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Uniform(Initializer):
    """U(-scale, scale); MXNet's default initializer."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, t):
        t.uniform_(-self.scale, self.scale,
                   generator=_random.generator(t.device))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, t):
        t.normal_(0.0, self.sigma, generator=_random.generator(t.device))


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, t):
        t.fill_(self.value)


@register
class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)
        self._kwargs = {}


@register
class One(Constant):
    def __init__(self):
        super().__init__(1.0)
        self._kwargs = {}


@register
class Xavier(Initializer):
    """Xavier/Glorot: U(-s, s) or N(0, s) with s = sqrt(magnitude /
    factor), the factor being fan-in, fan-out or their mean (reference:
    initializer.py Xavier, rnd_type/factor_type/magnitude)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError(f"Xavier: unknown rnd_type {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError(f"Xavier: unknown factor_type {factor_type!r}")
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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


@register
class MSRAPrelu(Xavier):
    """He initialization for PReLU nets: Xavier gaussian with magnitude
    2 / (1 + slope^2) (reference: initializer.py MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """An orthogonal matrix (the SVD of a random one) times ``scale``
    (reference: initializer.py Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, t):
        nout, nin = t.shape[0], math.prod(t.shape[1:])
        gen = _random.generator(t.device)
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        t.copy_((self.scale * q).reshape(t.shape))


@register
class Bilinear(Initializer):
    """Bilinear upsampling weights for a deconvolution (reference:
    initializer.py Bilinear)."""

    def _init_weight(self, desc, t):
        shape = t.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(shape[3], dtype=torch.float64)
        y = torch.arange(shape[2], dtype=torch.float64)
        plane = (1 - torch.abs(y[:, None] / f - c)) * \
            (1 - torch.abs(x[None, :] / f - c))
        t.copy_(plane.to(torch.float32).expand(shape))


@register
class LSTMBias(Initializer):
    """Zeros but ``forget_bias`` on the forget gate's quarter (reference:
    initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, t):
        t.zero_()
        n = t.shape[0] // 4
        t[n:2 * n] = self.forget_bias

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class Mixed(Initializer):
    """The first initializer whose pattern matches the name (reference:
    initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            [create(i) for i in initializers]))

    def __call__(self, desc, arr):
        for prog, init in self.map:
            if prog.match(str(desc)):
                init(desc, arr)
                return
        raise ValueError(f"parameter {desc} did not match any pattern")
