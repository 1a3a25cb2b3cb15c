"""Random sampling ops.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_random.py``
(reference: src/operator/random/sample_op.cc, multisample_op.cc,
sample_multinomial_op.cc). Every draw takes the device's
``torch.Generator`` from ``mx.random`` (``random.generator``) and passes
it explicitly, so a CUDA graph that registered that generator (as a
hybridized block's does) draws fresh numbers at each replay, and
``mx.random.seed`` makes the draws repeat.

Threefry (the JAX package) and Philox (torch on CUDA) never agree, so
these ops match the JAX package in distribution, not in values. Torch's
gamma samplers take no generator, so gamma draws (and the negative
binomials, gamma-Poisson mixtures) use Marsaglia and Tsang's method on
the generator's own normal and uniform draws, in a fixed number of rounds
(no loop that waits on the data, so they can be captured).
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..context import resolve_device
from .ndarray import torch_dtype
from .registry import register

# Marsaglia-Tsang accepts at least 95% of its candidates for alpha >= 1,
# so all of 8 rounds rejected has a chance under 0.05^8 = 4e-11 per
# value; such a value keeps the last round's candidate
_GAMMA_ROUNDS = 8


def _draw(ctx):
    dev = resolve_device(ctx)
    return dev, _random.generator(dev)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dt(dtype):
    return torch_dtype(dtype or "float32")


def _gamma(alpha, shape, dev, gen):
    """Gamma(alpha, 1) draws of ``shape`` in float32 (Marsaglia and Tsang,
    2000; alpha < 1 through Gamma(alpha + 1) * U^(1 / alpha))."""
    a = alpha + 1.0 if alpha < 1 else float(alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    z = torch.randn((_GAMMA_ROUNDS,) + shape, device=dev, generator=gen)
    u = torch.rand((_GAMMA_ROUNDS,) + shape, device=dev, generator=gen)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = torch.where(ok.any(0), ok.to(torch.uint8).argmax(0),
                        _GAMMA_ROUNDS - 1)
    x = d * v.clamp_min(1e-30).gather(0, first.unsqueeze(0))[0]
    if alpha < 1:
        x = x * torch.rand(shape, device=dev, generator=gen) ** (1.0 / alpha)
    return x


@register(differentiable=False)
def random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None):
    """U(low, high) draws of ``shape`` (reference: sample_op.cc uniform)."""
    dev, gen = _draw(ctx)
    u = torch.rand(_shape(shape), device=dev, generator=gen,
                   dtype=_dt(dtype))
    return u * (high - low) + low


@register(differentiable=False)
def random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None):
    """N(loc, scale^2) draws of ``shape`` (reference: sample_op.cc
    normal)."""
    dev, gen = _draw(ctx)
    return torch.randn(_shape(shape), device=dev, generator=gen,
                       dtype=_dt(dtype)) * scale + loc


@register(differentiable=False)
def random_randint(low=0, high=1, shape=(1,), dtype="int32", ctx=None):
    """Integers in [low, high) of ``shape`` (reference: sample_op.cc
    randint)."""
    dev, gen = _draw(ctx)
    return torch.randint(int(low), int(high), _shape(shape), device=dev,
                         generator=gen, dtype=_dt(dtype))


@register(differentiable=False)
def random_exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    """Exp(lam) draws (rate ``lam``) of ``shape`` (reference:
    sample_op.cc exponential)."""
    dev, gen = _draw(ctx)
    return torch.empty(_shape(shape), device=dev).exponential_(
        float(lam), generator=gen).to(_dt(dtype))


@register(differentiable=False)
def random_poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    """Poisson(lam) draws of ``shape`` (reference: sample_op.cc
    poisson)."""
    dev, gen = _draw(ctx)
    rates = torch.full(_shape(shape), float(lam), device=dev)
    return torch.poisson(rates, generator=gen).to(_dt(dtype))


@register(differentiable=False)
def random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None):
    """Gamma(alpha, scale beta) draws of ``shape`` (reference: sample_op.cc
    gamma)."""
    dev, gen = _draw(ctx)
    return (_gamma(float(alpha), _shape(shape), dev, gen)
            * beta).to(_dt(dtype))


def _gamma_poisson(k, p, shape, dtype, ctx):
    dev, gen = _draw(ctx)
    shape = _shape(shape)
    lam = _gamma(float(k), shape, dev, gen) * ((1.0 - p) / p)
    return torch.poisson(lam, generator=gen).to(_dt(dtype))


@register(differentiable=False)
def random_negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32",
                             ctx=None):
    """NB(k, p) draws of ``shape``: failures before the k-th success, as
    a gamma-Poisson mixture (reference: sample_op.cc negative_binomial)."""
    return _gamma_poisson(k, p, shape, dtype, ctx)


@register(differentiable=False)
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                         dtype="float32", ctx=None):
    """Generalized NB(mu, alpha) draws of ``shape`` (mean ``mu``,
    dispersion ``alpha``), a gamma-Poisson mixture (reference:
    sample_op.cc generalized_negative_binomial)."""
    k = 1.0 / alpha
    return _gamma_poisson(k, k / (k + mu), shape, dtype, ctx)


@register(differentiable=False)
def random_gumbel(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None):
    """Gumbel(loc, scale) draws of ``shape``: -log(-log U)."""
    dev, gen = _draw(ctx)
    u = torch.rand(_shape(shape), device=dev, generator=gen)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u)) * scale + loc).to(_dt(dtype))


# -- sample_*: a distribution per parameter row (multisample_op.cc) ---------

def _per_row(param, shape):
    """``param`` reshaped to broadcast over draws of ``shape`` per
    value."""
    return param.reshape(tuple(param.shape) + (1,) * len(shape))


@register(differentiable=False)
def sample_uniform(low, high, shape=(), dtype="float32"):
    """Draws of ``shape`` from U(low_i, high_i) for every parameter value
    (reference: multisample_op.cc)."""
    shape = _shape(shape)
    u = torch.rand(tuple(low.shape) + shape, device=low.device,
                   generator=_random.generator(low.device), dtype=_dt(dtype))
    lo = _per_row(low, shape)
    return lo + u * (_per_row(high, shape) - lo)


@register(differentiable=False)
def sample_normal(mu, sigma, shape=(), dtype="float32"):
    """Draws of ``shape`` from N(mu_i, sigma_i^2) for every parameter
    value (reference: multisample_op.cc)."""
    shape = _shape(shape)
    z = torch.randn(tuple(mu.shape) + shape, device=mu.device,
                    generator=_random.generator(mu.device), dtype=_dt(dtype))
    return _per_row(mu, shape) + z * _per_row(sigma, shape)


@register(differentiable=False)
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Class draws from probabilities ``data`` ((k,) or (batch, k), not
    necessarily normalized): ``shape`` draws per row, by the inverse of
    the cumulative sum at uniform draws; with ``get_prob`` also each
    draw's log-probability (reference: sample_multinomial_op.cc)."""
    shape = _shape(shape) if shape else ()
    n = 1
    for s in shape:
        n *= int(s) if s else 1
    k = data.shape[-1]
    rows = data.reshape(-1, k).float()
    cdf = torch.cumsum(rows, dim=-1)
    u = torch.rand((rows.shape[0], n), device=data.device,
                   generator=_random.generator(data.device)) * cdf[:, -1:]
    idx = torch.searchsorted(cdf, u, right=True).clamp_max(k - 1)
    lead = tuple(data.shape[:-1])
    out = idx.reshape(lead + shape).to(_dt(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(rows.clamp_min(1e-38)), dim=-1)
    return out, torch.gather(logp, 1, idx).reshape(lead + shape)
