"""Random state: one ``torch.Generator`` per device.

The PyTorch counterpart of ``mxnet_tpu/random.py`` (reference:
python/mxnet/random.py; src/resource.cc:174-198 per-context seeding).
Where the JAX package splits a threefry key, the port keeps an explicit
``torch.Generator`` per device, seeded by :func:`seed`. The two streams
never agree, so tests carry weights across instead of re-drawing them.

The samplers (``uniform`` ... ``multinomial``, ``mxnet_tpu/random.py:
164-208``) are thin over the registered ``random_*``/``sample_*`` ops.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "device_generator", "draws", "uniform",
           "normal", "randn", "randint", "exponential", "poisson", "gamma",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]

# guards: _SEED, _GENERATORS
_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS = {}  # torch.device -> torch.Generator
_DRAWS = [0]  # calls of generator(): the random ops' draws, all devices


def seed(seed_state, ctx="all"):
    """Seed the generator of one context, or of every device
    (``ctx="all"``, the default): generators made later start from the
    same seed. A generator that exists is re-seeded in place, so a CUDA
    graph that registered it replays the seeded stream."""
    with _LOCK:
        if ctx == "all":
            _SEED[0] = int(seed_state)
            for gen in _GENERATORS.values():
                gen.manual_seed(int(seed_state))
            return
        dev = ctx.torch_device if hasattr(ctx, "torch_device") else \
            torch.device(ctx)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        gen = _GENERATORS.get(dev)
        if gen is None:
            _GENERATORS[dev] = torch.Generator(device=dev).manual_seed(
                int(seed_state))
        else:
            gen.manual_seed(int(seed_state))


def generator(device):
    """The generator for ``device`` (a ``torch.device``), made from the
    global seed at first use. Each call counts as a draw (:func:`draws`):
    random ops call it once per draw."""
    with _LOCK:
        _DRAWS[0] += 1
    return device_generator(device)


def device_generator(device):
    """:func:`generator` without counting a draw (for code that holds the
    generator without drawing, as a graph capture registers it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(_SEED[0])
            _GENERATORS[device] = gen
        return gen

def draws():
    """How many times a random op has taken a generator (every device):
    a forward that draws nothing leaves it unchanged."""
    with _LOCK:
        return _DRAWS[0]


# -- samplers (``mx.random.*``, also ``mx.nd.random.*``) ---------------------

def _op(name, out=None, **kwargs):
    from .ndarray import NDArray, registry

    r = registry.invoke(registry.get_op(name), (), kwargs)
    if out is None:
        return r
    with torch.no_grad():
        out.data.copy_(r.data if isinstance(r, NDArray) else r)
    return out


def uniform(low=0, high=1, shape=(1,), dtype="float32", ctx=None, out=None):
    return _op("random_uniform", out, low=low, high=high, shape=shape,
               dtype=dtype, ctx=ctx)


def normal(loc=0, scale=1, shape=(1,), dtype="float32", ctx=None, out=None):
    return _op("random_normal", out, loc=loc, scale=scale, shape=shape,
               dtype=dtype, ctx=ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None):
    return _op("random_randint", out, low=low, high=high, shape=shape,
               dtype=dtype, ctx=ctx)


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    return _op("random_exponential", out, lam=1.0 / scale, shape=shape,
               dtype=dtype, ctx=ctx)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    return _op("random_poisson", out, lam=lam, shape=shape, dtype=dtype,
               ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None):
    return _op("random_gamma", out, alpha=alpha, beta=beta, shape=shape,
               dtype=dtype, ctx=ctx)


def negative_binomial(k=1, p=1, shape=(1,), dtype="float32", ctx=None,
                      out=None):
    return _op("random_negative_binomial", out, k=k, p=p, shape=shape,
               dtype=dtype, ctx=ctx)


def generalized_negative_binomial(mu=1, alpha=1, shape=(1,), dtype="float32",
                                  ctx=None, out=None):
    return _op("random_generalized_negative_binomial", out, mu=mu,
               alpha=alpha, shape=shape, dtype=dtype, ctx=ctx)


def multinomial(data, shape=(1,), get_prob=False, dtype="int32"):
    from .ndarray import registry

    return registry.invoke(registry.get_op("sample_multinomial"), (data,),
                           {"shape": shape, "get_prob": get_prob,
                            "dtype": dtype})


def shuffle(data):
    from .ndarray import registry

    return registry.invoke(registry.get_op("shuffle"), (data,), {})
