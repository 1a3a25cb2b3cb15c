"""Random state: one ``torch.Generator`` per device.

The PyTorch counterpart of ``mxnet_tpu/random.py`` (reference:
python/mxnet/random.py; src/resource.cc:174-198 per-context seeding).
Where the JAX package splits a threefry key, the port keeps an explicit
``torch.Generator`` per device, seeded by :func:`seed`. The two streams
never agree, so tests carry weights across instead of re-drawing them.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "device_generator", "draws"]

# guards: _SEED, _GENERATORS
_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS = {}  # torch.device -> torch.Generator
_DRAWS = [0]  # calls of generator(): the random ops' draws, all devices


def seed(seed_state, ctx="all"):
    """Seed the generator of one context, or of every device
    (``ctx="all"``, the default): generators made later start from the
    same seed."""
    with _LOCK:
        if ctx == "all":
            _SEED[0] = int(seed_state)
            _GENERATORS.clear()
            return
        dev = ctx.torch_device if hasattr(ctx, "torch_device") else \
            torch.device(ctx)
        _GENERATORS[dev] = torch.Generator(device=dev).manual_seed(
            int(seed_state))


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
