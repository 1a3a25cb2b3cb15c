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

__all__ = ["seed", "generator"]

# guards: _SEED, _GENERATORS
_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS = {}  # torch.device -> torch.Generator


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
    global seed at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(_SEED[0])
            _GENERATORS[device] = gen
        return gen
