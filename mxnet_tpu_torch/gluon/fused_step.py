"""The Trainer's fused step: one function over a whole parameter group.

The PyTorch counterpart of ``mxnet_tpu/gluon/fused_step.py``. The eager
``Trainer.step`` is host-driven: one update per parameter, and under AMP
a host read of the all-finite flag (``LossScaler.has_overflow``) before
it. The JAX package compiles the whole weight update into one XLA
executable per parameter-group signature; here that is one step
function per signature, built once and kept in a bounded LRU
(``MXNET_FUSED_STEP_CACHE_SIZE``, default 16), which updates every
parameter of the group on the device:

- the optimizer's ``_fused_kernel`` over lists of tensors (torch's
  multi-tensor ``_foreach_*`` ops for SGD, NAG, Adam, signSGD and
  Signum; per tensor for the others), one call per group of parameters
  that share a learning rate and a weight decay, half weights through
  their float32 masters (multi-precision);
- with a loss scaler: the all-finite check over the raw gradients
  (torch's multi-tensor non-finite check, with an unscale by 1, which
  leaves the gradients' bits alone), the division by the current scale
  inside the rescale, and the scale's growth or back-off and the skip
  count. A skipped step leaves weights, states and the update count
  bitwise unchanged, as ``lax.cond`` does (``fused_step.py:362``): the
  new values are selected against the old per tensor.

The step reads its hyperparameters from device tensors: the learning
rates and weight decays (one per group), the rescale (1/batch_size),
and the step state (update count, scale, clean-step count, skip count),
so ``set_learning_rate``, an lr scheduler and the scale's motion never
rebuild it. On a CUDA device the Trainer captures the step as one CUDA
graph per signature and replays it each step (the gradients live in
persistent buffers, parameters and states are updated in place, so the
addresses are static); on the CPU the same function runs uncaptured.

``MXNET_FUSED_STEP=0`` runs the Trainer's eager per-parameter loop
instead. ``MXNET_FUSED_STEP_DONATE`` is accepted and changes nothing:
the JAX package donates buffers to XLA, and torch updates in place.
Counters: :func:`fused_step_stats`.
"""
from __future__ import annotations

import collections
import threading
import weakref

import torch

from ..base import getenv

__all__ = ["fused_step_enabled", "donate_params_enabled", "fused_step_stats",
           "reset_fused_step_cache", "build_step"]


def fused_step_enabled():
    """``MXNET_FUSED_STEP`` (default on); 0 runs the eager per-parameter
    loop. Read per step."""
    return getenv("MXNET_FUSED_STEP", True, bool)


def donate_params_enabled():
    """``MXNET_FUSED_STEP_DONATE``, accepted for the JAX package's sake;
    the port updates parameters in place, so there is nothing to
    donate."""
    return getenv("MXNET_FUSED_STEP_DONATE", False, bool)


class _FusedStepCache:
    """Bounded LRU of step functions keyed by signature, with counters:
    hits and misses of the lookup, evictions, bypasses (an optimizer
    with no fused kernel), CUDA-graph captures and replays."""

    def __init__(self, maxsize=None):
        self.maxsize = maxsize if maxsize is not None else \
            getenv("MXNET_FUSED_STEP_CACHE_SIZE", 16, int)
        # guards: _entries, _counts
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()
        self._counts = dict.fromkeys(("hits", "misses", "evictions",
                                      "bypasses", "captures", "replays"), 0)

    def _note(self, name):
        with self._lock:
            self._counts[name] += 1

    def note_hit(self):
        self._note("hits")

    def note_bypass(self):
        self._note("bypasses")

    def note_capture(self):
        self._note("captures")

    def note_replay(self):
        self._note("replays")

    def lookup(self, key):
        with self._lock:
            fn = self._entries.get(key)
            if fn is None:
                self._counts["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self._counts["hits"] += 1
            return fn

    def insert(self, key, fn):
        with self._lock:
            self._entries[key] = fn
            self._entries.move_to_end(key)
            while len(self._entries) > max(1, int(self.maxsize)):
                self._entries.popitem(last=False)
                self._counts["evictions"] += 1

    def stats(self):
        with self._lock:
            return dict(self._counts, size=len(self._entries),
                        maxsize=self.maxsize)

    def clear(self):
        with self._lock:
            self._entries.clear()
            for k in self._counts:
                self._counts[k] = 0


_CACHE = _FusedStepCache()

# trainers holding step state on the device, for the skip-step total
_TRAINERS = weakref.WeakSet()


def register_trainer(trainer):
    _TRAINERS.add(trainer)


def fused_step_stats():
    """The cache's counters and the AMP skip-step total over live
    trainers (reading that total syncs with the device)."""
    st = _CACHE.stats()
    st["skipped_steps"] = sum(tr._fused_skipped_steps()
                              for tr in list(_TRAINERS))
    return st


def reset_fused_step_cache(maxsize=None):
    """Drop every cached step function and zero the counters."""
    _CACHE.clear()
    if maxsize is not None:
        _CACHE.maxsize = int(maxsize)


# -- state trees (None | tensor | tuple of trees), as the optimizers'
# create_state_multi_precision builds them

def state_sig(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(state_sig(x) for x in s)
    return (tuple(s.shape), str(s.data.dtype))


def state_data(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(state_data(x) for x in s)
    return s.data


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for i in s for x in _leaves(i)]
    return [s]


def _commit(olds, news, ok):
    """Write ``news`` into ``olds``: all of them, or with a 0-d boolean
    ``ok`` only where it holds (an old tensor is then rewritten with its
    own bits)."""
    news = [n if n.dtype == o.dtype else n.to(o.dtype)
            for o, n in zip(olds, news)]
    if not olds:
        return
    if ok is None:
        torch._foreach_copy_(olds, news)
        return
    for o, n in zip(olds, news):
        torch.where(ok, n, o, out=o)


def build_step(kernel, mp_flags, groups, scaler_cfg):
    """The step function of one signature.

    ``kernel`` is the optimizer's fused kernel (``optimizer._fused_kernel``);
    ``mp_flags[i]`` marks the half parameters updated through their
    float32 master (state ``(master, base)``); ``groups`` lists, per
    learning-rate/weight-decay group, the positions of its parameters;
    ``scaler_cfg`` is None or ``(scale_factor, scale_window)``.

    Signature of the result::

        step(params, grads, states, sstate, scalars)

    over lists of tensors (states: the trees of tensors), ``sstate`` the
    step state ``{"t"[, "scale", "unskipped", "skips"]}`` of 0-d device
    tensors and ``scalars`` the device vector ``[lr per group, wd per
    group, rescale]``. Everything is updated in place; nothing is read
    back to the host."""
    ng = len(groups)
    if scaler_cfg is not None:
        factor, window = float(scaler_cfg[0]), int(scaler_cfg[1])

    def step(pvals, gvals, svals, sstate, scalars):
        t = sstate["t"]
        t1 = t + 1
        rescale = scalars[2 * ng]
        ok = None
        if scaler_cfg is not None:
            scale = sstate["scale"]
            fl = [g for g in gvals if g.is_floating_point()]
            found = torch.zeros((), dtype=torch.float32, device=t.device)
            if fl:
                torch._amp_foreach_non_finite_check_and_unscale_(
                    fl, found, torch.ones((), dtype=torch.float32,
                                          device=t.device))
            ok = found == 0
            # the scale the loss was multiplied by (powers of two keep
            # this bitwise equal to the eager path's host division)
            rescale = rescale / scale
        for j, pos in enumerate(groups):
            lr, wd = scalars[j], scalars[ng + j]
            for mp in (False, True):
                idx = [i for i in pos if mp_flags[i] == mp]
                if not idx:
                    continue
                ws = [pvals[i] for i in idx]
                gs = [gvals[i] for i in idx]
                ss = [svals[i] for i in idx]
                if mp:
                    masters = [s[0] for s in ss]
                    m2, b2 = kernel(masters, [g.to(torch.float32)
                                              for g in gs],
                                    [s[1] for s in ss], lr, wd, rescale, t1)
                    _commit(masters + _leaves([s[1] for s in ss]),
                            list(m2) + _leaves(list(b2)), ok)
                    _commit(ws, masters, ok)
                else:
                    w2, s2 = kernel(ws, gs, ss, lr, wd, rescale, t1)
                    _commit(ws + _leaves(ss), list(w2) + _leaves(list(s2)),
                            ok)
        if ok is None:
            t.copy_(t1)
            return
        unsk = sstate["unskipped"] + 1
        grow = unsk >= window
        scale_apply = torch.where(grow, scale * factor, scale)
        scale_skip = torch.clamp_min(scale / factor, 1.0)
        unsk_apply = torch.where(grow, torch.zeros_like(unsk), unsk)
        scale.copy_(torch.where(ok, scale_apply, scale_skip))
        sstate["unskipped"].copy_(torch.where(ok, unsk_apply,
                                              torch.zeros_like(unsk)))
        t.copy_(torch.where(ok, t1, t))
        sstate["skips"].add_(torch.logical_not(ok).to(torch.int32))

    return step
