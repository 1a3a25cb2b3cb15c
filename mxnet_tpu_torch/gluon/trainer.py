"""Gluon Trainer: the fused step or the eager loop, alone or across ranks.

The PyTorch counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py). ``step(batch_size)`` rescales the
gradients by ``1/batch_size`` (and by the loss scale, with an AMP loss
scaler from ``amp.init_trainer``) and updates every parameter whose
``grad_req`` is not ``"null"``, in place, so the blocks that registered
a parameter see the new values.

By default the step is the fused step (``gluon/fused_step.py``): one
function over the whole parameter group, built once per signature, with
the all-finite check, the skip and the loss scale's motion on the
device; on a CUDA device it is captured once as a CUDA graph and
replayed, so a step reads nothing back from the device. A deliberate
difference from the JAX trainer: a capture or replay that fails raises;
there is no eager fallback (``_fused_broken``), which would hide the
path. ``MXNET_FUSED_STEP=0`` runs the eager per-parameter loop, exactly
as the JAX package does, and so does an optimizer with no fused kernel
(counted as a bypass).

The store (``mxnet_tpu/gluon/trainer.py:34-61,102-160``): ``kvstore``
is a type name (``"local"``, ``"device"``, ``"nccl"``, ``"dist_sync"``,
``"dist_device_sync"``, ``"dist_async"``), a ``KVStore``, or None. A
``dist*`` store makes the trainer distributed: ``step`` first runs
``allreduce_grads``, which sums every gradient over the ranks of the
process group (``tools/launch.py``) — once, before the overflow check
and the update, so every rank takes the same skip or apply — in place
in the gradient buffers the fused step's CUDA graph reads. The
collective runs eagerly before the replay: a gloo collective cannot be
captured (the JAX trainer runs its collective as a program of its own,
``mxnet_tpu/gluon/trainer.py:603-611``). With ``MXNET_ASYNC_GRAD_SYNC``
(default on) the sums were started during ``backward`` in buckets
(``pipeline/grad_sync.py``) and ``allreduce_grads`` only finishes them;
the values are bitwise the same either way. ``compression_params``
(2-bit, ``{"type": "2bit", "threshold": t}``) quantize each rank's
gradients through the store's wire format, with error-feedback
residuals, before the sum (the reference's dist kvstore does so; the
JAX trainer holds the parameters and ignores them); the bucketed
reducer is then off, since the sums need the quantized values.
``update_on_kvstore`` is held, as in the JAX trainer: the update runs
on every rank, on the same summed gradients. No weights are broadcast
at the start: every rank starts from the same weights, carried in from
numpy or drawn from the same seed. In one process, or with a local
store, ``allreduce_grads`` does nothing. A trainer over several
contexts of one process (the mesh) comes with slice 9b.
"""
from __future__ import annotations

import pickle
import time

import torch

from ..base import MXNetError
from .. import optimizer as opt
from ..context import cuda_graph
from ..ndarray import NDArray
from ..ndarray import registry as _registry
from ..ndarray import sparse as _sp
from ..resilience import faults as _faults
from ..telemetry import tracer as _telem
from . import fused_step as _fs
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    gluon/trainer.py Trainer)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if hasattr(params, "values"):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
        from .. import kvstore as kvs

        # as the JAX trainer: a KVStore given is held, a type name is
        # not made into a store (a dist_async store would start a server)
        if isinstance(kvstore, kvs.KVStore):
            self._kvstore, self._kvstore_type = kvstore, kvstore.type
        elif kvstore is None or (isinstance(kvstore, str)
                                 and kvstore in kvs._VALID):
            self._kvstore, self._kvstore_type = None, kvstore or "device"
        else:
            raise MXNetError(f"unknown kvstore {kvstore!r} (expected one of "
                             f"{', '.join(kvs._VALID)}, a KVStore or None)")
        self._distributed = self._kvstore_type.startswith("dist")
        self._compression = None if self._kvstore is None \
            else self._kvstore._compression
        if compression_params:
            from ..gradient_compression import GradientCompression

            cp = dict(compression_params)
            ctype = cp.pop("type", "2bit")
            if self._kvstore is not None:
                self._kvstore.set_gradient_compression(compression_params)
            self._compression = None if ctype in (None, "none") else \
                GradientCompression(type=ctype, **cp)
        self._residuals = {}  # parameter index -> compression residual
        self._update_on_kvstore = update_on_kvstore
        self._grad_reducer = None  # the bucketed all-reduce
        self._params = list(params)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        if self._distributed and self._compression is None:
            # hooked now, so the first backward already dispatches buckets
            # (the JAX trainer hooks at its first step)
            self._async_reducer()
        self._states = None
        self._fused = None        # this trainer's group, buffers and graph
        self._fused_state = None  # the step state on the device
        self._fused_skips_host = 0

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        """Takes effect on the next step; the fused step reads the rate
        from a device scalar, so nothing is rebuilt or recaptured."""
        self._optimizer.set_learning_rate(lr)

    def _create_states(self):
        self._states = [
            self._optimizer.create_state_multi_precision(i, p.data())
            for i, p in enumerate(self._params)]

    # -- the step state on the device ---------------------------------------

    def _device(self):
        for p in self._params:
            if p._ndarray is not None:
                return p._ndarray.data.device
        raise MXNetError("Trainer: no parameter is initialized yet")

    def _fused_skipped_steps(self):
        """The AMP skip-step total (a device read while the device holds
        it)."""
        st = self._fused_state
        if st is not None and not st["stale"] and "skips" in st["vals"]:
            return int(st["vals"]["skips"].item())
        return self._fused_skips_host

    def _invalidate_fused_state(self):
        """The host is authoritative from here (load_states, the eager
        path): the next fused step re-seeds the device state in place."""
        st = self._fused_state
        if st is None or st["stale"]:
            return
        if "skips" in st["vals"]:
            self._fused_skips_host = int(st["vals"]["skips"].item())
        st["stale"] = True

    def _sync_fused_state(self):
        """Pull the device step state into the host mirrors: the update
        count (the host's drifts by the skipped steps) and the loss
        scaler's scale and window count. One device read, and none when
        no fused step ran since the last one."""
        st = self._fused_state
        if st is None or st["stale"] or not st["dirty"]:
            return
        names = list(st["vals"])
        vals = torch.stack([st["vals"][k].to(torch.float64)
                            for k in names]).tolist()
        vals = dict(zip(names, vals))
        t = int(vals["t"])
        optim = self._optimizer
        optim.num_update = t
        for k in optim._index_update_count:
            optim._index_update_count[k] = t
        st["expected_num_update"] = t
        if "scale" in vals:
            scaler = getattr(self, "_amp_loss_scaler", None)
            if scaler is not None:
                scaler._loss_scale = float(vals["scale"])
                scaler._unskipped = int(vals["unskipped"])
                st["scaler_mirror"] = (scaler._loss_scale,
                                       scaler._unskipped)
            self._fused_skips_host = int(vals["skips"])
        st["dirty"] = False

    def _ensure_fused_state(self, scaler):
        """The device step state, made once per mode (with or without a
        scaler) and re-seeded in place — never replaced, so a captured
        graph keeps reading it — when the host changed underneath
        (load_states, a write to ``loss_scale`` or ``num_update``)."""
        optim = self._optimizer
        st = self._fused_state
        with_scaler = scaler is not None
        mirror = (scaler._loss_scale, scaler._unskipped) if with_scaler \
            else None
        if st is None or ("scale" in st["vals"]) != with_scaler:
            dev = self._device()
            vals = {"t": torch.zeros((), dtype=torch.int32, device=dev)}
            if with_scaler:
                vals["scale"] = torch.zeros((), dtype=torch.float32,
                                            device=dev)
                vals["unskipped"] = torch.zeros((), dtype=torch.int32,
                                                device=dev)
                vals["skips"] = torch.zeros((), dtype=torch.int32,
                                            device=dev)
            self._invalidate_fused_state()
            st = self._fused_state = {"vals": vals, "stale": True,
                                      "dirty": False,
                                      "expected_num_update": None,
                                      "scaler_mirror": None}
            _fs.register_trainer(self)
        if st["stale"] or st["expected_num_update"] != optim.num_update \
                or st["scaler_mirror"] != mirror:
            self._invalidate_fused_state()  # carries the skip count over
            vals = st["vals"]
            with torch.no_grad():
                vals["t"].fill_(optim.num_update)
                if with_scaler:
                    vals["scale"].fill_(scaler._loss_scale)
                    vals["unskipped"].fill_(scaler._unskipped)
                    vals["skips"].fill_(self._fused_skips_host)
            st.update(stale=False, dirty=False,
                      expected_num_update=optim.num_update,
                      scaler_mirror=mirror)
        if with_scaler:
            scaler._device_sync = self._sync_fused_state
        return st

    def _loss_scale_operand(self):
        """What ``amp.scale_loss`` multiplies the loss by: the device
        scale on the fused path (no host read), else the host float."""
        scaler = self._amp_loss_scaler
        if _fs.fused_step_enabled() and \
                self._optimizer._fused_kernel() is not None:
            return self._ensure_fused_state(scaler)["vals"]["scale"]
        return scaler.loss_scale

    # -- the fused step -----------------------------------------------------

    def _fused_group(self, kernel_key, scaler_cfg):
        """The work set and the LRU key of the current parameter group:
        a dict, ``"empty"`` when no parameter takes gradients, or None
        when a gradient is sparse (the eager loop's lazy updates take
        it)."""
        optim = self._optimizer
        work = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not work:
            return "empty"
        params = [self._params[i] for i in work]
        grads = [p.grad() for p in params]
        if any(isinstance(g, _sp.BaseSparseNDArray) for g in grads):
            return None  # the per-tensor path (``mxnet_tpu`` trainer:384)
        states = [self._states[i] for i in work]
        mp_flags = tuple(bool(optim.multi_precision and
                              optim._is_half(p.data())) for p in params)
        # parameters that always share a learning rate and a weight
        # decay update as one list
        keys = {}
        for pos, i in enumerate(work):
            keys.setdefault((optim._lr_mult_of(i), optim._wd_mult_of(i)),
                            []).append(pos)
        groups = tuple(tuple(v) for v in keys.values())
        sig = tuple((tuple(p.shape), str(p.data().data.dtype),
                     str(g.data.dtype), _fs.state_sig(s))
                    for p, g, s in zip(params, grads, states))
        key = (type(optim).__name__, kernel_key, mp_flags, groups, sig,
               scaler_cfg, _registry.amp_version())
        return {"work": work, "params": params, "grads": grads,
                "states": states, "mp_flags": mp_flags, "groups": groups,
                "key": key}

    def _fused_entry(self, group, kernel, scaler_cfg):
        """The cached step function of ``group``'s signature, built on a
        miss; one construction site for the step loop and warmup."""
        fn = _fs._CACHE.lookup(group["key"])
        if fn is None:
            # persisted under the AMP policy, not this process's count
            # of policy changes
            fn = _fs.resolve_step(
                kernel, group["mp_flags"], group["groups"], scaler_cfg,
                group["key"][:-1] + (_registry.amp_policy(),))
            _fs._CACHE.insert(group["key"], fn)
        return fn

    def _buffer_ids(self, params):
        """Where the group's tensors live: a captured graph replays these
        addresses, so a change (a cast, a new gradient buffer) rebuilds."""
        return tuple((p._ndarray.data.data_ptr(), p._ndarray.data.dtype,
                      None if p._ndarray.grad is None
                      else p._ndarray.grad._data.data_ptr()) for p in params)

    def _fused_prepare(self, scaler):
        """This trainer's fused group for the current signature, built or
        reused; None when the optimizer has no fused kernel or a gradient
        is sparse, ``"empty"`` when nothing takes gradients."""
        optim = self._optimizer
        kern = optim._fused_kernel()
        if kern is None:
            return None
        if self._states is None:
            self._create_states()
        kernel_key, kernel = kern
        scaler_cfg = None if scaler is None else \
            (float(scaler._scale_factor), int(scaler._scale_window))
        st = self._ensure_fused_state(scaler)
        token = (kernel_key, scaler_cfg, _registry.amp_version(),
                 tuple(p.grad_req for p in self._params),
                 tuple((optim._lr_mult_of(i), optim._wd_mult_of(i))
                       for i in range(len(self._params))))
        cache = self._fused
        if cache is not None and cache["token"] == token and \
                cache["states"] is self._states and \
                cache["sstate"] is st["vals"] and \
                cache["ids"] == self._buffer_ids(cache["params"]):
            _fs._CACHE.note_hit()
            return cache
        t0 = time.monotonic()
        group = self._fused_group(kernel_key, scaler_cfg)
        if group is None or group == "empty":
            return group
        fn = self._fused_entry(group, kernel, scaler_cfg)
        dev = self._device()
        ng = len(group["groups"])
        self._fused = cache = {
            "token": token, "states": self._states, "sstate": st["vals"],
            "params": group["params"], "work": group["work"],
            "groups": group["groups"], "fn": fn,
            "ids": self._buffer_ids(group["params"]),
            "args": ([p._ndarray.data for p in group["params"]],
                     [g.data for g in group["grads"]],
                     [_fs.state_data(s) for s in group["states"]],
                     st["vals"]),
            "scalars": torch.zeros(2 * ng + 1, dtype=torch.float32,
                                   device=dev),
            "scalars_host": None, "graph": None}
        if not cache["scalars"].is_cuda and _telem.tracing():
            # the JAX fused step's ``fused_step.resolve``: on the CPU the
            # step function runs as it is, so building it resolves it; on
            # a CUDA device the capture does (``_capture``)
            _telem.emit_span("fused_step.resolve", "train", t0,
                             time.monotonic(), source="eager")
        return cache

    def _capture(self, cache):
        """Capture ``cache``'s step as a CUDA graph (nothing runs). A
        failure raises: the card runs the fused step only as a graph.
        The capture is the JAX fused step's ``fused_step.resolve`` and,
        inside it, its ``fused_step.trace_compile``."""
        with _telem.span("fused_step.resolve", cat="train",
                         source="capture"):
            try:
                _faults.maybe_fail("fused_step_capture")
                graph = torch.cuda.CUDAGraph()
                with _telem.span("fused_step.trace_compile", cat="train"), \
                        torch.no_grad(), \
                        cuda_graph(graph, capture_error_mode="thread_local"):
                    cache["fn"](*cache["args"], cache["scalars"])
            except Exception as e:
                raise MXNetError(
                    f"capturing the fused step as a CUDA graph failed "
                    f"({type(e).__name__}: {e}); on a CUDA device the "
                    "fused step runs only as a graph (MXNET_FUSED_STEP=0 "
                    "runs the eager loop)") from e
        cache["graph"] = graph
        _fs._CACHE.note_capture()

    def _set_scalars(self, cache, batch_size):
        """Write the groups' learning rates and weight decays and the
        rescale into the device vector the step reads, when they changed
        (one host-to-device copy, no wait)."""
        optim = self._optimizer
        firsts = [cache["work"][pos[0]] for pos in cache["groups"]]
        host = [optim._get_lr(i) for i in firsts] + \
            [optim._get_wd(i) for i in firsts] + [self._scale / batch_size]
        if host == cache["scalars_host"]:
            return
        cache["scalars_host"] = host
        src = torch.tensor(host, dtype=torch.float32)
        buf = cache["scalars"]
        with torch.no_grad():
            if buf.is_cuda:
                buf.copy_(src.pin_memory(), non_blocking=True)
            else:
                buf.copy_(src)

    def _fused_step(self, batch_size, scaler):
        """One fused step; False sends the caller to the eager loop (an
        optimizer with no fused kernel, or a sparse gradient; counted as
        a bypass)."""
        cache = self._fused_prepare(scaler)
        if cache is None:
            _fs._CACHE.note_bypass()
            return False
        if cache == "empty":
            return True  # nothing to update; the eager loop no-ops too
        optim = self._optimizer
        # the host's update count advances as on the eager path (and
        # drifts on a skipped step until the next sync); rates are read
        # after the bump, so a scheduler sees the eager path's count
        for i in cache["work"]:
            optim._update_count(i)
        self._set_scalars(cache, batch_size)
        # ``fused_step.execute`` goes around each replay, never inside
        # the captured body
        if cache["scalars"].is_cuda:
            if cache["graph"] is None:
                self._capture(cache)
            with _telem.span("fused_step.execute", cat="train"):
                try:
                    cache["graph"].replay()
                except Exception as e:
                    raise MXNetError(
                        f"replaying the fused step's CUDA graph failed "
                        f"({type(e).__name__}: {e})") from e
            _fs._CACHE.note_replay()
        else:
            with _telem.span("fused_step.execute", cat="train"), \
                    torch.no_grad():
                cache["fn"](*cache["args"], cache["scalars"])
        st = self._fused_state
        st["expected_num_update"] = optim.num_update
        st["dirty"] = True
        return True

    def warmup(self, shapes=None, block=None):
        """Build the step ahead of the first one, so no build or capture
        lands mid-training.

        Without arguments: builds (or finds) the fused step function of
        the current parameter group and, on a CUDA device, captures its
        graph; nothing runs, no state changes. With ``block`` and
        ``shapes`` (input shapes, one per expected batch signature):
        also runs one forward/backward/``step`` per shape on zero inputs,
        then restores parameters, gradients, optimizer state, the update
        counts, the loss scaler and the random generators in place, so
        training after ``warmup`` is the same as without it. Returns the
        number of shapes run."""
        from .parameter import DeferredInitializationError

        if (block is None) != (shapes is None):
            raise ValueError(
                "Trainer.warmup needs both shapes and block for the "
                "forward/backward/step warmup (got only "
                f"{'shapes' if shapes is not None else 'block'}); call "
                "warmup() with neither to build just the fused step")
        if block is None:
            try:
                self._warmup_fused()
            except DeferredInitializationError:
                pass  # shapes unknown until the first forward
            return 0
        return self._warmup_run(block, [tuple(s) for s in shapes])

    def _warmup_fused(self):
        if not _fs.fused_step_enabled():
            return False
        scaler = getattr(self, "_amp_loss_scaler", None)
        cache = self._fused_prepare(scaler)
        if cache is None or cache == "empty":
            return False
        if cache["scalars"].is_cuda and cache["graph"] is None:
            self._capture(cache)
        return True

    def _warmup_run(self, block, shapes):
        from .. import autograd
        from .. import ndarray as nd
        from .. import random as _random

        params = list(block.collect_params().values())
        if shapes and any(p._ndarray is None for p in params):
            # deferred parameters take their shapes from one forward
            # without recording (no dropout draws, no statistics updates)
            with autograd.pause(train_mode=False):
                block(nd.zeros(shapes[0], ctx=self._device_or_default()))
        for p in self._params:
            if p not in params:
                params.append(p)
        self._sync_fused_state()
        if self._states is None:
            self._create_states()
        live = [p for p in params if p._ndarray is not None]
        snap_w = [p._ndarray.data.detach().clone() for p in live]
        snap_g = [None if p._ndarray.grad is None else
                  p._ndarray.grad.data.clone() for p in live]
        state_leaves = _fs._leaves([_fs.state_data(s) for s in self._states])
        snap_s = [s.clone() for s in state_leaves]
        optim = self._optimizer
        snap_o = (optim.num_update, optim.begin_num_update,
                  dict(optim._index_update_count))
        scaler = getattr(self, "_amp_loss_scaler", None)
        snap_sc = None if scaler is None else \
            (scaler._loss_scale, scaler._unskipped)
        snap_skips = self._fused_skips_host
        gens = dict(_random._GENERATORS)
        snap_r = {d: g.get_state() for d, g in gens.items()}
        count = 0
        try:
            for shape in shapes:
                x = nd.zeros(shape, ctx=self._device_or_default())
                with autograd.record():
                    y = block(x)
                    outs = y if isinstance(y, (list, tuple)) else [y]
                    loss = outs[0].sum()
                    for o in outs[1:]:
                        loss = loss + o.sum()
                loss.backward()
                self.step(batch_size=max(int(shape[0]), 1) if shape else 1)
                count += 1
        finally:
            self._sync_fused_state()
            with torch.no_grad():
                for p, w, g in zip(live, snap_w, snap_g):
                    p._ndarray.data.copy_(w)
                    if g is not None and p._ndarray.grad is not None:
                        p._ndarray.grad.data.copy_(g)
                for s, v in zip(state_leaves, snap_s):
                    s.copy_(v)
            optim.num_update, optim.begin_num_update, counts = snap_o
            optim._index_update_count = counts
            if scaler is not None:
                scaler._loss_scale, scaler._unskipped = snap_sc
            self._invalidate_fused_state()
            self._fused_skips_host = snap_skips
            for d, g in gens.items():
                g.set_state(snap_r[d])
        return count

    def _device_or_default(self):
        from ..context import Context

        try:
            return Context.from_device(self._device())
        except MXNetError:
            return None

    # -- stepping -----------------------------------------------------------

    def allreduce_grads(self):
        """Sum the gradients over the ranks, in place (reference:
        trainer.py allreduce_grads; ``mxnet_tpu/gluon/trainer.py:102``):
        one collective per dtype, or the buckets the reducer started
        during backward. Nothing with a local store."""
        if not self._distributed:
            return
        from .. import _rendezvous, parallel

        grads = [p.grad() for p in self._params
                 if p.grad_req != "null" and p._ndarray is not None]
        sparse = [g for g in grads if isinstance(g, _sp.BaseSparseNDArray)]
        if sparse and _rendezvous.world_size() > 1:
            # the JAX trainer all-reduces a sparse gradient's values
            # position by position (right only where every rank stores
            # the same rows); a correct sparse reduce is not written yet
            raise MXNetError(
                f"{len(sparse)} row_sparse gradients across "
                f"{_rendezvous.world_size()} processes: the sparse reduce "
                "over ranks is not written yet")
        grads = [g for g in grads if not isinstance(g, _sp.BaseSparseNDArray)]
        gc = self._compression
        if gc is not None:
            with torch.no_grad():
                for i, g in enumerate(grads):
                    deq, self._residuals[i] = gc.roundtrip(
                        g.data, self._residuals.get(i))
                    g.data.copy_(deq)
        reducer = None if gc is not None else self._async_reducer()
        if grads and reducer is not None:
            reducer.flush(grads)
        elif grads:
            with torch.no_grad():
                for g, r in zip(grads, parallel.all_reduce_coalesced(grads)):
                    if r is not g:
                        g.data.copy_(r.data)

    def _async_reducer(self):
        """The bucketed reducer, made and hooked into autograd once per
        trainer while ``MXNET_ASYNC_GRAD_SYNC`` is on; with the knob off,
        this round's speculation is dropped and None returned."""
        from .. import pipeline as _pl

        if not _pl.async_grad_sync_enabled():
            if self._grad_reducer is not None:
                self._grad_reducer.abandon()
            return None
        if self._grad_reducer is None:
            self._grad_reducer = _pl.AsyncGradReducer(self._params).attach()
        return self._grad_reducer

    def _abandon_speculation(self):
        """Drop the reducer's round in flight without binding it: a state
        boundary (``save_states``, ``load_states``) must not carry sums of
        gradients from before it into the step after it."""
        if self._grad_reducer is not None:
            self._grad_reducer.abandon()

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1/batch_size and update (reference: trainer.py step).
        With an AMP loss scaler the gradients are also divided by the
        loss scale, and a step whose gradients hold an inf or a NaN is
        skipped and halves the scale; on the fused path all of it happens
        on the device."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        self.allreduce_grads()
        # MXNET_GRAPH_VERIFY-gated (JAX ``gluon/trainer.py:305-312``): the
        # step writes every parameter in place, so a parameter a live
        # autograd graph saved would hand that backward the new values
        from ..analysis import check_param_donation, verify_mode

        if verify_mode() != "off":
            check_param_donation([(p.name, p._ndarray._data)
                                  for p in self._params
                                  if p._ndarray is not None])
        if _fs.fused_step_enabled() and self._fused_step(batch_size, scaler):
            return
        if self._fused_state is not None:
            # the fused path ran earlier: the device state is
            # authoritative, pull it back before the eager arithmetic
            self._sync_fused_state()
            self._invalidate_fused_state()
        rescale = self._scale / batch_size
        if scaler is not None:
            if scaler.has_overflow(self._params):
                scaler.update_scale(True)
                return  # skip the update entirely
            # divide by the scale the loss was multiplied by; grow it only
            # after the step is applied
            rescale = rescale / scaler.loss_scale
        self._optimizer.rescale_grad = rescale
        try:
            self._update_all()
        finally:
            self._optimizer.rescale_grad = self._scale
        if scaler is not None:
            scaler.update_scale(False)

    def update(self, batch_size, ignore_stale_grad=False):
        """The eager update alone, rescaled by 1/batch_size (reference:
        trainer.py update): the second half of ``step`` after
        ``allreduce_grads``, through the per-parameter loop."""
        self._optimizer.rescale_grad = self._scale / batch_size
        try:
            self._update_all()
        finally:
            self._optimizer.rescale_grad = self._scale

    def _update_all(self):
        if self._states is None:
            self._create_states()
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            self._optimizer.update_multi_precision(i, p.data(), p.grad(),
                                                   self._states[i])

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    # -- checkpoints --------------------------------------------------------

    def save_states(self, fname):
        """Write the optimizer's state (moments, master weights, update
        counts) and the loss scaler's to ``fname`` (reference: trainer.py
        save_states); the device step state is synced first."""
        if self._states is None:
            self._create_states()
        self._abandon_speculation()
        self._sync_fused_state()
        opt_ = self._optimizer
        payload = {"num_update": opt_.num_update,
                   "index_update_count": dict(opt_._index_update_count),
                   "states": [_dump(s) for s in self._states]}
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            payload["loss_scaler"] = {"loss_scale": scaler._loss_scale,
                                      "unskipped": scaler._unskipped}
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def load_states(self, fname):
        """Restore what :meth:`save_states` wrote. States that exist with
        the same layout are overwritten in place, so a captured fused
        step keeps its graph; the device step state is re-seeded from
        the restored counts at the next step."""
        self._abandon_speculation()
        with open(fname, "rb") as f:
            payload = pickle.load(f)  # a file this trainer wrote
        if len(payload["states"]) != len(self._params):
            raise MXNetError(f"{fname}: states for {len(payload['states'])} "
                             f"parameters, the trainer has "
                             f"{len(self._params)}")
        loaded = [_load(s, p.data().data.device)
                  for s, p in zip(payload["states"], self._params)]
        if self._states is not None and \
                [_fs.state_sig(s) for s in self._states] == \
                [_fs.state_sig(s) for s in loaded]:
            with torch.no_grad():
                for old, new in zip(
                        _fs._leaves([_fs.state_data(s)
                                     for s in self._states]),
                        _fs._leaves([_fs.state_data(s) for s in loaded])):
                    old.copy_(new)
        else:
            self._states = loaded
        opt_ = self._optimizer
        opt_.num_update = opt_.begin_num_update = payload["num_update"]
        opt_._index_update_count = dict(payload.get("index_update_count",
                                                    {}))
        scaler_state = payload.get("loss_scaler")
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler_state is not None and scaler is not None:
            scaler._loss_scale = float(scaler_state["loss_scale"])
            scaler._unskipped = int(scaler_state["unskipped"])
        self._invalidate_fused_state()


def _dump(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_dump(s) for s in state)
    return state.asnumpy()


def _load(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_load(s, device) for s in state)
    from ..ndarray.ndarray import host_tensor

    return NDArray(host_tensor(state).to(device))
