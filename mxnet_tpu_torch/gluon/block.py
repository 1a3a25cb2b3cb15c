"""Gluon Block / HybridBlock / CachedOp over ``torch.nn.Module``.

The PyTorch counterpart of ``mxnet_tpu/gluon/block.py:92-742``
(reference: python/mxnet/gluon/block.py; src/imperative/cached_op.cc).
A :class:`Block` is an ``nn.Module``: its children are the module's
submodules, and each Gluon :class:`~.parameter.Parameter` registers its
tensor on the block once it is initialized. MXNet's naming survives —
``name_scope`` prefixes, ``collect_params`` and the structural names of
``_collect_params_with_prefix`` — so checkpoints
(``save_parameters``/``load_parameters``, byte for byte the JAX
package's files) and carried weights line up with the JAX package.
``hybrid_forward(F, ...)`` runs with ``F`` = the port's ``nd`` module,
or ``F`` = ``sym`` when the inputs are Symbols (``export``). A block's
forward builds an autograd graph only inside ``autograd.record()``;
outside it, grad mode is off for the call. Hooks take MXNet's
signatures: ``register_forward_hook(hook)`` calls ``hook(block, args,
out)`` and returns a :class:`HookHandle` (this overrides
``nn.Module.register_forward_hook``).

``hybridize()`` gives the outermost active :class:`HybridBlock` a
:class:`CachedOp`: on a CUDA device one captured CUDA graph of the
forward per call signature, and under ``record()`` one of the backward
too, replayed on every later call (the JAX package's ``jax.jit`` of the
forward and ``jax.vjp`` of it); on the CPU the same function runs
uncaptured. :class:`SymbolBlock` runs a symbol graph (an export loaded
with :meth:`SymbolBlock.imports`) through the graph optimizer.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import telemetry as _telemetry
from .. import ndarray as nd
from .. import random as _random
from ..base import MXNetError, getenv
from ..context import cuda_graph
from ..kernels import _build
from ..ndarray import NDArray
from ..ndarray import registry as _registry
from ..analysis import quantize as _quantize
from ..resilience import faults as _faults
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp", "HookHandle",
           "cached_op_stats", "reset_cached_op_stats"]


class _BlockScope(threading.local):
    def __init__(self):
        self.current = None
        self.counters = {}


_SCOPE = _BlockScope()


def _gen_prefix(hint):
    if _SCOPE.current is None:
        counters = _SCOPE.counters
        base = ""
    else:
        counters = _SCOPE.current._counters
        base = _SCOPE.current.prefix
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{base}{hint}{idx}_"


class _NameScope:
    def __init__(self, block):
        self._block = block
        self._old = None

    def __enter__(self):
        self._old = _SCOPE.current
        _SCOPE.current = self._block
        return self

    def __exit__(self, *exc):
        _SCOPE.current = self._old


class HookHandle:
    """Detachable registration (reference: gluon/utils.py HookHandle)."""

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._hook = hook

    def detach(self):
        try:
            self._hooks.remove(self._hook)
        except ValueError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class Block(torch.nn.Module):
    """Base building block (reference: gluon/block.py:228)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None else \
            _gen_prefix(type(self).__name__.lower())
        self._params = ParameterDict(params.prefix if params is not None
                                     else self._prefix)
        if params is not None:
            self._params.update(params)
        self._reg_params = {}
        self._counters = {}
        # MXNet's hooks; nn.Module's own lists keep torch's hooks
        self._mx_forward_hooks = []
        self._mx_forward_pre_hooks = []

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    @property
    def _children(self):
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else \
            self._prefix

    def name_scope(self):
        """Reference: gluon/block.py name_scope."""
        return _NameScope(self)

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Reference: gluon/block.py:372 collect_params with regex select."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _runs_quantized(self):
        """Whether this block runs int8 ops: a quantized ``SymbolBlock``
        in its tree, or a child ``contrib.quantization.quantize_net``
        swapped. A ``CachedOp`` keys such a block's captures by the
        resolved quantize lowering."""
        return any(c._runs_quantized() for c in self._children.values())

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after every call, hybridized or not
        (MXNet's signature; it replaces ``nn.Module``'s). Returns a
        :class:`HookHandle`."""
        self._mx_forward_hooks.append(hook)
        return HookHandle(self._mx_forward_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before every call (MXNet's signature)."""
        self._mx_forward_pre_hooks.append(hook)
        return HookHandle(self._mx_forward_pre_hooks, hook)

    def register_op_hook(self, callback, monitor_all=False):
        """Tap every descendant block's outputs during forward (reference:
        block.py register_op_hook over CachedOp monitor callbacks; the
        JAX package's ``block.py:163-276``): ``callback(name, array)``,
        with the blocks' inputs too under ``monitor_all``. While a hook is
        attached, hybridized blocks of the subtree run eagerly (the
        reference's monitor mode), so the taps fire on every call.
        Returns a handle whose ``detach()`` removes this hook; handles
        detach in any order."""
        entry = (object(), callback, bool(monitor_all))
        touched = []

        def install(blk, prefix):
            for cname, child in blk._children.items():
                name = getattr(child, "name", None) or cname
                install(child, prefix + name + ".")
            label = prefix.rstrip(".") or (getattr(blk, "name", "") or
                                           type(blk).__name__)
            labels = blk.__dict__.setdefault("_op_hook_labels", {})
            labels[entry[0]] = label
            cbs = blk.__dict__.get("_op_hook_cbs")
            if cbs is None:
                cbs = blk.__dict__["_op_hook_cbs"] = []
                orig = blk.forward

                def tap(*args, _orig=orig, _blk=blk, **kw):
                    # snapshot both: a callback may detach mid-forward
                    hooks = list(_blk._op_hook_cbs)
                    lbls = dict(_blk._op_hook_labels)
                    for tok, cb, mon_all in hooks:
                        if mon_all:
                            for i, a in enumerate(args):
                                if isinstance(a, NDArray):
                                    cb(f"{lbls[tok]}_data{i}", a)
                    out = _orig(*args, **kw)
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    for tok, cb, _mon_all in hooks:
                        for i, o in enumerate(outs):
                            if isinstance(o, NDArray):
                                suffix = "_output" if len(outs) == 1 \
                                    else f"_output{i}"
                                cb(f"{lbls[tok]}{suffix}", o)
                    return out

                blk.__dict__["_op_hook_fwd"] = (tap, orig)
                blk.__dict__["forward"] = tap
            cbs.append(entry)
            blk.__dict__["_op_hooks_active"] = \
                blk.__dict__.get("_op_hooks_active", 0) + 1
            touched.append(blk)

        install(self, "")

        class _OpHookHandle:
            def detach(self_inner):
                for blk in touched:
                    blk.__dict__.get("_op_hook_labels", {}).pop(entry[0],
                                                                None)
                    cbs = blk.__dict__.get("_op_hook_cbs")
                    if cbs is not None and entry in cbs:
                        cbs.remove(entry)
                        blk.__dict__["_op_hooks_active"] = max(
                            0, blk.__dict__.get("_op_hooks_active", 1) - 1)
                        if not cbs:
                            tap, _orig = blk.__dict__.pop("_op_hook_fwd")
                            if blk.__dict__.get("forward") is tap:
                                del blk.__dict__["forward"]
                            blk.__dict__["_op_hook_cbs"] = None
                touched.clear()

        return _OpHookHandle()

    def apply(self, fn):
        """``fn(block)`` on every child, depth first, then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, ``gpu(0)`` unless a scope says otherwise)."""
        from .. import initializer

        self.collect_params().initialize(init or initializer.Uniform(), ctx,
                                         verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype`` (reference: gluon/block.py cast); layers may pin their
        own (``BatchNorm`` keeps float32 under a half cast)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def _collect_params_with_prefix(self, prefix=""):
        """Structure-based parameter names ("0.weight", "body.1.bias"),
        the names the JAX package's ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write every initialized parameter, keyed by structural name, in
        the reference's binary format (reference: gluon/block.py:416);
        the bytes equal the JAX package's for the same values.
        ``deduplicate`` is accepted as the JAX package accepts it (a
        parameter shared by two blocks is written under each name)."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {key: val.data() for key, val in params.items()
                           if val._ndarray is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``save_parameters`` file (structural names) or an
        ``arg:``/``aux:``-prefixed export or Module checkpoint (full
        parameter names), as the JAX package does (``block.py:310-350``).
        Each parameter keeps its device and dtype (one not yet allocated
        lands on its deferred device, else on ``ctx``), except that
        ``cast_dtype=True`` with ``dtype_source="saved"`` casts the
        parameter to the file's dtype first (reference semantics)."""
        from .. import cpu

        self._load_loaded_parameters(nd.load(filename, ctx=cpu()), filename,
                                     allow_missing, ignore_extra, ctx,
                                     cast_dtype and dtype_source == "saved")

    def _load_loaded_parameters(self, loaded, filename, allow_missing=False,
                                ignore_extra=False, ctx=None,
                                cast_to_saved=False):
        if loaded and all(k.startswith(("arg:", "aux:")) for k in loaded):
            loaded = {k.split(":", 1)[1]: v for k, v in loaded.items()}
            params = dict(self.collect_params().items())
        else:
            params = self._collect_params_with_prefix()
            if loaded and not any(k in params for k in loaded):
                # reference-era checkpoints use full parameter names
                by_name = dict(self.collect_params().items())
                if any(k in by_name for k in loaded):
                    params = by_name
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError(f"Parameter '{name}' is missing in file "
                                  f"'{filename}'")
        for name in loaded:
            if name not in params:
                if not ignore_extra:
                    raise IOError(f"Parameter '{name}' loaded from file "
                                  f"'{filename}' is not present in Block")
                continue
            if cast_to_saved:
                params[name].cast(loaded[name].data.dtype)
            params[name].set_data(loaded[name], ctx=ctx)

    save_params = save_parameters
    load_params = load_parameters

    def hybridize(self, active=True, **kwargs):
        """Hybridize every child (a plain Block has nothing to cache)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print each block with its parameter count (reference:
        gluon/block.py summary, as the JAX package prints it)."""
        rows = []

        def walk(block, indent=0):
            n_params = sum(p.data().size for p in block._reg_params.values()
                           if p._ndarray is not None)
            rows.append("  " * indent + f"{type(block).__name__}"
                        f" ({block.name}): {n_params} params")
            for c in block._children.values():
                walk(c, indent + 1)

        walk(self)
        print("\n".join(rows))

    def __call__(self, *args, **kwargs):
        for hook in list(self._mx_forward_pre_hooks):
            hook(self, args)
        with autograd._grad_mode():
            out = super().__call__(*args, **kwargs)
        for hook in list(self._mx_forward_hooks):
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


# -- CachedOp -----------------------------------------------------------------

# the ``cached_op`` family of the telemetry registry
_STATS = _telemetry.counter_family(
    "cached_op", dict.fromkeys(("builds", "calls", "captures", "replays",
                                "backward_replays", "drops"), 0))


def _count(name, n=1):
    _STATS.add(name, n)


def cached_op_stats():
    """Counters over every CachedOp: ``builds`` (signature entries made,
    on any device), ``calls`` (calls through a cache), ``captures`` (CUDA
    signatures captured: a forward graph, with its backward graph when
    recording), ``replays`` (forward graph replays), ``backward_replays``
    and ``drops`` (caches dropped by ``hybridize``/``cast``). On the CPU
    captures and replays stay 0."""
    return _STATS.snapshot()


def reset_cached_op_stats():
    _STATS.reset()


class _Entry:
    """One signature's cache: on a CUDA device its static buffers and
    graphs, and the launches each graph's capture recorded."""

    def __init__(self, sig):
        self.sig = sig
        self.calls = 0
        self.graph = None        # forward CUDA graph
        self.bwd = None          # backward CUDA graph (recording only)
        self.ptrs = None         # the parameters' addresses it captured
        self.static_inputs = []
        self.static_outputs = []
        self.out_diff = []       # which outputs carry a gradient
        self.static_gouts = []   # cotangent buffers of those outputs
        self.param_grads = []    # per parameter that takes a gradient
        self.input_grads = []    # per input (None: no gradient)
        self.tree = None
        self.fwd_launches = {}
        self.bwd_launches = {}
        self.replays = 0
        self.bwd_replays = 0
        self.generation = 0      # forward replays, to spot stale backwards
        # the record() scope of a recorded replay whose backward has not
        # run yet (None: none is waiting)
        self.pending_scope = None

    def awaits_backward(self):
        """Whether a recorded replay of this scope still needs this
        entry's activations: another recorded call in the scope takes
        another slot."""
        return self.pending_scope is not None and \
            self.pending_scope == autograd._record_scope_id()

    def replay(self):
        self.graph.replay()
        self.replays += 1
        self.generation += 1
        _build.count_replay(self.fwd_launches)
        _count("replays")

    def info(self):
        return {"signature": self.sig, "calls": self.calls,
                "graph": self.graph is not None,
                "backward_graph": self.bwd is not None,
                "replays": self.replays, "backward_replays": self.bwd_replays,
                "launches_per_replay": dict(self.fwd_launches),
                "backward_launches_per_replay": dict(self.bwd_launches)}


class _CachedFn(torch.autograd.Function):
    """A recorded call of a captured signature: the forward replays the
    forward graph over the static inputs; the backward copies the
    cotangents into the static buffers, replays the backward graph and
    hands back its static gradients (the pattern of
    ``torch.cuda.make_graphed_callables``, under MXNet's ``grad_req``:
    only parameters that take a gradient are inputs of the node)."""

    @staticmethod
    def forward(ctx, op, entry, nparams, *tensors):
        for s, t in zip(entry.static_inputs, tensors[nparams:]):
            s.copy_(t)
        entry.replay()
        entry.pending_scope = autograd._record_scope_id()
        ctx.op, ctx.entry, ctx.nparams = op, entry, nparams
        ctx.generation = entry.generation
        outs = tuple(o.detach().clone() for o in entry.static_outputs)
        fixed = [o for o, d in zip(outs, entry.out_diff) if not d]
        if fixed:
            ctx.mark_non_differentiable(*fixed)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        entry = ctx.entry
        none = (None, None, None)
        if torch.is_grad_enabled():
            raise MXNetError(
                f"hybridize: {ctx.op._label()} cannot give higher-order "
                "gradients: its backward is a captured CUDA graph; run the "
                "block unhybridized for grad(create_graph=True)")
        if entry.generation != ctx.generation:
            raise MXNetError(
                f"hybridize: {ctx.op._label()} was called again under a "
                "later record() before this call's backward, and the "
                "replay overwrote the activations the backward needs; "
                "call backward before the next record() scope calls the "
                "block")
        entry.pending_scope = None
        if entry.bwd is None:
            return none + (None,) * (ctx.nparams + len(entry.input_grads))
        with torch.no_grad():
            for buf, g in zip(entry.static_gouts,
                              [g for g, d in zip(grads, entry.out_diff)
                               if d]):
                buf.copy_(g)
        entry.bwd.replay()
        entry.bwd_replays += 1
        _build.count_replay(entry.bwd_launches)
        _count("backward_replays")
        return none + tuple(entry.param_grads) + tuple(entry.input_grads)


class CachedOp:
    """The cache of one hybridized block (reference:
    src/imperative/cached_op.cc; the JAX package's ``CachedOp``,
    ``block.py:384-481``, which is ``jax.jit`` of the forward with the
    backward from ``jax.vjp``).

    One entry per call signature: the inputs' shapes, dtypes, devices
    and whether they take a gradient, ``autograd.is_training()``,
    ``autograd.is_recording()``, inference mode, and the AMP policy's
    version (``registry.amp_version()``), so ``amp.init`` rebuilds.

    On a CUDA device an entry captures the block's forward as a CUDA
    graph at its first call, and under ``record()`` the backward of that
    forward as a second graph in the same memory pool; each later call
    copies its inputs into the entry's static input buffers and
    replays. A recorded call is one ``torch.autograd.Function`` node
    whose backward replays the backward graph, so gradients land by
    ``grad_req`` as on the eager path. A signature has slots: a recorded
    call made while an earlier one of the same ``record()`` scope still
    waits for its backward (a GAN's discriminator on real and on fake
    data) takes the next slot, with its own buffers and graphs, captured
    at its first use. Before capturing, the entry runs
    the forward (and backward) once eagerly on a side stream, so cuDNN
    has tuned every shape and cuBLAS and the kernels are loaded; the
    aux states that forward updated (``grad_req="null"``: batch norm's
    running statistics) are restored, so N calls update them N times,
    as in the JAX package. The random generator of the device is
    registered with each graph, so every replay draws fresh numbers.
    Launches are counted per replay (``_build.recording_launches`` /
    ``count_replay``). Nothing falls back: a forward that cannot be
    captured (a host sync such as ``asnumpy()``/``.item()``, a
    data-dependent shape) raises :class:`MXNetError` naming the block
    and the signature.

    Outputs are handed back as copies the caller owns (one device copy
    per output and call), never the graph's static outputs, which the
    next replay overwrites. Parameter gradients come back as the
    backward graph's static buffers, which ``autograd.backward`` copies
    into the parameters' buffers before anything replays again. A call
    whose backward runs only after a later ``record()`` scope called the
    block again raises at that backward (the later replay reused its
    slot and overwrote the activations). Graphs live until
    ``hybridize()`` or ``cast`` drops the cache.

    On the CPU the entry runs the same forward uncaptured (keyed and
    counted all the same); inside an enclosing capture (a serving
    session's step graph) the forward runs into that graph. ``MXNET_BACKWARD_DO_MIRROR=1`` recomputes the
    forward in the backward (``torch.utils.checkpoint``), the JAX
    package's ``jax.checkpoint``; on the card it refuses a forward that
    draws random numbers, whose recompute would draw others.
    ``static_alloc`` and ``static_shape`` are recorded, as in the JAX
    package: a captured graph is static in both already."""

    def __init__(self, block, static_alloc=False, static_shape=False,
                 **flags):
        self._block = block
        self.static_alloc = bool(static_alloc)
        self.static_shape = bool(static_shape)
        self.flags = dict(flags)
        self.entries = {}
        self._params = None
        self._tree = None
        self._mirror = getenv("MXNET_BACKWARD_DO_MIRROR", False, bool)
        self._quantized = None  # whether the block runs int8 ops

    def _label(self):
        return f"{type(self._block).__name__} '{self._block.name}'"

    def _ensure_params(self):
        if self._params is None:
            seen, params = set(), []
            for _, p in sorted(self._block.collect_params().items()):
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
            self._params = params
        return self._params

    def __call__(self, *args, tree=None):
        """Run the block on the NDArrays ``args``; ``tree`` (from
        ``_flatten_outputs``) regroups them into the block's arguments
        when some argument is a list of NDArrays (a recurrent layer's
        states)."""
        self._tree = tree
        params = self._ensure_params()
        if any(p._ndarray is None for p in params):
            # finish deferred shapes with one eager forward, as the JAX
            # package does (block.py:439-444): in training mode it moves
            # the running statistics like any forward
            with autograd.pause(train_mode=autograd.is_training()):
                self._forward(args)
            self._params = None
            params = self._ensure_params()
        ptensors = [p._ndarray.data for p in params]
        recording = autograd.is_recording()
        train = autograd.is_training()
        sig = tuple((tuple(a.shape), str(a.data.dtype).replace("torch.", ""),
                     str(a.data.device), bool(a.data.requires_grad))
                    for a in args)
        if self._quantized is None:
            self._quantized = self._block._runs_quantized()
        # a capture bakes in the route the quantize lowering chose: a
        # quantized block keys its entries by the resolved lowering
        qsalt = _quantize.fingerprint_salt(
            self._quantized, args[0].data if args else None)
        key = (sig, tree, train, recording,
               torch.is_inference_mode_enabled(),
               _registry.amp_version(),
               tuple(t.requires_grad for t in ptensors) if recording else (),
               qsalt)
        entry = self._entry(key, {"inputs": sig, "train": train,
                                  "recording": recording}, recording)
        entry.calls += 1
        _count("calls")
        cuda = any(t.is_cuda for t in ptensors) or \
            any(a.data.is_cuda for a in args)
        if not cuda or torch.cuda.is_current_stream_capturing():
            # the CPU; or a capture already running (a serving session's
            # step graph): the forward joins the enclosing graph
            return self._run(list(args))
        ptrs = tuple(t.data_ptr() for t in ptensors)
        if entry.graph is None or entry.ptrs != ptrs:
            # first call, or a parameter was reallocated (force_reinit)
            self._capture(entry, args, params, recording)
            entry.ptrs = ptrs
        if recording:
            req = [t for t in ptensors if t.requires_grad]
            outs = _CachedFn.apply(self, entry, len(req), *req,
                                   *[a.data for a in args])
        else:
            with torch.no_grad():
                for s, a in zip(entry.static_inputs, args):
                    s.copy_(a.data)
                entry.replay()
                outs = [o.clone() for o in entry.static_outputs]
        return _unflatten_outputs([NDArray(o) for o in outs], entry.tree)

    def _entry(self, key, sig, recording):
        """The signature's entry: its first slot whose activations no
        recorded call of this scope still waits for (a new slot when
        every one is waiting)."""
        slot = 0
        while True:
            k = key if slot == 0 else key + (("slot", slot),)
            entry = self.entries.get(k)
            if entry is None:
                entry = self.entries[k] = _Entry(
                    sig if slot == 0 else dict(sig, slot=slot))
                _count("builds")
                return entry
            if not (recording and entry.awaits_backward()):
                return entry
            slot += 1

    # -- running the block ---------------------------------------------

    def _forward(self, inputs):
        """The block's forward on the flat NDArrays ``inputs``, regrouped
        by this call's tree."""
        if self._tree is not None:
            inputs = _unflatten_outputs(list(inputs), self._tree)
        return self._block.forward(*inputs)

    def _run(self, inputs):
        """The block's forward on NDArrays ``inputs``, with the mirror
        (recompute in backward) when it is asked for while recording."""
        if not (self._mirror and autograd.is_recording()):
            return self._forward(inputs)
        gens = [_random.device_generator(d) for d in
                {a.data.device for a in inputs}]
        cuda = any(a.data.is_cuda for a in inputs)
        box = {"calls": 0, "train": autograd.is_training()}

        def fn(*tensors):
            # the second call is the recompute in the backward: it draws
            # the forward's random numbers again (off a capture; a
            # captured forward that draws is refused in _capture)
            recompute = box["calls"] > 0
            box["calls"] += 1
            host = not (cuda and torch.cuda.is_current_stream_capturing())
            saved = None
            if host and recompute:
                saved = [g.get_state() for g in gens]
                for g, s in zip(gens, box["rng"]):
                    g.set_state(s)
            elif host:
                box["rng"] = [g.get_state() for g in gens]
            try:
                with autograd._scope(recording=True, training=box["train"]):
                    out = self._forward([NDArray(t) for t in tensors])
            finally:
                if saved is not None:
                    for g, s in zip(gens, saved):
                        g.set_state(s)
            flat, box["tree"] = _flatten_outputs(out)
            return tuple(o.data for o in flat)

        from torch.utils.checkpoint import checkpoint

        outs = checkpoint(fn, *[a.data for a in inputs], use_reentrant=False,
                          preserve_rng_state=False)
        return _unflatten_outputs([NDArray(o) for o in outs], box["tree"])

    # -- capture --------------------------------------------------------

    def _capture(self, entry, args, params, recording):
        """Warm up, then capture ``entry``'s forward (and, recording, its
        backward) as CUDA graphs over fresh static buffers. Nothing of the
        call runs here: the caller replays. Raises :class:`MXNetError`."""
        entry.graph = entry.bwd = None
        swapped, originals = [], []
        dev = next(a.data.device for a in args if a.data.is_cuda) if any(
            a.data.is_cuda for a in args) else params[0]._ndarray.data.device
        try:
            _faults.maybe_fail("cached_op_capture")
            with torch.no_grad():
                static_in = [a.data.detach().clone() for a in args]
            for s, a in zip(static_in, args):
                s.requires_grad_(recording and a.data.requires_grad)
            # the forward runs on aliases of the parameters that take a
            # gradient: leaves made here over the parameters' memory, so
            # the graphs read and differentiate the parameters while no
            # autograd node made outside the capture takes part (another
            # slot's pending call keeps the parameters' own gradient
            # accumulators alive, tied to the default stream)
            swapped = [p for p in params
                       if p._ndarray.data.requires_grad] if recording else []
            originals = [p._ndarray._data for p in swapped]
            req = [t.detach().requires_grad_() for t in originals]
            for p, alias in zip(swapped, req):
                p._ndarray._data = alias
            aux = [p._ndarray.data for p in params if p.grad_req == "null"]
            targets = req + [s for s in static_in if s.requires_grad]
            cur = torch.cuda.current_stream(dev)
            with torch.no_grad():
                snap = [t.clone() for t in aux]
            drawn = _random.draws()
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                # brings up what a capture may not do: cuDNN's autotuning
                # of every shape, cuBLAS's handles, the kernels' modules
                outs = self._run([NDArray(t) for t in static_in])
                flat, _ = _flatten_outputs(outs)
                diff = [o.data for o in flat if o.data.requires_grad]
                if recording and diff and targets:
                    autograd._torch_grad(diff, targets,
                                         [torch.ones_like(o) for o in diff],
                                         retain_graph=False)
                del outs, flat, diff
            cur.wait_stream(side)
            with torch.no_grad():  # the warm-up's statistics updates
                for t, s in zip(aux, snap):
                    t.copy_(s)
            del snap
            if self._mirror and recording and _random.draws() != drawn:
                raise MXNetError(
                    "MXNET_BACKWARD_DO_MIRROR=1 with a forward that draws "
                    "random numbers cannot be captured: the recompute in "
                    "the captured backward would draw other numbers")
            gen = _random.device_generator(dev)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            with _build.recording_launches() as frec:
                with cuda_graph(graph,
                                capture_error_mode="thread_local"):
                    outs = self._run([NDArray(t) for t in static_in])
            flat, tree = _flatten_outputs(outs)
            static_out = [o.data for o in flat]
            out_diff = [recording and o.requires_grad for o in static_out]
            bwd, brec, gouts, grads = None, {}, [], []
            if any(out_diff) and targets:
                gouts = [torch.empty_like(o) for o, d in
                         zip(static_out, out_diff) if d]
                bwd = torch.cuda.CUDAGraph()
                bwd.register_generator_state(gen)
                with _build.recording_launches() as brec:
                    with cuda_graph(bwd, pool=graph.pool(),
                                    capture_error_mode="thread_local"):
                        grads = autograd._torch_grad(
                            [o for o, d in zip(static_out, out_diff) if d],
                            targets, gouts, retain_graph=False)
        except Exception as e:
            raise self._capture_error(entry, e) from e
        finally:
            for p, t in zip(swapped, originals):
                p._ndarray._data = t
        entry.graph, entry.bwd, entry.tree = graph, bwd, tree
        entry.static_inputs = static_in
        entry.static_outputs = [o.detach() for o in static_out]
        entry.out_diff, entry.static_gouts = out_diff, gouts
        grads = list(grads) if bwd is not None else [None] * len(targets)
        entry.param_grads = grads[:len(req)]
        it = iter(grads[len(req):])
        entry.input_grads = [next(it) if s.requires_grad else None
                             for s in static_in]
        entry.fwd_launches, entry.bwd_launches = frec, brec
        _count("captures")

    def _capture_error(self, entry, e):
        return MXNetError(
            f"hybridize: capturing {self._label()} as a CUDA graph failed "
            f"for the signature {entry.sig} ({type(e).__name__}: {e}); on a "
            "CUDA device a hybridized block runs only as a captured graph, "
            "so its forward may not sync with the host (asnumpy(), "
            ".item()) or take a data-dependent shape; hybridize(False) "
            "runs it eagerly")


def _flatten_outputs(outs):
    """Outputs as a flat list of NDArrays and a tree to rebuild them
    (the JAX package's ``block.py:484-500``)."""
    if isinstance(outs, NDArray):
        return [outs], "single"
    if isinstance(outs, (list, tuple)):
        flat, spec = [], []
        for o in outs:
            if isinstance(o, NDArray):
                flat.append(o)
                spec.append(1)
            else:
                sub = list(o)
                flat.extend(sub)
                spec.append(len(sub))
        return flat, ("seq", type(outs).__name__, spec)
    raise MXNetError(f"unsupported forward output type {type(outs)}")


def _flatten_args(args):
    """A call's arguments as flat NDArrays and the tree that regroups
    them (None when every argument is an NDArray), or ``(None, None)``
    when some argument is neither an NDArray nor a list of them."""
    if all(isinstance(a, NDArray) for a in args):
        return list(args), None
    if not all(isinstance(a, NDArray) or (
            isinstance(a, (list, tuple)) and a and
            all(isinstance(x, NDArray) for x in a)) for a in args):
        return None, None
    flat, (kind, typ, spec) = _flatten_outputs(tuple(args))
    return flat, (kind, typ, tuple(spec))


def _unflatten_outputs(flat, tree):
    if tree == "single" or tree is None:
        return flat[0] if len(flat) == 1 else tuple(flat)
    _, typ, spec = tree
    out, i = [], 0
    for n in spec:
        out.append(flat[i] if n == 1 else tuple(flat[i:i + n]))
        i += n
    return tuple(out) if typ == "tuple" else out


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *args, **params)``
    (reference: gluon/block.py:838), cached by :class:`CachedOp` once
    hybridized."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._cached_op_args = {}

    def _drop_cache(self):
        if self._cached_op is not None:
            _count("drops")
        self._cached_op = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Cache this block's forward (reference: gluon/block.py:1039):
        the next call builds a :class:`CachedOp`. Only the outermost
        active block caches: the children are deactivated. Drops any
        earlier cache (and its graphs)."""
        self._active = active
        self._drop_cache()
        self._cached_op_args = dict(static_alloc=static_alloc,
                                    static_shape=static_shape, **kwargs)
        super().hybridize(active=False)

    def _verify_on_hybridize(self, args):
        """``MXNET_GRAPH_VERIFY``-gated trace verification before the
        first CachedOp build (JAX ``gluon/block.py:543-556``): one paused
        eager forward is recorded (``analysis.record_trace``) and the
        dataflow passes (random-stream reuse, in-place writes into saved
        tensors, dead values) disposition per the mode. Once per cache
        build, never on the hot path."""
        from .. import analysis

        if analysis.verify_mode() == "off":
            return
        try:
            report = analysis.verify_block_call(
                self, args, subject=f"hybridize:{self.name}")
        except DeferredInitializationError:
            return  # shapes not known yet; the CachedOp's own pass inits
        report.disposition()

    def infer_shape(self, *args):
        """Finish deferred parameter shapes from example inputs."""
        with autograd.pause():
            self.forward(*args)

    def cast(self, dtype):
        super().cast(dtype)
        self._drop_cache()

    def __call__(self, *args, **kwargs):
        # op hooks force the eager path, so their taps fire on every call
        flat, tree = _flatten_args(args)
        if self._active and flat and not kwargs \
                and not self.__dict__.get("_op_hooks_active", 0):
            if self._cached_op is None:
                self._verify_on_hybridize(args)
                self._cached_op = CachedOp(self, **self._cached_op_args)
            for hook in list(self._mx_forward_pre_hooks):
                hook(self, args)
            with autograd._grad_mode():  # as the eager path's __call__
                out = self._cached_op(*flat, tree=tree)
            for hook in list(self._mx_forward_hooks):
                hook(self, args, out)
            return out
        return super().__call__(*args, **kwargs)

    def forward(self, x, *args):
        """Dispatch to ``hybrid_forward`` with the parameters as keyword
        arguments, finishing deferred initialization from ``x`` first.
        Symbol inputs trace the block through ``sym`` instead (the
        reference's F dispatch, which ``export`` uses)."""
        from .. import symbol as _sym

        if isinstance(x, _sym.Symbol):
            params = {name: _sym.var(param.name)
                      for name, param in self._reg_params.items()}
            return self.hybrid_forward(_sym, x, *args, **params)
        params = {}
        for name, param in self._reg_params.items():
            try:
                params[name] = param.data()
            except DeferredInitializationError:
                self._infer_param_shapes(x, *args)
                params[name] = param.data()
        return self.hybrid_forward(nd, x, *args, **params)

    def _infer_param_shapes(self, x, *args):
        infer = getattr(self, "infer_param_shapes", None)
        if infer is None:
            raise DeferredInitializationError(
                f"{type(self).__name__} has deferred parameters and no "
                "shape-inference hook; call initialize() with known shapes")
        infer(x, *args)
        for p in self._reg_params.values():
            if p._ndarray is None and p._deferred_init is not None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0, input_names=("data",)):
        """Write ``path-symbol.json`` (nnvm JSON, traced with ``F = sym``)
        and ``path-{epoch:04d}.params`` (``arg:``/``aux:``-prefixed full
        names; ``aux`` for the statistics inputs of ``batch_norm``
        nodes), as the JAX package writes them (``block.py:607-648``).
        Loads with ``SymbolBlock.imports`` in either package. Returns the
        params file's name."""
        from .. import symbol as _sym

        out = self(*[_sym.var(n) for n in input_names])
        out.save(f"{path}-symbol.json")
        aux_names = set()
        for s in out._walk():
            if s._op == "batch_norm" and len(s._inputs) >= 5:
                aux_names.update(i._name for i in s._inputs[3:5]
                                 if i._op is None)
        payload = {}
        for name, p in self.collect_params().items():
            tag = "aux" if name in aux_names else "arg"
            payload[f"{tag}:{name}"] = p.data()
        fname = f"{path}-{epoch:04d}.params"
        nd.save(fname, payload)
        return fname

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Hybridize and run once (the JAX package's reading: there is no
        partitioning backend to apply)."""
        self.hybridize()
        return self(x, *args)


class SymbolBlock(HybridBlock):
    """A block over a symbol graph (reference: gluon/block.py:1190; the
    JAX package's ``block.py:655-742``). Every free variable of
    ``outputs`` that is not one of ``inputs`` becomes a parameter of
    that name.

    Each forward evaluates the graph as ``MXNET_GRAPH_OPT`` optimizes
    it. The optimized graph is cached per (level, pipeline version,
    fusion configuration, device, input shapes and dtypes, quantize
    lowering, active autotune records): the fusion
    pass picks each cluster's implementation for the device and the
    shapes it sees, so a graph optimized for the CPU (the replays) is
    never run on the card, and a bucket's shapes are checked against
    what the kernels take. (The JAX package optimizes without shapes;
    here the kernel choice depends on them.) A serving session persists
    these graphs as its programs (``optimized_program``) and installs
    loaded ones (``install_program``), so a warm process runs no graph
    optimizer."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        self._outputs = outputs
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._graph_opt_cache = {}
        self._quantized = None  # whether the graph runs int8 ops
        input_names = {i.name for i in self._inputs}
        for s in outputs._walk():
            if s._op is None and not s._group \
                    and s._name not in input_names \
                    and s._name not in self._reg_params:
                p = self.params.get(s._name, allow_deferred_init=True)
                self._reg_params[s._name] = p
                p._attach(self, s._name)

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, ctx=None):
        """A SymbolBlock from an export: ``symbol_file`` (nnvm JSON) and
        ``param_file`` (``nd.save`` format, keys optionally ``arg:``/
        ``aux:``-prefixed), with the parameters on ``ctx`` (default: the
        current context). ``input_names=None`` takes the data inputs to
        be the graph's free variables the params file does not hold."""
        from .. import cpu
        from .. import symbol as sym

        outputs = sym.load(symbol_file)
        loaded = None
        if param_file is not None:
            # host arrays first: each parameter then lands on ctx once
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v for k, v in
                      nd.load(param_file, ctx=cpu()).items()}
        if input_names is None:
            if loaded is None:
                raise MXNetError(
                    "SymbolBlock.imports(input_names=None) needs param_file "
                    "to tell data inputs from parameters")
            input_names = [n for n in outputs.list_arguments()
                           if n not in loaded]
            if not input_names:
                raise MXNetError(
                    f"no free variables of {symbol_file!r} remain after "
                    f"binding {param_file!r}; pass input_names explicitly")
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(outputs, [sym.var(n) for n in input_names])
        if loaded is not None:
            params = dict(ret.collect_params().items())
            missing = sorted(set(params) - set(loaded))
            extra = sorted(set(loaded) - set(params))
            if missing or extra:
                raise IOError(f"{param_file!r} does not match the graph: "
                              f"missing {missing[:5]}, extra {extra[:5]}")
            for name, arr in loaded.items():
                params[name].set_data(arr, ctx=ctx)
        return ret

    def _runs_quantized(self):
        if self._quantized is None:
            from ..analysis.quantize import graph_has_quantized_ops

            self._quantized = graph_has_quantized_ops(self._outputs)
        return self._quantized

    def _feed(self, args):
        feed = {i.name: a for i, a in zip(self._inputs, args)}
        for name, p in self.collect_params().items():
            feed[name] = p.data()
        return feed

    def _optimized_outputs(self, *args):
        """The output graph as ``MXNET_GRAPH_OPT`` rewrites it for the
        device, shapes and dtypes of ``args`` (the forward's inputs) and
        the parameters; cached (see the class docstring)."""
        return self._optimized_for(self._feed(args))

    def _program_tag(self, feed, level):
        """The optimized-graph cache key of ``feed``: level, pipeline and
        fusion configuration, device, the inputs' shapes and dtypes, the
        quantize lowering and the active autotune records."""
        from .. import autotune
        from ..analysis import graph_opt

        device = next(iter(feed.values())).data.device if feed else None
        return (graph_opt.fingerprint_salt(level), str(device),
                tuple((i.name, tuple(feed[i.name].shape),
                       str(feed[i.name].data.dtype))
                      for i in self._inputs if i.name in feed),
                _quantize.fingerprint_salt(self._runs_quantized(), device),
                autotune.autotune_salt())

    def optimized_program(self, *args):
        """The optimized graph cached for ``args``' shapes (None before
        a forward made it, or when ``MXNET_GRAPH_OPT`` is 0)."""
        from ..analysis import graph_opt

        level = graph_opt.opt_level()
        if level <= 0:
            return None
        return self._graph_opt_cache.get(
            self._program_tag(self._feed(args), level))

    def install_program(self, program, *args):
        """Serve ``program`` (an optimized graph loaded from the artifact
        layer) for ``args``' shapes: the graph optimizer does not run for
        them."""
        from ..analysis import graph_opt

        level = graph_opt.opt_level()
        if level > 0:
            self._graph_opt_cache[
                self._program_tag(self._feed(args), level)] = program

    def _optimized_for(self, feed):
        from ..analysis import graph_opt

        level = graph_opt.opt_level()
        if level <= 0:
            return self._outputs
        tag = self._program_tag(feed, level)
        opt = self._graph_opt_cache.get(tag)
        if opt is None:
            device = next(iter(feed.values())).data.device if feed \
                else None
            opt, _ = graph_opt.optimize_symbol(
                self._outputs,
                shapes={k: tuple(v.shape) for k, v in feed.items()},
                dtypes={k: v.data.dtype for k, v in feed.items()},
                level=level,
                subject=f"hybridize:{self.name or 'symbol_block'}",
                device=device)
            self._graph_opt_cache[tag] = opt
        return opt

    def forward(self, *args):
        feed = self._feed(args)
        return self._optimized_for(feed).eval_with(feed)
