"""Post-training int8 quantization (reference:
python/mxnet/contrib/quantization.py quantize_model/quantize_net over the
quantize_graph_pass.cc rewrite).

The PyTorch counterpart of ``mxnet_tpu/contrib/quantization.py``:

- :func:`quantize_model` — a symbol graph and its parameters: collect
  per-tensor ranges over calibration batches (``naive`` min/max or
  ``entropy``, the KL threshold of :func:`calib_entropy`), rewrite the
  graph through the ``analysis/quantize.py`` passes
  (:func:`quantize_symbol`) and quantize the conv and fc weights
  offline to int8;
- :func:`quantize_net_graph` — a Gluon block traced to a symbol and run
  through :func:`quantize_model`, returned as a ``SymbolBlock`` whose
  consecutive quantizable layers form single int8 regions;
- :func:`quantize_net` — the block-swap form: Dense and Conv2D children
  replaced in place by :class:`QuantizedDense` / :class:`QuantizedConv2D`.

Calibration keeps the statistics on the device: ``naive`` reads two
scalars per tensor, ``entropy`` draws the JAX package's sample indices
(``numpy.random.RandomState(0)``, from the tensor's size alone) on the
host, gathers those elements on the device and copies only them. The
statistics equal the host version's.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ..gluon.block import Block
from ..kernels.int8_conv import int8_conv, int8_mm
from ..ndarray import NDArray
from ..ndarray.ops_nn import cudnn_fp32
from ..ndarray.ops_quant import _matmul_fp32, lowering

__all__ = ["quantize_net", "quantize_net_graph", "QuantizedDense",
           "QuantizedConv2D", "calib_entropy", "quantize_symbol",
           "quantize_model"]


def calib_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence threshold selection (reference: quantization.py
    _get_optimal_threshold / calibrate.cc): the |threshold| minimizing
    KL(P||Q) between the float histogram and its int8 image."""
    hist = onp.asarray(hist, dtype=onp.float64)
    nbins = len(hist)
    best_kl, best_t = None, hist_edges[-1]
    # only thresholds that keep >= 99% of the mass in range: mass piled
    # into the clip bin is exactly representable by Q, so the raw KL
    # would reward absurdly tight clips
    cum = hist.cumsum() / max(hist.sum(), 1e-12)
    start = int(onp.searchsorted(cum, 0.99)) + 1
    start = max(start, num_quantized_bins // 2)
    # at most ~128 candidate thresholds
    stride = max(1, (nbins + 1 - start) // 128)
    bins = onp.arange(num_quantized_bins)
    for i in range(start, nbins + 1, stride):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()  # clip outliers into the edge bin
        q = _expand_quantized(p, i / num_quantized_bins, bins)
        pm = p / max(p.sum(), 1e-12)
        qm = q / max(q.sum(), 1e-12)
        nzmask = pm > 0
        kl = float((pm[nzmask] * onp.log(
            pm[nzmask] / onp.maximum(qm[nzmask], 1e-12))).sum())
        if best_kl is None or kl < best_kl:
            best_kl, best_t = kl, hist_edges[i]
    return best_t


def _expand_quantized(p, factor, bins):
    """The JAX package's loop over the quantized bins, vectorized: bin b
    covers ``p[lo:hi]`` (lo = floor(b * factor), hi = max(ceil((b + 1) *
    factor), lo + 1)); each nonzero entry of ``p`` takes its bin's mass
    over its bin's nonzero count, a later bin overwriting an earlier one
    where they overlap. ``p`` holds histogram counts (integers), so the
    masses are exact whatever the summation order, and ``q`` equals the
    loop's element for element."""
    n = len(p)
    lo = onp.minimum(onp.floor(bins * factor).astype(onp.int64), n)
    hi = onp.minimum(onp.maximum(onp.ceil((bins + 1) * factor)
                                 .astype(onp.int64), lo + 1), n)
    csum = onp.concatenate(([0.0], onp.cumsum(p)))
    cnz = onp.concatenate(([0], onp.cumsum(p > 0)))
    mass = csum[hi] - csum[lo]
    nz = cnz[hi] - cnz[lo]
    # the last bin covering each entry (lo and hi never decrease)
    owner = onp.searchsorted(lo, onp.arange(n), side="right") - 1
    share = mass[owner] / onp.maximum(nz[owner], 1)
    return onp.where(p > 0, share, 0.0)


# -- calibration statistics, kept on the device ------------------------------

class _RangeStats:
    """Per-tensor calibration statistics: the running (min, max) and, in
    entropy mode, the absolute values of ``cap`` elements per tensor and
    batch, sampled as the JAX package samples them (``rng.choice(size,
    cap, replace=False)``, drawn in the order the tensors are seen).
    Only the sampled elements and two scalars per tensor leave the
    device."""

    def __init__(self, mode, cap, rng):
        self.mode = mode
        self.cap = cap
        self.rng = rng
        self.ranges = {}
        self.samples = {}

    def add(self, name, t):
        v = t.detach().reshape(-1).to(torch.float32)
        mn, mx_ = (float(x) for x in torch.aminmax(v))
        cur = self.ranges.get(name)
        self.ranges[name] = (mn, mx_) if cur is None else (
            min(cur[0], mn), max(cur[1], mx_))
        if self.mode == "entropy":
            if v.numel() > self.cap:
                idx = self.rng.choice(v.numel(), self.cap, replace=False)
                v = v[torch.from_numpy(idx).to(v.device)]
            self.samples.setdefault(name, []).append(
                v.abs().cpu().numpy())

    def threshold(self, name, skip_zero=True):
        """The entropy threshold of ``name``; None when every sample is
        zero and ``skip_zero`` (the graph path's rule)."""
        allv = onp.concatenate(self.samples[name])
        if skip_zero and (allv.size == 0 or float(allv.max()) == 0.0):
            return None
        hist, edges = onp.histogram(allv, bins=2048)
        return calib_entropy(hist, edges)


# -- the block-swap wrappers -------------------------------------------------

def _quant_weight(w):
    """int8 codes of the weight NDArray ``w`` and its |max|."""
    amax = float(onp.abs(w.asnumpy()).max())
    scale = 127.0 / max(amax, 1e-20)
    wq = torch.clamp(torch.round(w.data * scale), -127, 127).to(torch.int8)
    return wq, amax


def _quant_input(x, amax):
    """int8 codes of the float input at the calibrated |max|."""
    xscale = 127.0 / max(amax, 1e-20)
    return torch.clamp(torch.round(x * xscale), -127, 127).to(torch.int8)


class _QuantizedBase:
    _act = None

    def _finish(self, acc, x, bshape):
        out = acc.to(torch.float32) * (
            (self._amax / 127.0) * (self._wmax / 127.0))
        if self._bias is not None:
            out = out + self._bias.reshape(bshape)
        res = NDArray(out.to(x.dtype))
        if self._act is not None:
            res = self._act(res)
        return res


class QuantizedDense(_QuantizedBase):
    """int8 x int8 -> int32 product and dequantization (reference:
    quantized_fully_connected.cc). Under the ``native`` lowering on a
    CUDA tensor the product is ``torch._int_mm``; under ``dequant`` a
    float32 product of the codes."""

    def __init__(self, dense, act_range):
        self._units = getattr(dense, "_units", None)
        self._wq, self._wmax = _quant_weight(dense.weight.data())
        self._bias = dense.bias.data().data if dense.bias is not None \
            else None
        self._act = getattr(dense, "act", None)
        self._amax = max(abs(act_range[0]), abs(act_range[1]))
        self._flatten = getattr(dense, "_flatten", True)

    def __call__(self, x):
        xd = x.data
        if self._flatten and xd.dim() > 2:
            xd = xd.reshape(xd.shape[0], -1)
        xq = _quant_input(xd, self._amax)
        if lowering(xq) == "native":
            acc = int8_mm(xq.reshape(-1, xq.shape[-1]), self._wq.t())
            acc = acc.reshape(tuple(xq.shape[:-1]) + (self._wq.shape[0],))
        else:
            with _matmul_fp32(xq):
                acc = torch.round(torch.matmul(
                    xq.to(torch.float32),
                    self._wq.to(torch.float32).t())).to(torch.int32)
        return self._finish(acc, x.data, (-1,))


class QuantizedConv2D(_QuantizedBase):
    """int8 convolution accumulating int32 (reference: quantized_conv.cc):
    under the ``native`` lowering on a CUDA tensor the kernel N2; under
    ``dequant`` a float32 convolution of the codes."""

    def __init__(self, conv, act_range):
        self._wq, self._wmax = _quant_weight(conv.weight.data())
        self._bias = conv.bias.data().data if conv.bias is not None \
            else None
        self._act = getattr(conv, "act", None)
        self._amax = max(abs(act_range[0]), abs(act_range[1]))
        self._strides = tuple(int(s) for s in conv._stride)
        self._padding = tuple(int(p) for p in conv._pad)
        self._groups = conv._groups
        self._dilation = tuple(int(d) for d in conv._dilate)

    def __call__(self, x):
        xq = _quant_input(x.data, self._amax)
        if lowering(xq) == "native":
            acc = int8_conv(xq, self._wq, self._strides, self._padding,
                            self._dilation, self._groups)
        else:
            with cudnn_fp32():
                acc = torch.round(F.conv2d(
                    xq.to(torch.float32), self._wq.to(torch.float32), None,
                    self._strides, self._padding, self._dilation,
                    self._groups)).to(torch.int32)
        return self._finish(acc, x.data, (1, -1, 1, 1))


class _QuantizedShim(Block):
    """Stands in for a quantized child: the tree-walk API (parameters,
    names, cast, summary) goes to the wrapped float32 original, so
    ``save_parameters`` and ``collect_params`` keep working; the forward
    runs the int8 wrapper. The original is not registered as a child (no
    double walk)."""

    def __init__(self, wrapper, original):
        super().__init__(prefix=getattr(original, "prefix", ""))
        object.__setattr__(self, "_wrapper", wrapper)
        object.__setattr__(self, "_original", original)
        self._reg_params = original._reg_params

    @property
    def name(self):
        return getattr(self._original, "name", "quantized")

    @property
    def params(self):
        return self._original.params

    def forward(self, x, *args):
        return self._wrapper(x)

    def collect_params(self, select=None):
        return self._original.collect_params(select)

    def _collect_params_with_prefix(self, prefix=""):
        return self._original._collect_params_with_prefix(prefix)

    def _runs_quantized(self):
        return True

    def cast(self, dtype):
        pass  # the int8 weights are baked

    def hybridize(self, active=True, **kwargs):
        pass  # the wrapper is plain tensor code, capturable as it is

    def initialize(self, *args, **kwargs):
        pass


def _batches(calib_data):
    """The data arrays of each calibration batch (an NDArray, a list or
    tuple, or a DataBatch)."""
    for batch in calib_data:
        if isinstance(batch, NDArray):
            yield [batch]
        elif isinstance(batch, (list, tuple)):
            yield list(batch)
        else:
            yield list(batch.data)


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_batches=None, logger=None):
    """Calibrate, then swap the Dense and (NCHW) Conv2D children for int8
    versions, in place (reference: contrib/quantization.py quantize_net;
    calib_mode ``naive`` = min/max, ``entropy`` = KL threshold; layers
    excluded by name)."""
    from .. import autograd
    from ..gluon import nn

    exclude = set(exclude_layers or [])

    # calibration taps must see eager calls, and a stale CachedOp would
    # keep replaying the float32 graph after the swap
    def dehybridize(block):
        if hasattr(block, "_drop_cache"):
            block._drop_cache()
        if hasattr(block, "_active"):
            block._active = False
        for child in block._children.values():
            dehybridize(child)

    dehybridize(network)

    targets = {}  # (id(parent), child name) -> [parent, name, child]

    def find(block):
        for name, child in list(block._children.items()):
            if isinstance(child, (nn.Dense, nn.Conv2D)) and \
                    child.name not in exclude:
                if isinstance(child, nn.Conv2D) and \
                        child._layout not in (None, "NCHW"):
                    continue  # only NCHW is wired for the int8 conv
                targets[(id(block), name)] = [block, name, child]
            find(child)

    find(network)
    if not targets:
        return network

    # one persistent RNG per call: a fresh RandomState(0) per batch would
    # sample the same positions of equal-size activations every batch
    stats = _RangeStats(calib_mode, 16384, onp.random.RandomState(0))
    hooks = []
    for key, (_, _, child) in targets.items():
        def tap(block, args, _key=key):
            stats.add(_key, args[0].data)

        hooks.append(child.register_forward_pre_hook(tap))
    try:
        if calib_data is not None:
            with autograd.pause():
                n = 0
                if hasattr(calib_data, "reset"):
                    calib_data.reset()
                for datas in _batches(calib_data):
                    network(datas[0])
                    n += 1
                    if num_calib_batches and n >= num_calib_batches:
                        break
    finally:
        for h in hooks:
            h.detach()

    for key, (blk, name, child) in targets.items():
        if key not in stats.ranges:
            continue  # never saw a batch
        rng = stats.ranges[key]
        if calib_mode == "entropy" and stats.samples.get(key):
            t = stats.threshold(key, skip_zero=False)
            rng = (-t, t)
        wrapper = QuantizedDense(child, rng) if isinstance(child, nn.Dense) \
            else QuantizedConv2D(child, rng)
        blk._children[name] = _QuantizedShim(wrapper, child)
    return network


# -- the symbol-graph pass ---------------------------------------------------

def quantize_symbol(sym, excluded_sym_names=(), excluded_op_names=(),
                    calib_ranges=None, quantized_dtype="int8"):
    """Rewrite a Symbol into int8 regions (reference:
    quantize_graph_pass.cc QuantizeGraph; quantization.py
    _quantize_symbol) through ``analysis/quantize.py``'s passes under the
    post-verify rejection net: a bad rewrite gives back the float32
    graph. Returns ``(qsym, offline_weights)``, the latter mapping each
    conv/fc weight variable to the (quantized, min, max) variables the
    caller fills (the reference's ``offline_params``)."""
    from ..analysis import graph_opt
    from ..analysis import quantize as qpass

    auto_dtype = quantized_dtype in ("auto", None)
    if not auto_dtype and quantized_dtype != "int8":
        # a global uint8 would zero every negative activation (the uint8
        # lattice is zero-point-free); only 'auto' selects it, for
        # calibrated non-negative tensors
        raise ValueError("quantized_dtype must be 'int8' or 'auto' "
                         f"(got {quantized_dtype}); 'auto' applies "
                         "uint8 to provably non-negative tensors")
    with qpass.quantize_scope(
            excluded_sym_names=excluded_sym_names,
            excluded_op_names=excluded_op_names,
            calib_ranges=calib_ranges or {},
            auto_dtype=auto_dtype) as scope:
        qsym, stats = graph_opt.optimize_symbol(
            sym, level=1, subject="quantize", passes=qpass.QUANTIZE_PIPELINE,
            device="cpu")
        if scope.islands == 0 or stats.get("rejected"):
            # nothing quantizable, or the rejection net threw the rewrite
            # out: the float32 graph, unchanged
            return sym, {}
        return qsym, dict(scope.offline)


def _collect_layer_statistics(sym, feed, calib_data, data_names,
                              calib_mode, num_calib_batches=None,
                              logger=None):
    """Run the float32 graph over the calibration batches and collect
    per-tensor ranges (reference: quantization.py
    _collect_layer_statistics): ``{tensor name: (min, max)}``, on the
    device the feed lives on."""
    from .. import autograd
    from ..symbol import _DEVICE

    internals = sym.get_internals()
    nodes = [s for s in internals._group if s._op is not None]
    stats = _RangeStats(calib_mode, 8192, onp.random.RandomState(0))
    device = next((v.data.device for v in feed.values()
                   if isinstance(v, NDArray)), None)
    n = 0
    with autograd.pause(train_mode=False), torch.no_grad():
        for datas in _batches(calib_data):
            f = dict(feed)
            for dn_, d in zip(data_names, datas):
                f[dn_] = d
            cache = {_DEVICE: device if device is not None else
                     next((v.data.device for v in datas
                           if isinstance(v, NDArray)), None)}
            for s in nodes:
                out = s._eval_nodes(f, cache)
                outs = out if isinstance(out, (list, tuple)) else [out]
                for nm, o in zip(s.list_outputs(), outs):
                    stats.add(nm, o.data)
            n += 1
            if num_calib_batches and n >= num_calib_batches:
                break
    ranges = dict(stats.ranges)
    if calib_mode == "entropy":
        for nm in stats.samples:
            t = stats.threshold(nm)
            if t is not None:
                ranges[nm] = (-t, t)
    if logger:
        logger.info("collected ranges for %d tensors over %d batches",
                    len(ranges), n)
    return ranges


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=(), excluded_op_names=(),
                   calib_mode="naive", calib_data=None,
                   num_calib_batches=None, quantized_dtype="int8",
                   logger=None):
    """Post-training quantization of a symbolic model (reference:
    contrib/quantization.py quantize_model): ``(qsym, qarg_params,
    aux_params)``. ``calib_mode``: ``none`` (ranges computed per batch at
    run time), ``naive`` (min/max over ``calib_data``) or ``entropy``
    (the KL threshold per tensor)."""
    from .. import nd
    from ..analysis import quantize as qpass

    calib_ranges = {}
    if calib_mode != "none":
        if calib_data is None:
            raise ValueError(f"calib_mode='{calib_mode}' needs calib_data")
        feed = {}
        for k, v in list(arg_params.items()) + list(aux_params.items()):
            feed[k] = v
        calib_ranges = _collect_layer_statistics(
            sym, feed, calib_data, data_names, calib_mode,
            num_calib_batches, logger)
    qsym, offline = quantize_symbol(
        sym, excluded_sym_names=excluded_sym_names,
        excluded_op_names=excluded_op_names, calib_ranges=calib_ranges,
        quantized_dtype=quantized_dtype)

    qarg = dict(arg_params)
    for wname, (qn, mnn, mxn) in offline.items():
        w = arg_params[wname]
        wv = w.asnumpy()
        amax = float(onp.abs(wv).max()) or 1e-20
        scale = 127.0 / amax
        ctx = w.context
        qarg[qn] = nd.array(
            onp.clip(onp.rint(wv * scale), -127, 127).astype("int8"),
            ctx=ctx, dtype="int8")
        qarg[mnn] = nd.array(onp.array([-amax], onp.float32), ctx=ctx)
        qarg[mxn] = nd.array(onp.array([amax], onp.float32), ctx=ctx)
        # float32 -> int8 storage: 3 of every 4 weight bytes stop moving
        qpass._count("weight_bytes_saved", 3 * int(wv.size))
    # drop a float32 weight only if no surviving node reads it (tied or
    # partly excluded weights keep their float32 binding)
    still_needed = set(qsym.list_arguments())
    for wname in offline:
        if wname not in still_needed:
            del qarg[wname]
    return qsym, qarg, dict(aux_params)


def quantize_net_graph(network, calib_data=None, calib_mode="naive",
                       quantized_dtype="int8", exclude_layers=(),
                       exclude_layers_match=(), exclude_operators=(),
                       num_calib_batches=None, input_names=("data",),
                       logger=None):
    """Graph-mode Gluon quantization (reference: quantization.py
    quantize_net: trace the HybridBlock to a symbol, run quantize_model,
    return a SymbolBlock). Consecutive quantizable layers form single
    int8 regions. ``exclude_layers`` matches traced node names,
    ``exclude_layers_match`` substrings of them, ``exclude_operators``
    op types ('pooling', 'batch_norm', ...). The parameters stay on the
    device they were on."""
    from .. import autograd
    from .. import symbol as S
    from ..gluon.block import SymbolBlock

    # deferred-init parameters need one eager forward to learn their
    # shapes before the symbolic trace
    try:
        needs_shape = any(p._ndarray is None
                          for p in network.collect_params().values())
    except Exception:
        needs_shape = True
    if needs_shape:
        if calib_data is None:
            raise ValueError(
                "network has uninitialized (deferred) parameters; pass "
                "calib_data so a shape-materializing forward can run")
        first = calib_data[0] if isinstance(calib_data, (list, tuple)) \
            else next(iter(calib_data))
        datas = [first] if isinstance(first, NDArray) else (
            list(first) if isinstance(first, (list, tuple))
            else list(first.data))
        with autograd.pause(train_mode=False):
            network(*datas[:len(input_names)])
        if hasattr(calib_data, "reset"):
            calib_data.reset()

    out = network(*[S.var(n) for n in input_names])
    if isinstance(out, (list, tuple)):
        out = S.Group(list(out))
    exclude_layers = set(exclude_layers)
    if exclude_layers_match:
        for s in out._walk():
            nm = s._name or ""
            if s._op is not None and any(pat in nm
                                         for pat in exclude_layers_match):
                exclude_layers.add(nm)
    aux_names = set()
    for s in out._walk():
        if s._op == "batch_norm" and len(s._inputs) >= 5:
            aux_names.update(i._name for i in s._inputs[3:5]
                             if i._op is None)
    arg_params, aux_params = {}, {}
    for name, p in network.collect_params().items():
        (aux_params if name in aux_names else arg_params)[name] = p.data()

    qsym, qarg, qaux = quantize_model(
        out, arg_params, aux_params, data_names=tuple(input_names),
        excluded_sym_names=tuple(exclude_layers),
        excluded_op_names=tuple(exclude_operators),
        calib_mode=calib_mode, calib_data=calib_data,
        num_calib_batches=num_calib_batches,
        quantized_dtype=quantized_dtype, logger=logger)

    block = SymbolBlock(qsym, [S.var(n) for n in input_names])
    params = block.collect_params()
    for name, val in {**qarg, **qaux}.items():
        if name in params:
            p = params[name]
            # the dtype before the value, so int8 weights stay int8; an
            # integer parameter takes no gradient
            p.dtype = val.dtype
            if not onp.issubdtype(val.dtype, onp.floating):
                p.grad_req = "null"
            p._load_init_from(val, ctx=val.context)
    return block
