"""The NDArray and op surface of the PyTorch port against the JAX package,
on the CPU.

- Every op of ``ops_basic``, ``ops_index``, ``ops_nn`` and ``ops_legacy``
  that the port registers runs on the same inputs (drawn from a numpy
  seed) in both packages, one parametrised case per op and setting (the
  cases of ``mxnet_tpu_torch/tools/op_sweep.py``, which the card's op
  sweep runs too), and
  its gradient (a random cotangent pulled back through the op: ``jax.vjp``
  of the JAX op's body against ``torch.autograd.grad`` of the port's)
  where the op is differentiable. Tolerances, each relative to the
  reference's own magnitude, plus the same fraction of the array's
  largest magnitude for entries near zero:

  - exact ops (indexing, reshapes, gathers, ``sort``, ``topk``,
    ``one_hot``, ``take``, ``pad``, ``tile``, the maxima): bitwise;
  - elementwise float math: rtol 1e-6;
  - reductions, products and the transcendentals where XLA and torch
    differ (``digamma``, ``erfinv``, ``gammaln``): rtol 1e-5;
  - ``ctc_loss``: rtol 1e-4.

  Gradients of exact ops sum a few terms: rtol 1e-6.
- MXNet's Python operators: the rows of ROADMAP C's fault 1 table, the
  comparisons' dtype, ``%``, ``**``, ``@``, ``abs``, the scalar
  conversions, hashing, and the in-place operators, which write into the
  handle's tensor (so ``Parameter.data()`` moves), raise inside
  ``record()``, and rebind where the result's dtype changes.
- The fluent methods, indexing (index arrays, negative steps) and
  assignment, the new ``nd`` functions, the ``sym`` mirrors and their
  shape rules, and the deliberate differences (``pick``'s clip, the
  ``topk`` tie rule, ``bilinear_resize2d``'s corners, the deferred
  sparse and ``mx.np`` conversions, no ``from_jax``).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import registry as treg
from mxnet_tpu_torch.tools.op_sweep import (BASIC, ELEM, EXACT, INDEX,
                                            LEGACY, NN, REDUCE, f32)

CPU = mx.cpu()


def _close(got, want, tol, what=""):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if tol == EXACT:
        onp.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(onp.max(onp.abs(want))) if want.size else 1.0
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                err_msg=what)


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _run(case):
    rs = case.rng()
    arrays = case.make(rs)
    jout = _outs(jreg.invoke(jreg.get_op(case.op),
                             [jnd.array(a, dtype=a.dtype) for a in arrays],
                             dict(case.kw)))
    tout = _outs(treg.invoke(treg.get_op(case.op),
                             [nd.array(a, ctx=CPU, dtype=a.dtype)
                              for a in arrays], dict(case.kw)))
    assert len(tout) == len(jout)
    for i, (t, j, tol) in enumerate(zip(tout, jout, case.tols(len(jout)))):
        _close(t.asnumpy(), j.asnumpy(), tol, f"{case.id} output {i}")
    if not case.diff:
        return
    ct = rs.standard_normal(jout[case.out].shape).astype("float32")
    jfn, tfn = jreg.get_op(case.op).fn, treg.get_op(case.op).fn

    def jf(*d):
        xs = [jnp.asarray(a) for a in arrays]
        for i, v in zip(case.diff, d):
            xs[i] = v
        return _outs(jfn(*xs, **case.kw))[case.out]

    _, vjp = jax.vjp(jf, *[jnp.asarray(arrays[i]) for i in case.diff])
    jgrads = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    leaves = []
    for i in case.diff:
        xs[i].requires_grad_(True)
        leaves.append(xs[i])
    with torch.enable_grad():
        y = _outs(tfn(*xs, **case.kw))[case.out]
        tgrads = torch.autograd.grad(y, leaves, torch.from_numpy(ct))
    for i, t, j in zip(case.diff, tgrads, jgrads):
        _close(t.numpy(), onp.asarray(j), case.grad_tol,
               f"{case.id} gradient of input {i}")


def _ids(cases):
    return [c.id for c in cases]


# -- ops_basic ------------------------------------------------------------

@pytest.mark.parametrize("case", BASIC, ids=_ids(BASIC))
def test_ops_basic_match_jax(case):
    _run(case)


# -- ops_index ------------------------------------------------------------

@pytest.mark.parametrize("case", INDEX, ids=_ids(INDEX))
def test_ops_index_match_jax(case):
    _run(case)


# -- ops_nn ---------------------------------------------------------------

@pytest.mark.parametrize("case", NN, ids=_ids(NN))
def test_ops_nn_match_jax(case):
    _run(case)


# -- ops_legacy -----------------------------------------------------------

@pytest.mark.parametrize("case", LEGACY, ids=_ids(LEGACY))
def test_ops_legacy_match_jax(case):
    _run(case)


# -- the registry, nd and sym ---------------------------------------------

_FILES = ("ops_basic", "ops_index", "ops_random", "ops_nn", "ops_legacy")


def _jax_ops_of(files):
    return sorted(n for n in jreg.list_ops()
                  if jreg.get_op(n).fn.__module__.rsplit(".", 1)[-1]
                  in files)


@pytest.mark.parametrize("fname", _FILES)
def test_every_op_of_the_file_is_in_the_registry_nd_and_sym(fname):
    names = _jax_ops_of((fname,))
    assert names
    missing = [n for n in names if treg.get_op(n) is None]
    assert not missing
    not_nd = [n for n in names if "nd" in jreg.get_op(n).namespaces
              and not hasattr(nd, n)]
    assert not not_nd
    not_sym = [n for n in names if "nd" in jreg.get_op(n).namespaces
               and not hasattr(sym, n)]
    assert not not_sym


def test_the_reference_spellings_match_jax():
    from mxnet_tpu_torch.ndarray import _CAMEL_ALIASES

    for alias in ("Deconvolution", "GroupNorm", "InstanceNorm", "LRN",
                  "UpSampling", "Pad", "L2Normalization", "SVMOutput",
                  "ROIPooling", "SpatialTransformer", "BilinearSampler",
                  "GridGenerator", "Correlation", "Crop",
                  "IdentityAttachKLSparseReg"):
        assert hasattr(nd, alias) and hasattr(sym, alias), alias
        assert _CAMEL_ALIASES[alias] == jnd._CAMEL_ALIASES[alias]


def test_sym_mirrors_evaluate_and_infer_like_jax():
    """``sym`` graphs over the new ops: deconvolution and group_norm with
    their parameters made by the shape rules (group_norm's per group),
    topk with both outputs, moments' two outputs, against the JAX
    package's graph of the same JSON."""
    import mxnet_tpu as jmx

    def graph(S):
        x = S.var("data")
        d = S.Deconvolution(x, kernel=(3, 3), stride=(2, 2), num_filter=4,
                            name="up")
        g = S.GroupNorm(d, num_groups=2, name="gn")
        t = S.topk(S.flatten(g, name="flat"), k=3, ret_typ="both",
                   name="top")
        return S.Group([t[0], t[1], S.smooth_l1(g, name="sl1")])

    tg, jg = graph(sym), graph(jmx.sym)
    assert tg.list_outputs() == jg.list_outputs()
    args, outs, _ = tg.infer_shape(data=(2, 3, 4, 4))
    # the JAX package's rule gives group_norm per-channel parameters,
    # which its op cannot take (ROADMAP C): there they are given
    jargs, jouts, _ = jg.infer_shape(data=(2, 3, 4, 4), gn_gamma=(2,),
                                     gn_beta=(2,))
    assert args == [tuple(s) for s in jargs]
    assert outs == [tuple(s) for s in jouts]
    shapes = dict(zip(tg.list_arguments(), args))
    assert shapes["gn_gamma"] == (2,) and shapes["up_weight"] == (3, 4, 3, 3)
    rs = onp.random.RandomState(3)
    feed = {n: f32(rs, *s) for n, s in shapes.items()}
    tout = tg.eval(ctx=CPU, **{k: nd.array(v, ctx=CPU)
                               for k, v in feed.items()})
    jout = jg.eval(**{k: jnd.array(v) for k, v in feed.items()})
    for i, (t, j) in enumerate(zip(tout, jout)):
        _close(t.asnumpy(), j.asnumpy(), REDUCE if i != 1 else EXACT,
               f"output {i}")
    # moments has two outputs (the JAX package's symbol counts one)
    m = sym.moments(sym.var("x"), axes=(0,), name="mom")
    assert m.list_outputs() == ["mom_output0", "mom_output1"]
    _, mshapes, _ = sym.Group([m[0], m[1]]).infer_shape(x=(3, 4))
    assert mshapes == [(4,), (4,)]
    h = sym.histogram(sym.var("x"), bins=4, range=(0.0, 1.0))
    assert len(h.list_outputs()) == 2


# -- MXNet's Python operators (ROADMAP C, fault 1) ------------------------

def _pair(arr):
    return nd.array(arr, ctx=CPU), jnd.array(arr)


def test_in_place_update_moves_the_parameter():
    """Fault 1's first row: ``w = p.data(); w -= lr * p.grad()`` moves the
    weights (the JAX package's handle swap moves them too)."""
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    x = nd.array(onp.ones((2, 4), "float32"), ctx=CPU)
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    p = net.weight
    before = p.data().asnumpy().copy()
    leaf = p.data().data
    w = p.data()
    w -= 0.1 * p.grad()
    onp.testing.assert_array_equal(
        p.data().asnumpy(), (nd.array(before, ctx=CPU)
                             - 0.1 * p.grad()).asnumpy())
    assert p.data() is w and p.data().data is leaf  # the registered leaf
    assert not onp.array_equal(p.data().asnumpy(), before)
    # and through the JAX package, the same update
    # an explicit prefix: the JAX package's name counters are process-wide
    # (ROADMAP C, positional checkpoints)
    jnet = jmx.gluon.nn.Dense(3, in_units=4, prefix="inplace_")
    jnet.initialize()
    jnet.weight.set_data(jnd.array(before))
    jnet.bias.set_data(jnd.array(net.bias.data().asnumpy()))
    with jmx.autograd.record():
        jl = jnet(jnd.array(onp.ones((2, 4), "float32"))).sum()
    jl.backward()
    jw = jnet.weight.data()
    jw -= 0.1 * jnet.weight.grad()
    onp.testing.assert_array_equal(p.data().asnumpy(),
                                   jnet.weight.data().asnumpy())


@pytest.mark.parametrize("value,want", [([0.0], False), ([2.0], True),
                                        ([], False)])
def test_bool_of_an_array_matches_jax(value, want):
    t, j = _pair(onp.asarray(value, "float32"))
    assert bool(t) is want and bool(j) is want


def test_bool_of_many_elements_raises_as_jax():
    t, j = _pair(onp.zeros(2, "float32"))
    with pytest.raises(ValueError):
        bool(j)
    with pytest.raises(ValueError):
        bool(t)


@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
@pytest.mark.parametrize("other", ["scalar", "array", "broadcast"])
def test_comparisons_match_jax(op, other):
    rs = onp.random.RandomState(7)
    a = onp.round(rs.uniform(0, 3, (3, 4))).astype("float32")
    b = {"scalar": 1.0, "array": onp.round(rs.uniform(0, 3, (3, 4)))
         .astype("float32"),
         "broadcast": onp.round(rs.uniform(0, 3, (1, 4))).astype("float32")
         }[other]
    ta, ja = _pair(a)
    tb, jb = (b, b) if other == "scalar" else _pair(b)
    got, want = eval(f"ta {op} tb"), eval(f"ja {op} jb")
    assert str(got.dtype) == str(want.dtype) == "float32"
    _close(got.asnumpy(), want.asnumpy(), EXACT)


def test_equality_with_a_number_is_elementwise():
    """Fault 1's last row: ``nd.array([1., 2.]) == 1`` is [1, 0], not
    False."""
    t, j = _pair(onp.asarray([1.0, 2.0], "float32"))
    _close((t == 1).asnumpy(), (j == 1).asnumpy(), EXACT)
    assert (t == 1).asnumpy().tolist() == [1.0, 0.0]
    assert (t == None) is False  # noqa: E711 — not an array: identity


@pytest.mark.parametrize("expr", ["a % b", "a % 0.7", "2.5 % a", "a ** b",
                                  "a ** 2", "2 ** a", "abs(a)", "a @ m",
                                  "-a"])
def test_binary_operators_match_jax(expr):
    rs = onp.random.RandomState(11)
    arr = {"a": rs.uniform(0.5, 2, (3, 4)).astype("float32"),
           "b": rs.uniform(-2, 2, (3, 4)).astype("float32"),
           "m": rs.uniform(-1, 1, (4, 2)).astype("float32")}
    tenv = {k: nd.array(v, ctx=CPU) for k, v in arr.items()}
    jenv = {k: jnd.array(v) for k, v in arr.items()}
    got, want = eval(expr, {}, tenv), eval(expr, {}, jenv)
    tol = REDUCE if "@" in expr or "**" in expr else ELEM
    _close(got.asnumpy(), want.asnumpy(), tol, expr)


def test_scalar_conversions_and_hash():
    t, j = _pair(onp.asarray([2.75], "float32"))
    assert float(t) == float(j) == 2.75
    assert int(t) == int(j) == 2
    assert t.item() == j.item()
    assert hash(t) == id(t)
    other = nd.array([2.75], ctx=CPU)
    assert len({t, other}) == 2
    assert {t: 1}[t] == 1
    assert t in [t]


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
@pytest.mark.parametrize("other", ["scalar", "array", "broadcast", "list"])
def test_in_place_operators_match_jax_and_keep_the_tensor(op, other):
    rs = onp.random.RandomState(5)
    a = rs.uniform(0.5, 2, (3, 4)).astype("float32")
    b = {"scalar": 1.5,
         "array": rs.uniform(0.5, 2, (3, 4)).astype("float32"),
         "broadcast": rs.uniform(0.5, 2, (1, 4)).astype("float32"),
         "list": [0.5, 1.0, 1.5, 2.0]}[other]
    t, j = _pair(a)
    tb = nd.array(b, ctx=CPU) if other in ("array", "broadcast") else b
    jb = jnd.array(b) if other in ("array", "broadcast") else b
    tensor = t.data
    handle = t
    exec(f"t {op} tb")
    exec(f"j {op} jb")
    assert t is handle and t.data is tensor
    _close(t.asnumpy(), j.asnumpy(), EXACT, op)


def test_in_place_on_an_int_array_with_a_float_rebinds_as_jax():
    """The result has another dtype: the handle rebinds (int32 += 0.5 is
    float32 [1.5, 2.5], the JAX package's answer)."""
    t, j = _pair(onp.asarray([1, 2], "int32"))
    tensor = t.data
    t += 0.5
    j += 0.5
    assert str(t.dtype) == str(j.dtype) == "float32"
    _close(t.asnumpy(), j.asnumpy(), EXACT)
    assert t.asnumpy().tolist() == [1.5, 2.5]
    assert t.data is not tensor and tensor.dtype == torch.int32


def test_in_place_into_a_broadcast_view_rebinds():
    x = nd.array(onp.ones((1, 3), "float32"), ctx=CPU)
    y = x.broadcast_to((2, 3))
    y += 1.0
    assert y.asnumpy().tolist() == [[2.0] * 3] * 2
    assert x.asnumpy().tolist() == [[1.0] * 3]


@pytest.mark.parametrize("make", [
    "x.T", "x.swapaxes(0, 1)", "x.expand_dims(0)", "x.reshape((6,))",
    "x[0:1]", "m.stop_gradient(x)", "m.BlockGrad(x)", "m.make_loss(x)",
    "m.Dropout(x, p=0.5)", "m.reshape(x, shape=None)"])
def test_in_place_on_an_array_made_from_another_leaves_that_one_as_jax(make):
    """``y`` shares ``x``'s memory in torch (a view, or ``x`` passed
    through): ``y += 1`` rebinds ``y`` and leaves ``x`` as it was, as in
    the JAX package, whose handles never alias."""
    a = onp.arange(6, dtype="float32").reshape(2, 3)
    for m, x in ((nd, nd.array(a, ctx=CPU)), (jnd, jnd.array(a))):
        y = eval(make)
        want = y.asnumpy() + 1
        y += 1
        assert x.asnumpy().tolist() == a.tolist(), (make, m.__name__)
        onp.testing.assert_array_equal(y.asnumpy(), want)


_COPY_VIEWS = ["x.T", "x.swapaxes(0, 1)", "x.expand_dims(0)",
               "m.expand_dims(x, axis=0)",
               "m.broadcast_to(x[0:1], shape=(4, 3))",
               "m.stop_gradient(x)", "m.BlockGrad(x)", "m.make_loss(x)",
               "m.Dropout(x, p=0.5)", "m.transpose(x)", "x.T.T",
               "x[0:1].T"]


@pytest.mark.parametrize("write", ["x += 1", "x[:] = 7", "x[0, 1] = 7",
                                   "x2.copyto(x)"])
@pytest.mark.parametrize("make", _COPY_VIEWS)
def test_in_place_into_an_array_leaves_one_made_from_it_as_jax(make, write):
    """``y`` comes from an op that torch would answer with a view of
    ``x``'s memory, and the port copies: a write into ``x`` leaves ``y``
    as it was made, as in the JAX package (whose handles never alias)
    and in MXNet."""
    a = onp.arange(6, dtype="float32").reshape(2, 3)
    for m, x in ((nd, nd.array(a, ctx=CPU)), (jnd, jnd.array(a))):
        x2 = m.array(a + 10) if m is jnd else nd.array(a + 10, ctx=CPU)
        y = eval(make)
        want = y.asnumpy().copy()
        exec(write)
        onp.testing.assert_array_equal(y.asnumpy(), want,
                                       err_msg=f"{make}; {write}; "
                                       f"{m.__name__}")
        assert not onp.array_equal(x.asnumpy(), a)


@pytest.mark.parametrize("make", _COPY_VIEWS[:3])
def test_a_write_into_a_view_that_stands_for_a_copy_leaves_its_source(make):
    x = nd.array(onp.arange(6, dtype="float32").reshape(2, 3), ctx=CPU)
    m = nd
    y = eval(make)
    y[:] = -1
    assert x.asnumpy().tolist() == [[0, 1, 2], [3, 4, 5]]
    assert (y.asnumpy() == -1).all()


@pytest.mark.parametrize("make", ["x.reshape((3, 2))", "x[0:1]",
                                  "x.detach()", "x.T.reshape((6,))",
                                  "x.T[0:2]"])
def test_reshape_slice_and_detach_share_memory_as_mxnet(make):
    """MXNet's own sharing stays: ``reshape``, a basic slice and
    ``detach`` see a later write into their source (``x.T`` first takes
    its own copy, which the second one shares)."""
    x = nd.array(onp.arange(6, dtype="float32").reshape(2, 3), ctx=CPU)
    src = x.T if ".T" in make else x
    y = eval(make.replace("x.T", "src"))
    src += 100
    assert (y.asnumpy() >= 100).all(), make
    if src is not x:
        assert x.asnumpy().max() == 5


def test_a_parameter_sees_an_in_place_write_with_a_view_alive():
    """The registered leaf still takes the write while ``w.T`` lives;
    the view keeps the old values."""
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    w = net.weight.data()
    leaf = w.data
    before = w.asnumpy().copy()
    wt = w.T
    w -= 1.0
    assert net.weight.data().data is leaf
    onp.testing.assert_array_equal(leaf.detach().numpy(), before - 1.0)
    onp.testing.assert_array_equal(wt.asnumpy(), before.T)


@pytest.mark.parametrize("writer", ["sgd_update", "trainer_step",
                                    "set_data"])
def test_the_writers_of_a_weight_leave_its_transpose_as_jax(writer):
    """``wt = w.T`` made before an optimizer update op, a Trainer step or
    ``Parameter.set_data`` keeps the values it was made with, in both
    packages."""
    for pkg in (mx, jmx):
        ctx = pkg.cpu()
        pkg.random.seed(0)
        net = pkg.gluon.nn.Dense(3, in_units=2)
        net.initialize(ctx=ctx)
        w = net.weight.data()
        wt = w.T
        before = wt.asnumpy().copy()
        if writer == "sgd_update":
            pkg.nd.sgd_update(w, pkg.nd.ones((3, 2), ctx=ctx), lr=0.5,
                              wd=0.0)
        elif writer == "trainer_step":
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.5})
            with pkg.autograd.record():
                loss = net(pkg.nd.ones((4, 2), ctx=ctx)).sum()
            loss.backward()
            trainer.step(1)
            assert not onp.array_equal(net.weight.data().asnumpy(),
                                       before.T)
        else:
            net.weight.set_data(pkg.nd.zeros((3, 2), ctx=ctx))
        onp.testing.assert_array_equal(wt.asnumpy(), before,
                                       err_msg=pkg.__name__)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_in_place_inside_record_raises_as_jax(op):
    t = nd.array(onp.ones(3, "float32"), ctx=CPU)
    j = jnd.array(onp.ones(3, "float32"))
    with jmx.autograd.record():
        with pytest.raises(jmx.base.MXNetError):
            exec(f"j {op} 2.0")
    with autograd.record():
        with pytest.raises(MXNetError):
            exec(f"t {op} 2.0")
    assert t.asnumpy().tolist() == [1.0] * 3


# -- fluent methods -------------------------------------------------------

_UNARY = ["abs", "exp", "expm1", "log", "log1p", "log10", "log2", "sqrt",
          "rsqrt", "square", "cbrt", "rcbrt", "reciprocal", "sign", "round",
          "rint", "ceil", "floor", "trunc", "fix", "relu", "sigmoid", "tanh",
          "softmax", "log_softmax", "sin", "cos", "tan", "arcsin", "arccos",
          "arctan", "sinh", "cosh", "arcsinh", "degrees", "radians", "erf",
          "erfinv", "gamma", "gammaln", "softmin", "flatten", "zeros_like",
          "ones_like", "argmax_channel", "shape_array", "size_array",
          "nansum", "nanprod", "max", "min", "prod", "argmax", "argmin",
          "norm", "sort", "argsort", "topk", "flip"]
# (method, args, kwargs) for the methods that take arguments
_WITH_ARGS = [
    ("arccosh", (), {}), ("arctanh", (), {}), ("clip", (0.6, 0.9), {}),
    ("reshape_like", ("other",), {}), ("swapaxes", (0, 1), {}),
    ("expand_dims", (1,), {}), ("broadcast_to", ((2, 3, 4),), {}),
    ("broadcast_like", ("big",), {}), ("slice_axis", (1, 1, 3), {}),
    ("take", ("index",), {}), ("one_hot", (5,), {}),
    ("pick", ("index",), {}), ("tile", ((2, 1),), {}),
    ("repeat", (2,), {"axis": 0}),
    ("pad", (), {"mode": "constant", "pad_width": (1, 0, 0, 2)}),
    ("broadcast_axes", (), {"axis": 0, "size": 2}),
    ("slice", ((0, 1), (2, 4)), {}), ("slice_like", ("other",), {}),
    ("split", (2,), {"axis": 1}), ("split_v2", (2,), {"axis": 1}),
    ("diag", (), {}), ("sum", (), {"axis": 1, "exclude": True}),
    ("mean", (), {"axis": 0}),
    ("depth_to_space", (2,), {}), ("space_to_depth", (2,), {}),
]


def _method_case(name, args, kwargs):
    rs = onp.random.RandomState(13)
    base = rs.uniform(0.55, 0.95, (3, 4)).astype("float32")
    if name in ("arccosh",):
        base = base + 1.0
    if name in ("depth_to_space",):
        base = rs.uniform(0.5, 0.9, (1, 4, 2, 2)).astype("float32")
    if name in ("space_to_depth",):
        base = rs.uniform(0.5, 0.9, (1, 1, 4, 4)).astype("float32")
    if name in ("broadcast_to", "broadcast_like", "broadcast_axes"):
        base = base[None]
    extra = {"other": rs.uniform(0, 1, (4, 3)).astype("float32"),
             "big": rs.uniform(0, 1, (2, 3, 4)).astype("float32"),
             "index": onp.asarray([2, 0, 3], "float32")}
    if name == "slice_like":
        extra["other"] = rs.uniform(0, 1, (2, 3)).astype("float32")
    if name == "take":
        extra["index"] = onp.asarray([2, 0], "float32")

    def call(x, wrap):
        a = [wrap(extra[v]) if isinstance(v, str) else v for v in args]
        return getattr(x, name)(*a, **kwargs)

    tout = call(nd.array(base, ctx=CPU), lambda v: nd.array(v, ctx=CPU))
    jout = call(jnd.array(base), jnd.array)
    return _outs(tout), _outs(jout)


_METHOD_CASES = [(m, (), {}) for m in _UNARY] + _WITH_ARGS


@pytest.mark.parametrize("name,args,kwargs", _METHOD_CASES,
                         ids=[c[0] for c in _METHOD_CASES])
def test_fluent_methods_match_jax(name, args, kwargs):
    touts, jouts = _method_case(name, args, kwargs)
    tol = REDUCE if name in ("erfinv", "gammaln", "gamma", "norm", "prod",
                             "nanprod", "sum", "mean", "nansum", "softmax",
                             "log_softmax", "softmin", "tan", "arctanh",
                             "arccosh") else ELEM
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        _close(t.asnumpy(), j.asnumpy(), tol, name)


def test_properties_and_transfers():
    rs = onp.random.RandomState(2)
    a = rs.uniform(0, 1, (2, 3)).astype("float32")
    t, j = _pair(a)
    _close(t.T.asnumpy(), j.T.asnumpy(), EXACT)
    assert t.ctx == CPU and t.stype == j.stype == "default"
    assert t.wait_to_write() is t
    assert t.asnative() is t.data
    assert t.as_nd_ndarray() is t and t.tostype("default") is t
    back = nd.from_dlpack(t.to_dlpack_for_read())
    _close(back.asnumpy(), a, EXACT)
    w = nd.from_dlpack(t.to_dlpack_for_write())
    w[0, 0] = 5.0  # the writer's capsule is the array's memory
    assert t.asnumpy()[0, 0] == 5.0


@pytest.mark.parametrize("what", ["as_np_ndarray", "csr", "row_sparse"])
def test_sparse_and_np_conversions_wait_for_slice_11(what):
    """``as_np_ndarray`` still waits for the ``mx.np`` part of slice 11;
    the sparse conversions are ported (``tests/test_torch_sparse.py``)."""
    t = nd.array(onp.ones((2, 2), "float32"), ctx=CPU)
    if what == "as_np_ndarray":
        with pytest.raises(MXNetError, match="mx.np .*slice 11"):
            t.as_np_ndarray()
        return
    s = t.tostype(what)
    assert s.stype == what and s.shape == (2, 2) and s.context == CPU
    assert s.asnumpy().tolist() == [[1.0, 1.0], [1.0, 1.0]]


# -- indexing and assignment ----------------------------------------------

_KEYS = {
    "int": lambda W: 1,
    "slice": lambda W: slice(1, 3),
    "int_pair": lambda W: (slice(None), 2),
    "ellipsis": lambda W: (Ellipsis, 1),
    "newaxis": lambda W: (None, 0),
    "reversed": lambda W: slice(None, None, -1),
    "negative_step": lambda W: (slice(None), slice(3, 0, -2)),
    "ellipsis_negative": lambda W: (Ellipsis, slice(None, None, -2)),
    "list": lambda W: W([0, 2], True),
    "array_float": lambda W: W([2.0, 0.0, 1.0], False),
    "list_second_axis": lambda W: (slice(None), W([3, 0], True)),
    "array_and_negative": lambda W: (W([1.0, 0.0], False),
                                     slice(None, None, -1)),
    "bool_mask": lambda W: onp.asarray([True, False, True]),
}


def _tkey(v, as_list):
    """The port's index: a Python list as it is, else an NDArray."""
    return list(v) if as_list else nd.array(v, ctx=CPU)


def _jkey(v, as_list):
    """The JAX package's: jnp takes no list index, so a numpy array."""
    return onp.asarray(v) if as_list else jnd.array(v)


@pytest.mark.parametrize("key", sorted(_KEYS))
def test_getitem_matches_jax(key):
    a = onp.arange(3 * 4 * 5, dtype="float32").reshape(3, 4, 5)
    t, j = _pair(a)
    got = t[_KEYS[key](_tkey)]
    want = j[_KEYS[key](_jkey)]
    _close(got.asnumpy(), want.asnumpy(), EXACT, key)


@pytest.mark.parametrize("key", sorted(set(_KEYS) - {"bool_mask"}))
def test_setitem_matches_jax(key):
    a = onp.arange(3 * 4 * 5, dtype="float32").reshape(3, 4, 5)
    t, j = _pair(a)
    region = j[_KEYS[key](_jkey)].shape
    val = (onp.arange(int(onp.prod(region)), dtype="float32") + 100) \
        .reshape(region)
    tensor = t.data
    t[_KEYS[key](_tkey)] = nd.array(val, ctx=CPU)
    j[_KEYS[key](_jkey)] = jnd.array(val)
    _close(t.asnumpy(), j.asnumpy(), EXACT, key)
    assert t.data is tensor


def test_getitem_records_gradients_through_index_arrays():
    a = onp.arange(12, dtype="float32").reshape(3, 4)
    t = nd.array(a, ctx=CPU)
    t.attach_grad()
    with autograd.record():
        y = (t[nd.array([2.0, 0.0, 2.0], ctx=CPU), ::-1] * 2).sum()
    y.backward()
    want = onp.zeros((3, 4), "float32")
    want[2] = 4.0
    want[0] = 2.0
    _close(t.grad.asnumpy(), want, EXACT)


# -- nd functions ---------------------------------------------------------

def test_new_nd_functions_match_jax():
    _close(nd.full((2, 3), 1.5, ctx=CPU).asnumpy(),
           jnd.full((2, 3), 1.5).asnumpy(), EXACT)
    e = nd.empty((2, 3), ctx=CPU, dtype="int32")
    assert e.shape == (2, 3) and str(e.dtype) == "int32"
    _close(nd.arange(0, 5, 2, repeat=3, ctx=CPU).asnumpy(),
           jnd.arange(0, 5, 2, repeat=3).asnumpy(), EXACT)
    a = onp.arange(24, dtype="float32").reshape(2, 3, 4)
    _close(nd.moveaxis(nd.array(a, ctx=CPU), 0, 2).asnumpy(),
           jnd.moveaxis(jnd.array(a), 0, 2).asnumpy(), EXACT)
    nd.waitall()
    src = onp.arange(6, dtype="float32")
    x = nd.from_numpy(src)
    assert x.context == CPU and not src.flags.writeable
    x[0] = 9.0  # zero copy: the source sees it
    assert src[0] == 9.0
    _close(nd.from_dlpack(torch.arange(4.0)).asnumpy(),
           onp.arange(4, dtype="float32"), EXACT)
    s = nd.stack_list([nd.array(a[0], ctx=CPU), nd.array(a[1], ctx=CPU)],
                      axis=1)
    _close(s.asnumpy(), jnd.stack_list([jnd.array(a[0]), jnd.array(a[1])],
                                       axis=1).asnumpy(), EXACT)


def test_from_jax_is_left_out():
    """The port imports no JAX, so it has no ``nd.from_jax`` (ROADMAP
    C)."""
    assert hasattr(jnd, "from_jax") and not hasattr(nd, "from_jax")


# -- deliberate differences -----------------------------------------------

def test_pick_in_range_matches_jax_and_clips_out_of_range():
    """ROADMAP C caveat: the port's ``pick`` clips an index outside the
    axis (MXNet's ``mode="clip"``); the JAX op passes ``mode`` over, so it
    is compared only on indices in range."""
    rs = onp.random.RandomState(17)
    a = rs.uniform(-1, 1, (4, 5)).astype("float32")
    idx = onp.asarray([0, 4, 2, 1], "float32")
    t, j = _pair(a)
    _close(nd.pick(t, nd.array(idx, ctx=CPU)).asnumpy(),
           jnd.pick(j, jnd.array(idx)).asnumpy(), EXACT)
    out = nd.pick(t, nd.array([-3.0, 9.0, 5.0, 4.0], ctx=CPU), axis=1)
    _close(out.asnumpy(), a[onp.arange(4), [0, 4, 4, 4]], EXACT)
    with pytest.raises(ValueError):
        nd.pick(t, nd.array(idx, ctx=CPU), mode="wrap")


def test_bilinear_resize2d_aligns_corners_by_default():
    """MXNet's default ``align_corners=True`` (the JAX op passes it over
    and resizes half-pixel): the corners are kept, and the interior is
    the corner-aligned interpolation."""
    rs = onp.random.RandomState(19)
    a = rs.uniform(0, 1, (1, 1, 3, 4)).astype("float32")
    out = nd.bilinear_resize2d(nd.array(a, ctx=CPU), height=5,
                               width=7).asnumpy()
    ys, xs = onp.linspace(0, 2, 5), onp.linspace(0, 3, 7)
    want = onp.empty((5, 7))
    for i, y in enumerate(ys):
        for k, x in enumerate(xs):
            y0, x0 = min(int(y), 1), min(int(x), 2)
            wy, wx = y - y0, x - x0
            p = a[0, 0].astype("float64")
            want[i, k] = (p[y0, x0] * (1 - wy) * (1 - wx)
                          + p[y0, x0 + 1] * (1 - wy) * wx
                          + p[y0 + 1, x0] * wy * (1 - wx)
                          + p[y0 + 1, x0 + 1] * wy * wx)
    onp.testing.assert_allclose(out[0, 0], want, rtol=1e-6, atol=1e-6)


def test_upsampling_other_than_nearest_raises():
    with pytest.raises(MXNetError):
        nd.upsampling(nd.zeros((1, 1, 2, 2), ctx=CPU), sample_type="bilinear")


def test_boolean_mask_of_a_meta_tensor_raises():
    """The output shape depends on the data: shape inference cannot run
    it (on the card, neither can a graph capture)."""
    from mxnet_tpu_torch.ndarray.ops_index import boolean_mask

    m = torch.empty((4, 3), device="meta")
    with pytest.raises(MXNetError):
        boolean_mask(m, torch.empty(4, device="meta"))
