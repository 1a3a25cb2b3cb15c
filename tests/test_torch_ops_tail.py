"""The slice's ops in the PyTorch port against the JAX package, on the CPU:
``ops_linalg``, ``ops_image``, ``ops_contrib2`` and ``ops_contrib3``.

- Every case of ``mxnet_tpu_torch/tools/op_sweep.py``'s ``LINALG``,
  ``IMAGE``, ``CONTRIB2`` and ``CONTRIB3`` tables (which the card's op
  sweep runs too) runs on the same inputs, drawn from a numpy seed, in
  both packages, and its gradient (a random cotangent pulled back:
  ``jax.vjp`` against ``torch.autograd.grad``) where the case names
  differentiable inputs. Tolerances are relative to the reference's
  largest magnitude: exact ops bitwise; elementwise float math 1e-6;
  reductions, products, solves, factorizations, FFTs and bilinear
  samples 1e-5; the sums that cancel after a running sum or a
  scatter-add in another order (``psroi_pooling``'s integral image,
  ``count_sketch``, ``hawkesll``) 1e-4. The linear-algebra inputs are
  well-conditioned: SPD matrices as X Xᵀ + n I, triangles with a
  dominant diagonal. The deformable convolution's offsets are not
  integers (the bilinear weight has a kink at integer positions).
- ``linalg_syevd``: each eigenvector's sign is the solver's choice in
  both packages, so the eigenvalues are compared, U's rows after each is
  signed by its largest entry, and Uᵀ diag(L) U against A.
- ``image_resize`` on uint8: both packages resize in float32 and
  truncate, so a value that lands within float32 rounding of an integer
  may truncate one apart: every pixel within 1.
- The image jitters' helpers (``_brightness``, ``_contrast``,
  ``_saturation``, ``_hue``, ``_adjust``, ``_gray``) against the JAX
  package's at fixed factors (1e-6 of the largest magnitude); the random
  image ops by their range and by repeating under one seed (Threefry and
  Philox never agree on values).
- The name sets: ``nd.linalg``, ``nd.image``, ``sym.linalg``,
  ``sym.image``, ``nd.contrib`` and ``sym.contrib`` against the JAX
  package's, the five CamelCase aliases, and the registry: the JAX
  registry's op names less the port's are none.
- ``sym.linalg`` and ``sym.image`` graphs through each package's JSON,
  and the in-place ``nd.contrib.reset_arrays``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import ops_image as jimg
from mxnet_tpu.ndarray import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.ndarray import ops_image as timg
from mxnet_tpu_torch.ndarray import registry as treg
from mxnet_tpu_torch.tools.op_sweep import (CONTRIB2, CONTRIB3, EXACT,
                                            IMAGE, LINALG, RANDOM_TAIL, spd)

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


def _canon(case, arrays):
    if case.canon is None:
        return arrays
    return [t.numpy() for t in case.canon([torch.from_numpy(onp.array(a))
                                           for a in arrays])]


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
    jn = _canon(case, [j.asnumpy() for j in jout])
    tn = _canon(case, [t.asnumpy() for t in tout])
    for i, (t, j, tol) in enumerate(zip(tn, jn, case.tols(len(jn)))):
        _close(t, j, tol, f"{case.id} output {i}")
    if not case.diff:
        return
    ct = rs.standard_normal(jn[case.out].shape).astype("float32")
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


TABLES = [("LINALG", c) for c in LINALG] + [("IMAGE", c) for c in IMAGE] + \
    [("CONTRIB2", c) for c in CONTRIB2] + [("CONTRIB3", c) for c in CONTRIB3]


@pytest.mark.parametrize("table,case", TABLES,
                         ids=[f"{t}-{c.id}" for t, c in TABLES])
def test_tail_ops_match_jax(table, case):
    _run(case)


def test_syevd_reconstructs_and_matches_jax():
    """Eigenvalues within 1e-5, U's rows within 1e-5 once signed, and
    Uᵀ diag(L) U equal to A within 1e-5 of its largest entry, in both
    packages."""
    a = spd(onp.random.RandomState(3), 3, 5)
    for u, w in (nd.linalg.syevd(nd.array(a, ctx=CPU)),
                 jnd.linalg.syevd(jnd.array(a))):
        u, w = u.asnumpy(), w.asnumpy()
        rec = onp.einsum("bki,bk,bkj->bij", u, w, u)
        onp.testing.assert_allclose(rec, a, rtol=1e-5,
                                    atol=1e-5 * onp.abs(a).max())
    case = next(c for c in LINALG if c.op == "linalg_syevd")
    _run(case)


def test_image_resize_uint8_within_one():
    img = onp.random.RandomState(5).randint(0, 256, (2, 9, 11, 3)).astype(
        "uint8")
    for kw in ({"size": (7, 5)}, {"size": 14, "keep_ratio": True},
               {"size": (4, 6), "interp": 0}):
        t = nd.image.resize(nd.array(img, ctx=CPU, dtype="uint8"),
                            **kw).asnumpy()
        j = jnd.image.resize(jnd.array(img, dtype="uint8"), **kw).asnumpy()
        assert t.dtype == j.dtype == onp.uint8 and t.shape == j.shape
        assert onp.abs(t.astype(int) - j.astype(int)).max() <= 1, kw


@pytest.mark.parametrize("helper,alpha", [
    ("_brightness", 1.3), ("_contrast", 0.7), ("_saturation", 1.4),
    ("_hue", 0.25), ("_hue", -0.4), ("_adjust", (0.02, -0.05, 0.01))])
def test_image_helpers_match_jax(helper, alpha):
    x = onp.random.RandomState(7).uniform(0, 255, (2, 5, 6, 3)).astype(
        "float32")
    t = getattr(timg, helper)(torch.from_numpy(x), alpha).numpy()
    j = onp.asarray(getattr(jimg, helper)(jnp.asarray(x), alpha))
    _close(t, j, 1e-6, helper)
    _close(timg._gray(torch.from_numpy(x)).numpy(),
           onp.asarray(jimg._gray(jnp.asarray(x))), 1e-6, "_gray")


def _draw(name, x, kw, seed):
    mx.random.seed(seed)
    return getattr(nd.image, name[len("image_"):])(x, **kw).asnumpy()


@pytest.mark.parametrize("name,kw", RANDOM_TAIL,
                         ids=[n for n, _ in RANDOM_TAIL])
def test_random_image_ops_range_and_seed(name, kw):
    """One seed repeats the draw; a factor lies in its range: the
    brightness ratio in [min, max], a flip gives the image or its
    mirror, the others stay finite and move the image."""
    a = onp.random.RandomState(11).uniform(10, 245, (6, 7, 3)).astype(
        "float32")
    x = nd.array(a, ctx=CPU)
    first = _draw(name, x, kw, 5)
    onp.testing.assert_array_equal(first, _draw(name, x, kw, 5))
    assert first.shape == a.shape and onp.isfinite(first).all()
    outs = [_draw(name, x, kw, s) for s in range(12)]
    if "flip" in name:
        axis = 1 if "left_right" in name else 0
        flipped = onp.flip(a, axis)
        kinds = {0 if onp.array_equal(o, a) else
                 1 if onp.array_equal(o, flipped) else 2 for o in outs}
        assert kinds == {0, 1}, kinds
        return
    if name == "image_random_brightness":
        ratio = onp.array([(o / a).mean() for o in outs])
        assert ((ratio >= kw["min_factor"] - 1e-6)
                & (ratio <= kw["max_factor"] + 1e-6)).all(), ratio
    assert len({o.tobytes() for o in outs}) > 1


def test_registry_and_namespaces_match_jax():
    missing = set(jreg.list_ops()) - set(treg.list_ops())
    assert missing == set(), sorted(missing)
    for short in ("linalg", "image"):
        jnames = {n for n in dir(getattr(jnd, short))
                  if not n.startswith("_")}
        for mod in (getattr(nd, short), getattr(sym, short)):
            names = {n for n in dir(mod) if not n.startswith("_")}
            assert names == jnames, (short, names ^ jnames)
        assert {n for n in dir(getattr(jmx.sym, short))
                if not n.startswith("_")} == jnames
    from mxnet_tpu.ndarray import contrib as jcontrib

    want = set(jcontrib._CONTRIB_OPS) | set(jcontrib._CONTRIB_ALIASES)
    for mod in (nd.contrib, sym.contrib):
        assert want <= set(dir(mod)), want - set(dir(mod))
    for alias, target in (("Proposal", "proposal"),
                          ("MultiProposal", "multi_proposal"),
                          ("PSROIPooling", "psroi_pooling"),
                          ("DeformableConvolution", "deformable_convolution"),
                          ("DeformablePSROIPooling",
                           "deformable_psroi_pooling")):
        assert getattr(nd.contrib, alias) is getattr(nd.contrib, target)
        assert getattr(sym.contrib, alias) is getattr(sym.contrib, target)
        assert nd._CAMEL_ALIASES[alias] == target


def _json_graphs(S):
    a, b = S.Variable("a"), S.Variable("b")
    lin = S.linalg.gemm2(S.linalg.potrf(a), b, transpose_a=True, alpha=0.5)
    lq = S.linalg.gelqf(b)
    linalg = S.Group([lin, lq[0], lq[1], S.linalg.slogdet(a)[1]])
    x = S.Variable("x")
    image = S.image.normalize(S.image.to_tensor(
        S.image.flip_left_right(x)), mean=(0.1, 0.2, 0.3), std=(0.5, 0.5,
                                                                0.5))
    props = S.contrib.Proposal(S.Variable("p"), S.Variable("d"),
                               S.Variable("i"), rpn_pre_nms_top_n=40,
                               rpn_post_nms_top_n=8, rpn_min_size=4)
    return {"linalg": linalg, "image": image, "contrib": props}


@pytest.mark.parametrize("which", ["linalg", "image", "contrib"])
def test_symbol_json_round_trip_between_packages(which):
    """A graph of each namespace written by one package loads in the other
    and gives the same outputs; both packages write the same JSON."""
    rs = onp.random.RandomState(2)
    feeds = {"linalg": {"a": spd(rs, 2, 3),
                        "b": rs.uniform(-1, 1, (2, 3, 4)).astype("f")},
             "image": {"x": rs.randint(0, 256, (4, 5, 3)).astype("uint8")},
             "contrib": {}}[which]
    if which == "contrib":
        from mxnet_tpu_torch.tools.op_sweep import _rpn

        p, d, i = _rpn(rs)
        feeds = {"p": p, "d": d, "i": i}
    tg, jg = _json_graphs(sym)[which], _json_graphs(jmx.sym)[which]
    assert tg.tojson() == jg.tojson()
    t_from_j = sym.load_json(jg.tojson())
    j_from_t = jmx.sym.load_json(tg.tojson())

    def teval(g):
        out = g.eval_with({k: nd.array(v, ctx=CPU, dtype=v.dtype)
                           for k, v in feeds.items()})
        return [o.asnumpy() for o in _outs(out)]

    def jeval(g):
        out = g.eval_with({k: jnd.array(v, dtype=v.dtype)
                           for k, v in feeds.items()})
        return [o.asnumpy() for o in _outs(out)]

    want = jeval(jg)
    for got in (teval(t_from_j), teval(tg), jeval(j_from_t)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, 1e-5, which)


def test_reset_arrays_zeroes_in_place():
    a = nd.array(onp.ones((2, 3), "f"), ctx=CPU)
    b = nd.array(onp.full((4,), 2.0, "f"), ctx=CPU)
    ta = a._data
    nd.contrib.reset_arrays(a, b, num_arrays=2)
    assert a._data is ta and not ta.any() and not b.asnumpy().any()
    ja, jb = jnd.array(onp.ones((2, 3), "f")), jnd.array(onp.ones(4, "f"))
    jnd.contrib.reset_arrays(ja, jb, num_arrays=2)
    assert not ja.asnumpy().any() and not jb.asnumpy().any()
