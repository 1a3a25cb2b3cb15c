"""The detection ops of the PyTorch port, ``nd.contrib`` and
``sym.contrib`` against the JAX package, on the CPU.

Each op of ``ndarray/ops_contrib.py`` (``box_iou``, ``box_nms``,
``bipartite_matching``, ``multibox_prior``, ``multibox_target``,
``multibox_detection``, ``roi_align``) runs on the same inputs, drawn
from a numpy seed, in both packages; tied scores, duplicate columns and
identical ground-truth boxes are among them. On the CPU ``box_nms``'s
sweep is N1's plain version, the Python loop over the rows.

Tolerances:

- integer-valued outputs (class ids, matches, class targets, masks) and
  the positions of the -1 rows: exact;
- float32 values (coordinates, scores, IoUs, box targets): within 1e-6
  absolute plus 1e-6 relative (the two packages round the same float32
  arithmetic; XLA may reassociate a quotient by a constant);
- ``roi_align``'s values 1e-6 and its gradient with respect to ``data``
  within 1e-5 of its largest value (a scatter-add of four bilinear
  weights per sample, summed in other orders).

Then ``nd.contrib``: its names resolve and the CamelCase aliases are the
same functions, ``_install`` raises on a listed name that is not
registered, ``foreach``/``while_loop``/``cond`` and the dense ``getnnz``
match the JAX package; and a ``sym.contrib`` inference graph,
``MultiBoxPrior`` → ``MultiBoxDetection``, bound and run against JAX's.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd, sym
from mxnet_tpu_torch.ndarray import contrib as tcontrib
from mxnet_tpu_torch.ndarray import registry as treg

CPU = mx.cpu()
OPS = ("box_iou", "box_nms", "bipartite_matching", "multibox_prior",
       "multibox_target", "multibox_detection", "roi_align")
VAL_TOL = 1e-6
GRAD_TOL = 1e-5


def _t(a):
    return nd.array(a, ctx=CPU)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _values(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    onp.testing.assert_allclose(got, want, rtol=VAL_TOL, atol=VAL_TOL,
                                err_msg=what)


def _exact(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    onp.testing.assert_array_equal(got, want, err_msg=what)


def _rows(got, want, id_col=0):
    """Detection-style rows: the -1 rows and the id column exact, the
    rest within the value tolerance."""
    got, want = _np(got), _np(want)
    _exact(got[..., id_col] == -1, want[..., id_col] == -1, "-1 rows")
    _exact(got[..., id_col], want[..., id_col], "ids")
    _values(got, want, "rows")


def _boxes(rs, shape, lo=0.0, span=0.6):
    xy = rs.uniform(lo, 1 - span, shape + (2,))
    wh = rs.uniform(0.05, span, shape + (2,))
    return onp.concatenate([xy, xy + wh], -1).astype("float32")


# -- the registry ---------------------------------------------------------

def test_every_op_of_ops_contrib_is_registered_in_nd_sym_and_contrib():
    names = sorted(n for n in jreg.list_ops()
                   if jreg.get_op(n).fn.__module__.endswith(".ops_contrib"))
    assert names == sorted(OPS)
    for n in names:
        assert treg.get_op(n) is not None, n
        assert treg.get_op(n).differentiable == jreg.get_op(n).differentiable
        for ns in (nd, sym, nd.contrib, sym.contrib):
            assert hasattr(ns, n), (ns.__name__, n)


# -- box_iou --------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rs = onp.random.RandomState(1)
    a, b = _boxes(rs, (6,)), _boxes(rs, (5,))
    b[2] = a[3]  # an identical pair: IoU 1
    _values(nd.contrib.box_iou(_t(a), _t(b), format=fmt),
            jnd.contrib.box_iou(jnd.array(a), jnd.array(b), format=fmt))


def test_box_iou_batched_and_its_gradient_match_jax():
    rs = onp.random.RandomState(2)
    a, b = _boxes(rs, (2, 4)), _boxes(rs, (2, 3))
    cot = rs.randn(2, 4, 3).astype("float32")
    ta, ja = _t(a), jnd.array(a)
    ta.attach_grad()
    ja.attach_grad()
    with autograd.record():
        out = nd.contrib.box_iou(ta, _t(b))
        (out * _t(cot)).sum().backward()
    with jautograd.record():
        jout = jnd.contrib.box_iou(ja, jnd.array(b))
        (jout * jnd.array(cot)).sum().backward()
    _values(out, jout)
    _values(ta.grad, ja.grad, "grad")


# -- box_nms --------------------------------------------------------------

def _nms_data(seed=0, B=3, N=40, classes=3):
    rs = onp.random.RandomState(seed)
    d = onp.zeros((B, N, 6), "float32")
    d[..., 0] = rs.randint(0, classes, (B, N))
    d[..., 1] = rs.rand(B, N)
    d[..., 2:] = _boxes(rs, (B, N), span=0.5)
    d[0, 7, 1] = d[0, 3, 1]  # tied scores keep index order
    d[1, 10:14, 1] = 0.5
    d[2, 5, 1] = 0.0  # invalid at valid_thresh 0
    return d


NMS_CASES = [
    ("default", {}),
    ("topk5", {"topk": 5}),
    ("class_aware", {"id_index": 0}),
    ("force_suppress", {"id_index": 0, "force_suppress": True}),
    ("background", {"id_index": 0, "background_id": 1}),
    ("class_aware_topk", {"id_index": 0, "topk": 12}),
    ("valid_thresh", {"valid_thresh": 0.4}),
    ("out_center", {"out_format": "center"}),
    ("in_center", {"in_format": "center"}),
    ("both_center", {"in_format": "center", "out_format": "center"}),
    ("thresh_low", {"overlap_thresh": 0.1, "id_index": 0}),
]


@pytest.mark.parametrize("kw", [c[1] for c in NMS_CASES],
                         ids=[c[0] for c in NMS_CASES])
def test_box_nms_matches_jax(kw):
    d = _nms_data()
    kw = dict({"overlap_thresh": 0.3, "coord_start": 2, "score_index": 1},
              **kw)
    got = nd.contrib.box_nms(_t(d), **kw)
    want = jnd.contrib.box_nms(jnd.array(d), **kw)
    _rows(got, want, id_col=1)
    assert (_np(want)[..., 1] == -1).any() and (_np(want)[..., 1] > 0).any()


def test_box_nms_on_2d_input_and_all_tied_scores():
    d = _nms_data(seed=3)[0]
    got = nd.contrib.box_nms(_t(d), overlap_thresh=0.2, id_index=0)
    want = jnd.contrib.box_nms(jnd.array(d), overlap_thresh=0.2, id_index=0)
    assert got.shape == (40, 6)
    _rows(got, want, id_col=1)
    d[:, 1] = 0.7  # every score tied: the rows stay in index order
    got = nd.contrib.box_nms(_t(d), overlap_thresh=0.2)
    want = jnd.contrib.box_nms(jnd.array(d), overlap_thresh=0.2)
    _rows(got, want, id_col=1)


def test_box_nms_sweep_plain_version_matches_the_jax_loop_at_ssd_width():
    """The plain version at 8732 rows (SSD300's anchors), 400 kept at most
    (``nms_topk``), class-aware, against the JAX op."""
    rs = onp.random.RandomState(4)
    d = onp.zeros((1, 8732, 6), "float32")
    d[..., 0] = rs.randint(0, 20, (1, 8732))
    d[..., 1] = rs.rand(1, 8732)
    d[..., 2:] = _boxes(rs, (1, 8732), span=0.3)
    kw = dict(overlap_thresh=0.45, topk=400, id_index=0)
    got = nd.contrib.box_nms(_t(d), **kw)
    want = jnd.contrib.box_nms(jnd.array(d), **kw)
    _rows(got, want, id_col=1)


# -- bipartite_matching ---------------------------------------------------

BIP_CASES = [
    ("default", {}),
    ("ascend", {"is_ascend": True}),
    ("topk", {"topk": 2}),
    ("threshold", {"threshold": 0.5}),
    ("ascend_threshold", {"is_ascend": True, "threshold": 0.3}),
]


@pytest.mark.parametrize("kw", [c[1] for c in BIP_CASES],
                         ids=[c[0] for c in BIP_CASES])
def test_bipartite_matching_matches_jax(kw):
    rs = onp.random.RandomState(5)
    s = rs.rand(3, 6, 4).astype("float32")
    s[0, :, 2] = s[0, :, 1]  # duplicate columns: the first maximum wins
    s[1, 3] = s[1, 1]  # duplicate rows
    s[2] = 0.25  # all tied
    got = nd.contrib.bipartite_matching(_t(s), **kw)
    want = jnd.contrib.bipartite_matching(jnd.array(s), **kw)
    assert len(got) == 2
    for g, w in zip(got, want):
        _exact(g, w)


def test_bipartite_matching_on_2d_input():
    s = onp.random.RandomState(6).rand(5, 7).astype("float32")
    got = nd.contrib.bipartite_matching(_t(s), threshold=0.2)
    want = jnd.contrib.bipartite_matching(jnd.array(s), threshold=0.2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _exact(g, w)


# -- multibox_prior -------------------------------------------------------

PRIOR_CASES = [
    ("sizes", (4, 4), {"sizes": [0.5, 0.25]}),
    ("ratios", (3, 5), {"sizes": [0.3], "ratios": [1, 2, 0.5, 3, 1 / 3]}),
    ("steps", (5, 5), {"sizes": [.2, .272], "ratios": [1, 2, .5],
                       "steps": (0.1, 0.1)}),
    ("offsets", (4, 6), {"sizes": [0.4, 0.6], "ratios": [1, 2],
                         "offsets": (0.2, 0.7), "steps": (0.2, 0.15)}),
    ("clip", (3, 3), {"sizes": [0.9, 0.5], "ratios": [1, 3], "clip": True}),
    ("ssd300_38", (38, 38), {"sizes": [.1, .141], "ratios": [1, 2, .5],
                             "steps": (8 / 300, 8 / 300)}),
]


@pytest.mark.parametrize("hw,kw", [c[1:] for c in PRIOR_CASES],
                         ids=[c[0] for c in PRIOR_CASES])
def test_multibox_prior_matches_jax(hw, kw):
    x = onp.zeros((2, 3) + hw, "float32")
    got = nd.contrib.MultiBoxPrior(_t(x), **kw)
    want = jnd.contrib.MultiBoxPrior(jnd.array(x), **kw)
    _values(got, want)


# -- multibox_target ------------------------------------------------------

def _target_inputs(seed=7, B=4, M=5):
    rs = onp.random.RandomState(seed)
    anchor = onp.array(jnd.contrib.MultiBoxPrior(
        jnd.zeros((1, 1, 8, 8)), sizes=[0.2, 0.35], ratios=[1, 2, 0.5]
    ).asnumpy())
    labels = -onp.ones((B, M, 5), "float32")
    for i, n in enumerate((3, 1, 0, 2)[:B]):  # image 2 has no box
        labels[i, :n, 0] = rs.randint(0, 3, n)
        labels[i, :n, 1:] = _boxes(rs, (n,), span=0.5)
    labels[3, 1] = labels[3, 0]  # two identical ground-truth boxes
    cls_pred = rs.randn(B, 4, anchor.shape[1]).astype("float32")
    return anchor, labels, cls_pred


TARGET_CASES = [
    ("no_mining", {}),
    ("mining", {"negative_mining_ratio": 3.0,
                "negative_mining_thresh": 0.5}),
    ("mining_min_samples", {"negative_mining_ratio": 2.0,
                            "negative_mining_thresh": 0.2,
                            "minimum_negative_samples": 10}),
    ("threshold_variances", {"overlap_threshold": 0.3,
                             "variances": (0.2, 0.2, 0.1, 0.1)}),
    ("ignore_label", {"negative_mining_ratio": 1.0, "ignore_label": -2.0,
                      "negative_mining_thresh": 0.0}),
]


@pytest.mark.parametrize("kw", [c[1] for c in TARGET_CASES],
                         ids=[c[0] for c in TARGET_CASES])
def test_multibox_target_matches_jax(kw):
    anchor, labels, cls_pred = _target_inputs()
    got = nd.contrib.MultiBoxTarget(_t(anchor), _t(labels), _t(cls_pred),
                                    **kw)
    want = jnd.contrib.MultiBoxTarget(jnd.array(anchor), jnd.array(labels),
                                      jnd.array(cls_pred), **kw)
    assert len(got) == 3
    _values(got[0], want[0], "box_target")
    _exact(got[1], want[1], "box_mask")
    _exact(got[2], want[2], "cls_target")
    ct = _np(got[2])
    assert (ct[2] <= 0).all()  # no box, no positive
    assert (ct > 0).any()


def test_multibox_target_with_tied_background_confidence():
    """cls_pred all zeros: every anchor's background confidence ties, so
    hard-negative mining ranks them by index (stable sorts)."""
    anchor, labels, cls_pred = _target_inputs(seed=8)
    cls_pred[:] = 0
    kw = {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.0}
    got = nd.contrib.MultiBoxTarget(_t(anchor), _t(labels), _t(cls_pred),
                                    **kw)
    want = jnd.contrib.MultiBoxTarget(jnd.array(anchor), jnd.array(labels),
                                      jnd.array(cls_pred), **kw)
    _values(got[0], want[0], "box_target")
    _exact(got[1], want[1], "box_mask")
    _exact(got[2], want[2], "cls_target")
    assert (_np(want[2]) == -1).any()


def test_multibox_target_inside_record_attaches_nothing():
    anchor, labels, cls_pred = _target_inputs()
    cp = _t(cls_pred)
    cp.attach_grad()
    with autograd.record():
        outs = nd.contrib.MultiBoxTarget(_t(anchor), _t(labels),
                                         cp * 2, negative_mining_ratio=3.0)
        rm, cm = nd.contrib.bipartite_matching(cp[:, 0, :8].reshape(4, 2, 4))
    for o in list(outs) + [rm, cm]:
        assert o._data.grad_fn is None and not o._data.requires_grad


# -- multibox_detection ---------------------------------------------------

def _detection_inputs(seed=9, B=3):
    rs = onp.random.RandomState(seed)
    anchor = onp.array(jnd.contrib.MultiBoxPrior(
        jnd.zeros((1, 1, 6, 6)), sizes=[0.3, 0.5], ratios=[1, 2]).asnumpy())
    N = anchor.shape[1]
    logits = rs.randn(B, 5, N).astype("float32") * 2
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    prob = prob.astype("float32")
    prob[0, :, 4] = prob[0, :, 5]  # two anchors with tied scores
    loc = (rs.randn(B, N * 4) * 0.5).astype("float32")
    return prob, loc, anchor


DET_CASES = [
    ("default", {}),
    ("no_clip", {"clip": False}),
    ("background_2", {"background_id": 2}),
    ("nms_topk", {"nms_topk": 20}),
    ("force_suppress", {"force_suppress": True, "nms_threshold": 0.3}),
    ("threshold", {"threshold": 0.3, "variances": (0.2, 0.2, 0.1, 0.1)}),
]


@pytest.mark.parametrize("kw", [c[1] for c in DET_CASES],
                         ids=[c[0] for c in DET_CASES])
def test_multibox_detection_matches_jax(kw):
    prob, loc, anchor = _detection_inputs()
    got = nd.contrib.MultiBoxDetection(_t(prob), _t(loc), _t(anchor), **kw)
    want = jnd.contrib.MultiBoxDetection(jnd.array(prob), jnd.array(loc),
                                         jnd.array(anchor), **kw)
    _rows(got, want)
    w = _np(want)
    assert (w[..., 0] >= 0).any() and (w[..., 0] == -1).any()


# -- roi_align ------------------------------------------------------------

ROI_CASES = [
    ("2x2_scale1", (2, 2), 1.0, -1),
    ("3x2_half", (3, 2), 0.5, 2),
    ("1x1_three_samples", (1, 1), 0.25, 3),
]


@pytest.mark.parametrize("pooled,scale,ratio", [c[1:] for c in ROI_CASES],
                         ids=[c[0] for c in ROI_CASES])
def test_roi_align_values_and_gradient_match_jax(pooled, scale, ratio):
    rs = onp.random.RandomState(10)
    data = rs.randn(2, 3, 10, 12).astype("float32")
    rois = onp.array([[0, 1, 1, 7, 8], [1, 0.5, 2.5, 11, 9],
                      [0, 3, 3, 3.5, 3.2], [1, -2, -1, 30, 25]], "float32")
    rois[:, 1:] /= scale
    cot = rs.randn(4, 3, *pooled).astype("float32")
    kw = dict(pooled_size=pooled, spatial_scale=scale, sample_ratio=ratio)
    td, jd = _t(data), jnd.array(data)
    td.attach_grad()
    jd.attach_grad()
    with autograd.record():
        out = nd.contrib.ROIAlign(td, _t(rois), **kw)
        (out * _t(cot)).sum().backward()
    with jautograd.record():
        jout = jnd.contrib.ROIAlign(jd, jnd.array(rois), **kw)
        (jout * jnd.array(cot)).sum().backward()
    _values(out, jout)
    g, w = _np(td.grad), _np(jd.grad)
    onp.testing.assert_allclose(g, w, rtol=0,
                                atol=GRAD_TOL * onp.abs(w).max())


# -- nd.contrib -----------------------------------------------------------

def test_nd_contrib_names_resolve_and_aliases_are_the_same_functions():
    assert len(tcontrib._CONTRIB_OPS) == len(set(tcontrib._CONTRIB_OPS))
    for name in tcontrib._CONTRIB_OPS:
        assert callable(getattr(nd.contrib, name)), name
        assert name in jmx.nd.contrib._CONTRIB_OPS
        assert callable(getattr(sym.contrib, name)), name
    for alias, target in tcontrib._CONTRIB_ALIASES.items():
        assert getattr(nd.contrib, alias) is getattr(nd.contrib, target)
        assert getattr(sym.contrib, alias) is getattr(sym.contrib, target)
        assert jmx.nd.contrib._CONTRIB_ALIASES[alias] == target
    assert set(tcontrib.__all__) >= {"foreach", "while_loop", "cond",
                                     "getnnz", "MultiBoxPrior"}


def test_nd_contrib_install_raises_on_a_listed_name_not_registered(
        monkeypatch):
    monkeypatch.setattr(tcontrib, "_CONTRIB_OPS",
                        tcontrib._CONTRIB_OPS + ["no_such_contrib_op"])
    with pytest.raises(RuntimeError, match="no_such_contrib_op"):
        tcontrib._install()


def test_foreach_matches_jax_values_and_gradients():
    rs = onp.random.RandomState(11)
    xs = rs.randn(5, 3).astype("float32")
    h0 = rs.randn(3).astype("float32")
    w = rs.randn(3).astype("float32")

    def run(pkg, ag, ctx):
        x, s, wv = (pkg.nd.array(v, ctx=ctx) for v in (xs, h0, w))
        wv.attach_grad()

        def body(xi, st):
            new = pkg.nd.tanh(xi * wv + st)
            return [new * 2, new + 1], new

        with ag.record():
            outs, fin = pkg.nd.contrib.foreach(body, x, s)
            loss = (outs[0].sum() + outs[1].sum() + fin.sum())
        loss.backward()
        return [o.asnumpy() for o in outs] + [fin.asnumpy(),
                                              wv.grad.asnumpy()]

    # tanh and a gradient summed over five steps: 1e-6 of the largest
    for g, want in zip(run(mx, autograd, CPU), run(jmx, jautograd, None)):
        onp.testing.assert_allclose(g, want, rtol=1e-5,
                                    atol=1e-6 * onp.abs(want).max())


def test_while_loop_and_cond_match_jax():
    def run(pkg, ctx):
        i0 = pkg.nd.array([0.0], ctx=ctx)
        acc0 = pkg.nd.array([1.0], ctx=ctx)
        outs, (i, acc) = pkg.nd.contrib.while_loop(
            lambda i, a: i < 4, lambda i, a: (a * 3, [i + 1, a * 2]),
            [i0, acc0], max_iterations=10)
        c1 = pkg.nd.contrib.cond(i > 2, lambda: acc + 1, lambda: acc - 1)
        c2 = pkg.nd.contrib.cond(i < 2, lambda: acc + 1, lambda: acc - 1)
        none, fin = pkg.nd.contrib.while_loop(
            lambda v: v > 100, lambda v: (v, v), i0, max_iterations=3)
        return ([o.asnumpy() for o in outs]
                + [i.asnumpy(), acc.asnumpy(), c1.asnumpy(), c2.asnumpy(),
                   fin.asnumpy()], none)

    got, got_none = run(mx, CPU)
    want, want_none = run(jmx, None)
    assert got_none == [] and want_none == []
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _exact(g, w)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_getnnz_on_dense_input_matches_jax(axis):
    x = onp.random.RandomState(12).randn(4, 6).astype("float32")
    x[x < 0.3] = 0
    got = nd.contrib.getnnz(_t(x), axis=axis)
    want = jnd.contrib.getnnz(jnd.array(x), axis=axis)
    assert str(got.dtype) == str(want.dtype) == "int32"
    _exact(got, want)


# -- sym.contrib ----------------------------------------------------------

def _detection_graph(S):
    feat = S.var("feat")
    cls_prob = S.var("cls_prob")
    loc = S.var("loc_pred")
    anchor = S.contrib.MultiBoxPrior(feat, sizes=[0.3, 0.5], ratios=[1, 2],
                                     name="anchors")
    return S.contrib.MultiBoxDetection(cls_prob, loc, anchor,
                                       nms_threshold=0.4, nms_topk=30,
                                       name="detection")


def test_sym_contrib_detection_graph_binds_and_runs_like_jax():
    prob, loc, _ = _detection_inputs(seed=13, B=2)
    feat = onp.zeros((1, 8, 6, 6), "float32")
    tg, jg = _detection_graph(sym), _detection_graph(jmx.sym)
    assert tg.list_arguments() == jg.list_arguments()
    shapes = {"feat": feat.shape, "cls_prob": prob.shape,
              "loc_pred": loc.shape}
    _, outs, _ = tg.infer_shape(**shapes)
    assert [tuple(s) for s in outs] == [(2, 108, 6)]
    arrays = {"feat": feat, "cls_prob": prob, "loc_pred": loc}
    tex = tg.bind(CPU, {k: _t(v) for k, v in arrays.items()},
                  grad_req="null")
    jex = jg.bind(None, {k: jnd.array(v) for k, v in arrays.items()},
                  grad_req="null")
    got = tex.forward(is_train=False)[0]
    want = jex.forward(is_train=False)[0]
    _rows(got, want)


def test_sym_contrib_multibox_shapes_infer():
    anchor = sym.contrib.MultiBoxPrior(sym.var("feat"), sizes=[0.2, 0.4],
                                       ratios=[1, 2, 0.5])
    tgt = sym.contrib.MultiBoxTarget(anchor, sym.var("label"),
                                     sym.var("cls_pred"),
                                     negative_mining_ratio=3.0)
    assert len(tgt.list_outputs()) == 3
    _, outs, _ = sym.Group([tgt[0], tgt[1], tgt[2]]).infer_shape(
        feat=(2, 4, 5, 5), label=(2, 3, 5), cls_pred=(2, 6, 100))
    assert [tuple(s) for s in outs] == [(2, 400), (2, 400), (2, 100)]
    nms = sym.contrib.box_nms(sym.var("data"), topk=10)
    _, outs, _ = nms.infer_shape(data=(3, 50, 6))
    assert [tuple(s) for s in outs] == [(3, 50, 6)]
