"""N1's two phases and its route rule, on the CPU.

N1 (``kernels/box_nms.py``, ``csrc/box_nms.cu``) sweeps ``box_nms``'s
score-sorted rows in two phases: the suppression bitmask (a triangle of
64-bit words) and the sequential OR-reduce over it. Their plain versions,
``_nms_mask_ref`` and ``_nms_reduce_ref``, are held here, exactly, to the
plain loop ``_nms_keep_ref`` and, through ``box_nms``'s sort, to the JAX
package's ``box_nms`` (its ``lax.fori_loop``). The inputs are drawn from
numpy seeds, with tied scores, fully overlapping duplicates, zero-area
boxes, invalid rows that are not a suffix, limits of 0, 1 and off a
multiple of 64, and fewer rows than one word. ``_nms_plan``, the route
rule, and the workspace it sizes are pure functions of (B, limit, the
card's shared memory, the workspace cap). The kernels themselves run
only on the card (``tests/test_torch_cuda.py -k "n1 or box_nms"``).
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu import nd as jnd

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import box_nms as n1
from mxnet_tpu_torch.ndarray.ops_contrib import _nms_sorted

H100_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100


def _rows(seed, B, N, classes=3, span=0.4):
    """(B, N, 6) rows [class, score, x1, y1, x2, y2] with the edge cases:
    tied scores, duplicates of a box, zero-area boxes, invalid rows."""
    rs = onp.random.RandomState(seed)
    d = onp.zeros((B, N, 6), "float32")
    d[..., 0] = rs.randint(0, classes, (B, N))
    d[..., 1] = rs.rand(B, N)
    xy = rs.uniform(0, 1 - span, (B, N, 2))
    d[..., 2:4] = xy
    d[..., 4:6] = xy + rs.uniform(0.02, span, (B, N, 2))
    if N >= 8:
        d[:, 3, 1] = d[:, 1, 1]  # a tie
        d[:, 5, 2:] = d[:, 4, 2:]  # a duplicate (IoU 1)
        d[:, 5, 0] = d[:, 4, 0]
        d[:, 6, 4] = d[:, 6, 2]  # zero width
        d[:, 7, 1] = 0.0  # invalid at valid_thresh 0
    d[..., 1][rs.rand(B, N) < 0.15] = 0.0
    return d


def _phases(boxes, valid, ids, thresh, limit):
    mask = n1._nms_mask_ref(boxes, ids, thresh, limit)
    assert mask.dtype == torch.int64
    assert mask.shape == (boxes.shape[0], n1._triangle_words(limit))
    return n1._nms_reduce_ref(mask, valid, limit)


@pytest.mark.parametrize("B,N,limit", [
    (2, 1, 1), (2, 1, 0), (3, 10, 10), (3, 10, 1), (2, 64, 64),
    (2, 65, 65), (2, 130, 100), (4, 200, 0), (2, 300, 257), (1, 1000, 1000)])
@pytest.mark.parametrize("class_aware", [True, False])
def test_two_phases_equal_the_plain_sweep(B, N, limit, class_aware):
    """Valid rows scattered (not a prefix), ragged limits: the mask and
    the reduce compose to the plain loop's keep mask, bit for bit."""
    d = torch.from_numpy(_rows(N + limit, B, N))
    boxes = d[..., 2:6].contiguous()
    valid = d[..., 1] > 0
    ids = d[..., 0].contiguous() if class_aware else None
    for thresh in (0.45, 0.0):
        want = n1._nms_keep_ref(boxes, valid, ids, thresh, limit)
        got = _phases(boxes, valid, ids, thresh, limit)
        assert torch.equal(got, want), (thresh, B, N, limit)
    assert not got[:, limit:].any()


@pytest.mark.parametrize("topk", [400, -1])
@pytest.mark.parametrize("force", [False, True])
def test_two_phases_through_box_nms_equal_jax(topk, force):
    """``box_nms``'s sort, then the two phases, then its -1 rows: equal to
    the JAX op's output, exactly."""
    d = _rows(11, 2, 900, classes=4, span=0.3)
    kw = dict(overlap_thresh=0.45, coord_start=2, score_index=1, id_index=0,
              topk=topk, force_suppress=force)
    ds, vs, boxes, ids, limit = _nms_sorted(
        torch.from_numpy(d), 0.0, topk, 2, 1, 0, -1, force, "corner")
    keep = _phases(boxes, vs, ids, 0.45, limit)
    got = torch.where(keep[..., None], ds, -1.0).numpy()
    want = jnd.contrib.box_nms(jnd.array(d), **kw).asnumpy()
    onp.testing.assert_array_equal(got, want)
    kept = (want[..., 1] >= 0).sum(1)
    assert (kept > 0).all() and (kept < (d[..., 1] > 0).sum(1)).all()


def test_the_mask_words_by_hand():
    """Row 0 overlaps rows 1 and 63 (bits 1 and 63: a negative int64),
    row 1 nothing after it; row 64 starts the second row block."""
    b = torch.zeros((1, 65, 4))
    b[0, :, 0] = torch.arange(65) * 10.0  # 65 disjoint boxes ...
    b[0, :, 2] = b[0, :, 0] + 1
    b[0, :, 3] = 1
    b[0, 1] = b[0, 0]  # ... but 1 and 63 sit on 0
    b[0, 63] = b[0, 0]
    mask = n1._nms_mask_ref(b, None, 0.5, 65)
    W = 2
    assert mask.shape == (1, 32 * W * (W + 1))
    assert int(mask[0, 0]) == (1 << 1) - (1 << 63)  # row 0, word 0
    assert int(mask[0, 1]) == 0  # row 0, word 1 (row 64 is apart)
    assert int(mask[0, 2]) == -(1 << 63)  # row 1 still overlaps row 63
    assert not mask[0, 2 * 64:].any()  # row block 1: row 64 alone
    keep = n1._nms_reduce_ref(mask, torch.ones((1, 65), dtype=torch.bool),
                              65)
    assert not keep[0, 1] and not keep[0, 63] and int(keep.sum()) == 63


@pytest.mark.parametrize("B,limit,optin,route,W,R,S", [
    (32, 256, H100_OPTIN, "fused", 4, None, None),
    (32, 0, H100_OPTIN, "fused", 0, None, None),
    (4, 192, H100_OPTIN, "fused", 3, None, None),
    (32, 257, H100_OPTIN, "mask_reduce", 5, 64, 8),
    (32, 400, H100_OPTIN, "mask_reduce", 7, 64, 8),
    (1, 1665, H100_OPTIN, "mask_reduce", 27, 64, 8),
    (32, 8732, H100_OPTIN, "mask_reduce", 137, 64, 3),
    (2, 12000, H100_OPTIN, "mask_reduce", 188, 64, 2),
    (2, 14400, H100_OPTIN, "mask_reduce", 225, 64, 2),
    (2, 14401, H100_OPTIN, "mask_reduce", 226, 16, 7),
    (1, 32768, H100_OPTIN, "mask_reduce", 512, 16, 3),
    (1, 40000, H100_OPTIN, "mask_reduce", 625, 16, 2),
    (1, 100000, H100_OPTIN, "mask_reduce", 1563, 4, 4),
    (1, 300000, H100_OPTIN, "mask_reduce", 4688, 2, 2),
    (1, 371840, H100_OPTIN, "mask_reduce", 5810, 2, 2),
    (32, 1000, 48 * 1024, "mask_reduce", 16, 64, 5),
    (32, 200, 48 * 1024, "fused", 4, None, None),
])
def test_route_rule_and_workspace(B, limit, optin, route, W, R, S):
    plan = n1._nms_plan(B, limit, optin)
    assert (plan["route"], plan["words"], plan["rows_per_stage"],
            plan["stages"]) == (route, W, R, S)
    assert plan["smem"] <= optin
    if route == "fused":
        assert plan["workspace_bytes"] == 0
        assert plan["smem"] == 256 * W * (W + 1) + W * (64 * 24 + 8)
    else:
        # the triangles the mask kernel writes, as the plain version
        # sizes them
        assert plan["workspace_bytes"] == B * 8 * n1._triangle_words(limit)
        assert plan["smem"] == S * (R * W * 8 + 16) + 8 * W
        assert R in (64, 16, 4, 2) and S >= 2
        if R < 64:  # two stages of the next larger size would not fit
            assert 2 * (R * 4 * W * 8 + 16) + 8 * W > optin
    assert (plan["images"], plan["launches"]) == (B, 1)
    # SSD300's uncapped sweep: 32 images x 8732 rows, 155 MB of triangles
    if (B, limit) == (32, 8732):
        assert plan["workspace_bytes"] == 154877952


def test_route_rule_forced_routes_and_limits():
    assert n1._nms_plan(32, 200, H100_OPTIN,
                        "mask_reduce")["route"] == "mask_reduce"
    # asked for, the fused route takes what fits: up to 1,664 rows
    for limit, W in ((400, 7), (1664, 26)):
        plan = n1._nms_plan(1, limit, H100_OPTIN, "fused")
        assert (plan["route"], plan["words"]) == ("fused", W)
        assert plan["smem"] == 256 * W * (W + 1) + W * (64 * 24 + 8)
    with pytest.raises(MXNetError, match="fused"):
        n1._nms_plan(1, 1665, H100_OPTIN, "fused")
    with pytest.raises(MXNetError, match="fused"):
        n1._nms_plan(32, 8732, H100_OPTIN, "fused")
    with pytest.raises(MXNetError, match="past the card's reach"):
        n1._nms_plan(1, 371841, H100_OPTIN)
    with pytest.raises(MXNetError, match="no route"):
        n1._nms_plan(1, 10, H100_OPTIN, "sweep")
    with pytest.raises(MXNetError, match="two two-row stages"):
        n1._nms_plan(1, 8732, 2 * 1024)


@pytest.mark.parametrize("B,limit,cap,images,launches", [
    (32, 8732, 80 * 2 ** 30 // 4, 32, 1),  # an H100's quarter: one launch
    (32, 8732, 100 * 2 ** 20, 21, 2),  # 4.8 MB an image
    (3, 8732, 2 ** 20, 1, 3),  # not one image fits: one at a time
    (5, 0, 2 ** 20, 5, 1),  # no triangle
    (70000, 64, 2 ** 40, 65535, 2),  # the grid's images
])
def test_route_rule_splits_a_batch_whose_triangles_pass_the_cap(
        B, limit, cap, images, launches):
    plan = n1._nms_plan(B, limit, H100_OPTIN, "mask_reduce", cap)
    assert (plan["images"], plan["launches"]) == (images, launches)
    assert plan["workspace_bytes"] == images * 8 * n1._triangle_words(limit)
    assert plan["workspace_bytes"] <= max(cap, 8 * n1._triangle_words(limit))


def test_the_wrappers_take_the_plain_versions_on_cpu():
    d = torch.from_numpy(_rows(5, 3, 150))
    boxes, valid, ids = d[..., 2:6].contiguous(), d[..., 1] > 0, \
        d[..., 0].contiguous()
    mask = n1._nms_mask_cuda(boxes, ids, 0.45, 130)
    assert torch.equal(mask, n1._nms_mask_ref(boxes, ids, 0.45, 130))
    plan = n1._nms_plan(3, 130, H100_OPTIN, "mask_reduce")
    keep = n1._nms_reduce_cuda(mask, valid, 130, plan)
    assert torch.equal(keep, n1._nms_keep_cuda(boxes, valid, ids, 0.45, 130))
    assert torch.equal(keep, n1._nms_keep_ref(boxes, valid, ids, 0.45, 130))
    meta = n1._nms_keep_cuda(boxes.to("meta"), valid.to("meta"), None, 0.45,
                             130)
    assert meta.shape == (3, 150) and meta.device.type == "meta"
