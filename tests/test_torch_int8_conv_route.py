"""N2's two kernels on the CPU: which one takes a convolution, and the
arithmetic the wrapper hands the sm90 kernel.

``int8_conv`` sends a convolution of one group with C and O multiples of
16 to ``csrc/int8_conv_sm90.cu`` and everything else (the stem's 3
channels too) to ``csrc/int8_conv.cu``; neither kernel runs here.
What these tests reach is the Python around the sm90 kernel: the route
rule (``_int8_conv_route``), the launch plan (``_sm90_plan``: flat or
spatial pixel tiles, tile width, K splits, grid) and the operands
(``_sm90_operands``: x as NHWC, w as OHWI, small C padded). An emulation
of the kernel's arithmetic — tile by tile, A as the TMA boxes of one tap
and 128 channels each (zeros past the image and past C), B likewise,
k-tiles summed per K split and the splits added, each tile row written
to its NCHW pixel — is held bit for bit against the plain version,
``_int8_conv_ref`` (a float64 convolution, exact). Imports no JAX: the
plain version is the port's own.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import int8_conv as k8
from mxnet_tpu_torch.tools.profile_quant import resnet50_convolutions

N_SM = 132  # the H100's streaming multiprocessors
BK = 128  # bytes of C per k-tile
BM = 128  # output pixels per tile

# (x shape, w shape, stride, pad, dilate): the kernel's edges. M not a
# multiple of 128, O not a multiple of the tile width, C = 16 and 48, a
# stride-2 1 x 1, a padded 3 x 3 at 7 x 7, the stem (C = 3, padded to
# 16), a dilated and an anisotropic case, a flat 1 x 1 at stride 1
EDGES = [
    ((3, 16, 9, 7), (48, 16, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((2, 48, 7, 7), (80, 48, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((2, 32, 9, 9), (64, 32, 1, 1), (2, 2), (0, 0), (1, 1)),
    ((2, 64, 7, 7), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((1, 3, 23, 23), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1)),
    ((2, 16, 11, 13), (32, 16, 3, 3), (2, 1), (1, 2), (1, 1)),
    ((1, 32, 12, 12), (16, 32, 3, 3), (1, 1), (2, 2), (2, 2)),
    ((3, 48, 5, 6), (144, 48, 1, 1), (1, 1), (0, 0), (1, 1)),
    ((1, 5, 10, 10), (16, 5, 3, 3), (1, 1), (1, 1), (1, 1)),
]


def _resnet50_shapes(batch):
    seen = []
    for c in resnet50_convolutions(batch):
        if c not in seen:
            seen.append(c)
    return seen


def _s8(rs, shape):
    return torch.from_numpy(rs.randint(-127, 128, shape).astype("int8"))


def _emulate(x, w, stride, pad, dilate, plan):
    """The sm90 kernel's arithmetic in torch on the CPU, tile by tile:
    returns the NCHW int32 output and checks that every output element
    is written exactly once."""
    N, C, H, W = x.shape
    O, _, KH, KW = w.shape
    xh, wh, Cp = k8._sm90_operands(x, w)
    assert Cp == plan["C"]
    Ho, Wo, bn = plan["Ho"], plan["Wo"], plan["bn"]
    cbs = -(-Cp // BK)
    assert plan["k_tiles"] == KH * KW * cbs
    # TMA reads channels past C, filters past O and pixels outside the
    # image as zeros
    xk = torch.zeros((N, H, W, cbs * BK), dtype=torch.int64)
    xk[..., :Cp] = xh.to(torch.int64)
    wk = torch.zeros((plan["n_tiles"] * bn, KH * KW, cbs * BK),
                     dtype=torch.int64)
    wk[:O, :, :Cp] = wh.reshape(O, KH * KW, Cp).to(torch.int64)

    def a_box(n, ih, iw):
        inside = (n < N) & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
        rows = xk[n.clamp(0, N - 1), ih.clamp(0, H - 1), iw.clamp(0, W - 1)]
        return torch.where(inside[:, None], rows, torch.zeros_like(rows))

    # each tile's rows: their output pixels (n, ho, wo) and which exist
    tiles = []
    if plan["flat"]:
        assert plan["tile"] is None and plan["rows"] == BM
        for mt in range(plan["m_tiles"]):
            m = torch.arange(mt * BM, (mt + 1) * BM)
            n, rem = m // (Ho * Wo), m % (Ho * Wo)
            tiles.append((n, rem // Wo, rem % Wo, m < plan["M"]))
    else:
        nt, ht, wt = plan["tile"]
        assert plan["rows"] == nt * ht * wt <= BM
        r = torch.arange(nt * ht * wt)
        for n0 in range(0, N, nt):
            for h0 in range(0, Ho, ht):
                for w0 in range(0, Wo, wt):
                    n = n0 + r // (ht * wt)
                    ho, wo = h0 + (r // wt) % ht, w0 + r % wt
                    tiles.append((n, ho, wo, (n < N) & (ho < Ho) & (wo < Wo)))
    assert len(tiles) == plan["m_tiles"]
    y = torch.zeros((N, O, Ho, Wo), dtype=torch.int64)
    writes = torch.zeros((N, O, Ho, Wo), dtype=torch.int64)
    kts, S = plan["k_tiles"], plan["splits"]
    for n, ho, wo, ok in tiles:
        for nt_ in range(plan["n_tiles"]):
            acc = torch.zeros((len(n), bn), dtype=torch.int64)
            covered = []
            for s in range(S):  # K split s: [s kts / S, (s + 1) kts / S)
                kb, ke = s * kts // S, (s + 1) * kts // S
                assert ke > kb
                covered += range(kb, ke)
                for kt in range(kb, ke):
                    tap, cb = divmod(kt, cbs)
                    rr, ss = divmod(tap, KW)
                    a = a_box(n, ho * stride[0] - pad[0] + rr * dilate[0],
                              wo * stride[1] - pad[1] + ss * dilate[1])
                    b = wk[nt_ * bn:(nt_ + 1) * bn, tap]
                    acc += a[:, cb * BK:(cb + 1) * BK] @ \
                        b[:, cb * BK:(cb + 1) * BK].T
            assert covered == list(range(kts))
            for o in range(nt_ * bn, min((nt_ + 1) * bn, O)):
                y[n[ok], o, ho[ok], wo[ok]] = acc[ok, o - nt_ * bn]
                writes[n[ok], o, ho[ok], wo[ok]] += 1
    assert bool((writes == 1).all())
    return y.to(torch.int32)


# -- the route rule ----------------------------------------------------------

@pytest.mark.parametrize("case", _resnet50_shapes(2),
                         ids=lambda c: f"x{c[0][1:]}w{c[1]}s{c[2][0]}")
def test_route_at_every_resnet50_convolution(case):
    x_s, w_s, _, _ = case
    x = torch.empty(x_s, dtype=torch.int8, device="meta")
    w = torch.empty(w_s, dtype=torch.int8, device="meta")
    want = "sm90" if x_s[1] % 16 == 0 else "mma"
    assert k8._int8_conv_route(x, w, 1) == want


@pytest.mark.parametrize("x_s,w_s,groups,want", [
    ((2, 8, 13, 11), (12, 4, 3, 3), 2, "mma"),        # grouped
    ((4, 64, 7, 7), (64, 1, 3, 3), 64, "mma"),        # depthwise
    ((1, 6 * 64, 128, 1), (6 * 128, 64, 1, 1), 6, "mma"),  # int8_batch_mm
    ((2, 17, 9, 9), (32, 17, 3, 3), 1, "mma"),        # odd C
    ((2, 24, 9, 9), (32, 24, 3, 3), 1, "mma"),        # C not of 16
    ((2, 32, 9, 9), (24, 32, 3, 3), 1, "mma"),        # O not of 16
    ((2, 32, 9, 9), (8, 32, 1, 1), 1, "mma"),         # O below 16
    ((2, 32, 9), (64, 32, 3), 1, "sm90"),             # 1-D, lifted
    ((2, 16, 9, 9), (16, 16, 3, 3), 1, "sm90"),
    ((2, 48, 9, 9), (48, 48, 1, 1), 1, "sm90"),
    ((2, 2048, 7, 7), (512, 2048, 1, 1), 1, "sm90"),
    ((1, 32, 4, 4, 4), (32, 32, 1, 1, 1), 1, "mma"),  # 3-D: not taken
])
def test_route_keeps_grouped_and_odd_convolutions_on_mma(x_s, w_s, groups,
                                                         want):
    x = torch.empty(x_s, dtype=torch.int8, device="meta")
    w = torch.empty(w_s, dtype=torch.int8, device="meta")
    assert k8._int8_conv_route(x, w, groups) == want


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.int8),
                                    (torch.int8, torch.uint8),
                                    (torch.uint8, torch.int8)])
def test_route_needs_int8_operands(dtypes):
    x = torch.empty((2, 32, 9, 9), dtype=dtypes[0], device="meta")
    w = torch.empty((32, 32, 3, 3), dtype=dtypes[1], device="meta")
    assert k8._int8_conv_route(x, w, 1) == "mma"


def test_stem_stays_on_mma():
    # 3 channels; the sm90 kernel takes them only when handed them, padded
    x = torch.empty((32, 3, 224, 224), dtype=torch.int8, device="meta")
    w = torch.empty((64, 3, 7, 7), dtype=torch.int8, device="meta")
    assert k8._int8_conv_route(x, w, 1, (2, 2)) == "mma"


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("case", _resnet50_shapes(32),
                         ids=lambda c: f"x{c[0][1:]}w{c[1]}s{c[2][0]}")
def test_plan_at_resnet50_batch32_shapes(case):
    x_s, w_s, st, p = case
    plan = k8._sm90_plan(x_s, w_s, st, p, (1, 1), N_SM)
    O, C, KH, KW = w_s
    Cp = C if C % 16 == 0 else 16
    assert plan["C"] == Cp
    assert plan["k_tiles"] == KH * KW * -(-Cp // BK)
    assert plan["flat"] == (KH == KW == 1 and st == (1, 1))
    Ho, Wo = plan["Ho"], plan["Wo"]
    if plan["flat"]:
        assert plan["m_tiles"] == -(-plan["M"] // BM) and plan["rows"] == BM
    else:
        nt, ht, wt = plan["tile"]
        assert plan["rows"] == nt * ht * wt <= BM
        assert wt * st[1] <= 256 and ht * st[0] <= 256
        assert plan["m_tiles"] == \
            -(-Wo // wt) * -(-Ho // ht) * -(-x_s[0] // nt)
    assert plan["bn"] in (64, 128, 256)
    assert plan["bn"] == 64 or O > plan["bn"] // 2
    assert plan["n_tiles"] == -(-O // plan["bn"])
    assert plan["items"] == \
        plan["m_tiles"] * plan["n_tiles"] * plan["splits"]
    assert plan["grid"] == min(plan["items"], N_SM)
    assert plan["splits"] == 1 or plan["k_tiles"] // plan["splits"] >= 4


@pytest.mark.parametrize("Ho,Wo,stride,want", [
    (56, 56, (1, 1), (1, 4, 32)), (28, 28, (1, 1), (1, 4, 28)),
    (28, 28, (2, 2), (1, 4, 28)), (14, 14, (1, 1), (1, 9, 14)),
    (7, 7, (1, 1), (2, 7, 7)), (7, 7, (2, 2), (2, 7, 7)),
    (112, 112, (2, 2), (1, 4, 32)), (3, 200, (1, 8), (1, 3, 32)),
])
def test_spatial_tile(Ho, Wo, stride, want):
    nt, ht, wt = k8._sm90_tile(32, Ho, Wo, stride)
    assert (nt, ht, wt) == want
    assert nt * ht * wt <= BM and wt * stride[1] <= 256


def test_plan_choices():
    # 1 x 1 at stride 1: flat tiles; 3 x 3 at 7 x 7: two images a tile
    plan = k8._sm90_plan((32, 512, 7, 7), (512, 512, 3, 3), (1, 1), (1, 1),
                         (1, 1), N_SM)
    assert not plan["flat"] and plan["tile"] == (2, 7, 7)
    assert plan["k_tiles"] == 36
    plan = k8._sm90_plan((32, 64, 56, 56), (256, 64, 1, 1), (1, 1), (0, 0),
                         (1, 1), N_SM)
    assert plan["flat"] and plan["bn"] == 256 and plan["items"] == 784
    # batch 1 at 7 x 7: one pixel tile and a long K, split to fill SMs
    plan = k8._sm90_plan((1, 512, 7, 7), (512, 512, 3, 3), (1, 1), (1, 1),
                         (1, 1), N_SM)
    assert plan["splits"] > 1


@pytest.mark.parametrize("bn,splits", [(96, None), (512, None), (64, 0),
                                       (64, 100)])
def test_plan_refuses_what_the_kernel_cannot_take(bn, splits):
    with pytest.raises(mx.MXNetError, match="sm90 plan"):
        k8._sm90_plan((2, 64, 7, 7), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1),
                      N_SM, bn=bn, splits=splits)


# -- the operands and the kernel's arithmetic --------------------------------

def test_operands_are_nhwc_and_ohwi():
    rs = onp.random.RandomState(1)
    x, w = _s8(rs, (2, 32, 5, 6)), _s8(rs, (48, 32, 3, 3))
    xh, wh, Cp = k8._sm90_operands(x, w)
    assert Cp == 32 and xh.shape == (2, 5, 6, 32) and xh.is_contiguous()
    assert wh.shape == (48, 3, 3, 32) and wh.is_contiguous()
    assert torch.equal(xh, x.permute(0, 2, 3, 1))
    assert torch.equal(wh, w.permute(0, 2, 3, 1))
    # a channels-last x and a 1 x 1 weight are read in place
    xc = x.contiguous(memory_format=torch.channels_last)
    w1 = _s8(rs, (48, 32, 1, 1))
    xh, wh, _ = k8._sm90_operands(xc, w1)
    assert xh.data_ptr() == xc.data_ptr() and wh.data_ptr() == w1.data_ptr()


def test_small_c_is_padded_with_zero_channels():
    rs = onp.random.RandomState(2)
    x, w = _s8(rs, (2, 3, 9, 9)), _s8(rs, (64, 3, 7, 7))
    xh, wh, Cp = k8._sm90_operands(x, w)
    assert Cp == 16 and xh.shape == (2, 9, 9, 16)
    assert wh.shape == (64, 7, 7, 16)
    assert not xh[..., 3:].any() and not wh[..., 3:].any()
    assert torch.equal(xh[..., :3], x.permute(0, 2, 3, 1))


@pytest.mark.parametrize("case", EDGES, ids=lambda c: f"x{c[0]}w{c[1]}")
@pytest.mark.parametrize("bn,splits", [(None, None), (64, 1), (256, 3)])
def test_emulated_sm90_arithmetic_equals_plain_bitwise(case, bn, splits):
    x_s, w_s, st, p, d = case
    rs = onp.random.RandomState(sum(x_s) + sum(w_s))
    x, w = _s8(rs, x_s), _s8(rs, w_s)
    k_tiles = k8._sm90_plan(x_s, w_s, st, p, d, N_SM)["k_tiles"]
    plan = k8._sm90_plan(x_s, w_s, st, p, d, N_SM, bn=bn,
                         splits=splits and min(splits, k_tiles))
    want = k8._int8_conv_ref(x, w, st, p, d, 1)
    assert torch.equal(_emulate(x, w, st, p, d, plan), want)


@pytest.mark.parametrize("case", [c for c in _resnet50_shapes(1)
                                  if c[0][1] % 16 == 0],
                         ids=lambda c: f"x{c[0][1:]}w{c[1]}s{c[2][0]}")
def test_emulated_sm90_arithmetic_at_resnet50_shapes(case):
    x_s, w_s, st, p = case
    rs = onp.random.RandomState(x_s[1] + w_s[0])
    x, w = _s8(rs, x_s), _s8(rs, w_s)
    plan = k8._sm90_plan(x_s, w_s, st, p, (1, 1), N_SM)
    assert torch.equal(_emulate(x, w, st, p, (1, 1), plan),
                       k8._int8_conv_ref(x, w, st, p, (1, 1), 1))


# -- the wrapper off the card ------------------------------------------------

@pytest.mark.parametrize("route", [None, "sm90", "mma"])
@pytest.mark.parametrize("case", [
    ((32, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1)),
    ((32, 512, 7, 7), (512, 512, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((4, 256, 14, 14), (1024, 256, 1, 1), (2, 2), (0, 0), (1, 1)),
    ((2, 32, 9), (64, 32, 3), (2,), (1,), (1,)),
])
def test_meta_route_returns_the_shape_and_dtype(route, case):
    x_s, w_s, st, p, d = case
    x = torch.empty(x_s, dtype=torch.int8, device="meta")
    w = torch.empty(w_s, dtype=torch.int8, device="meta")
    if route == "sm90" and k8._int8_conv_route(x, w, 1) != "sm90":
        with pytest.raises(mx.MXNetError, match="route 'sm90'"):
            k8.int8_conv(x, w, st, p, d, 1, route=route)
        return
    y = k8.int8_conv(x, w, st, p, d, 1, route=route)
    assert y.device.type == "meta" and y.dtype == torch.int32
    assert tuple(y.shape) == k8.conv_output_shape(x_s, w_s, st, p, d)


@pytest.mark.parametrize("route", ["sm90", "mma"])
def test_cpu_tensors_take_the_plain_version_on_either_route(route):
    rs = onp.random.RandomState(3)
    x, w = _s8(rs, (2, 16, 7, 7)), _s8(rs, (32, 16, 3, 3))
    got = k8.int8_conv(x, w, (1, 1), (1, 1), (1, 1), 1, route=route)
    assert torch.equal(got, k8._int8_conv_ref(x, w, (1, 1), (1, 1), (1, 1),
                                              1))


def test_sm90_route_refused_where_the_rule_gives_mma():
    rs = onp.random.RandomState(4)
    x, w = _s8(rs, (2, 8, 9, 9)), _s8(rs, (12, 4, 3, 3))
    with pytest.raises(mx.MXNetError, match="route 'sm90'"):
        k8.int8_conv(x, w, (1, 1), (0, 0), (1, 1), 2, route="sm90")
    with pytest.raises(mx.MXNetError, match="unknown route"):
        k8.int8_conv(x, w, (1, 1), (0, 0), (1, 1), 2, route="wgmma")


def test_sm90_source_holds_wgmma_s8_and_tma():
    src = open(os.path.join(os.path.dirname(k8.__file__), "..", "csrc",
                            "int8_conv_sm90.cu")).read()
    for op in ("wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8",
               "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8",
               "cp.async.bulk.tensor.2d", "cp.async.bulk.tensor.3d",
               "cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
               "CU_TENSOR_MAP_SWIZZLE_128B", "mxtt_int8_conv_sm90",
               "mxtt_int8_to_nhwc"):
        assert op in src, op


@pytest.mark.parametrize("stride,want", [((1, 1), "sm90"), ((8, 8), "sm90"),
                                         ((9, 1), "mma"), ((1, 16), "mma")])
def test_route_needs_strides_tma_can_step(stride, want):
    x = torch.empty((2, 32, 40, 40), dtype=torch.int8, device="meta")
    w = torch.empty((32, 32, 1, 1), dtype=torch.int8, device="meta")
    assert k8._int8_conv_route(x, w, 1, stride) == want
