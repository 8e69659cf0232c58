"""The launch plans of K6 paged_attention and K4 ubn_norm's rows, on the CPU.

K6 sweeps each lane only up to its own position, in spans of 32, 64 or 128
positions, with the softmax glue inside the kernel; K4 spreads a row over a
cluster of up to 8 blocks below the SM count.  The kernels run only on the
card (test_torch_cuda.py holds them there bit for bit); here the plans they
follow are pure Python (`ops.pa_span`, `ops.pa_sweep`, `ops.pa_layout`,
`ops.ubn_cluster`), tested at their edges, and each kernel's arithmetic is
repeated in PyTorch step by step as the kernel takes it (span maxima, the
sweep cut, the in-kernel glue, fp32 correctly rounded division and square
root, float64 sums per cluster slice) and held bit for bit against the
unchanged plain versions in `kernels/ref.py`.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

NEG_INF = ref.NEG_INF


# --------------------------------------------------------------------------
# K6: the span plan, the sweep and the workspace
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,kv,t,sms,want", [
    (4, 8, 512, 132, 32),        # a serve decode step
    (1, 8, 512, 132, 32),        # a prompt-tail token
    (8, 8, 512, 132, 32),        # 512 blocks of 64: under 4 an SM
    (9, 8, 512, 132, 64),        # 576 blocks of 64
    (17, 8, 512, 132, 128),      # 544 blocks of 128
    (16, 8, 2048, 132, 128),     # chip_smoke's long-context row
    (4, 8, 512, 16, 128)])       # a smaller card fills sooner
def test_pa_span_from_shapes(b, kv, t, sms, want):
    span = ops.pa_span(b, kv, t, sms)
    assert span == want
    assert span in (32, 64, 128)
    if span > 32:                # the grid gives every SM four blocks
        assert b * kv * -(-t // span) >= 4 * sms


@pytest.mark.parametrize("q_pos,t_valid,want", [
    ([0, 15, 16, 511], 512, [1, 16, 17, 512]),      # lane 0, page edges
    ([300, 52, 271, 79], 100, [100, 53, 100, 80]),  # t_valid below q_pos
    ([-1, 5, -7, 600], 512, [512, 6, 512, 512]),    # masked rows sweep all
    ([5, 60], 0, [512, 512]),                       # t_valid 0: all masked
    ([1000, 2], 2000, [512, 3])])                   # past T: T
def test_pa_sweep_edges(q_pos, t_valid, want):
    got = ops.pa_sweep(torch.tensor(q_pos, dtype=torch.int32), t_valid, 512,
                       2.0 ** -13, 128 ** -0.5, 128)
    assert got.tolist() == want


def test_pa_sweep_full_where_scores_could_reach_the_mask():
    """Past the bound 128 * 128 * dh * |kq| * sm >= 9e8 a live score could
    come within 200 of -1e9, where exp(-1e9 - m) need not be 0: every lane
    then sweeps all T, as the plain version does."""
    q_pos = torch.tensor([3, 40], dtype=torch.int32)
    sm = 128 ** -0.5
    edge = 9.0e8 / (16384.0 * 128 * sm)
    assert ops.pa_sweep(q_pos, 512, 512, edge * 0.99, sm, 128).tolist() \
        == [4, 41]
    assert ops.pa_sweep(q_pos, 512, 512, edge * 1.01, sm, 128).tolist() \
        == [512, 512]
    assert ops.pa_sweep(q_pos, 512, 512, math.nan, sm, 128).tolist() \
        == [512, 512]


@pytest.mark.parametrize("b,kv,g,dh,t,span", [
    (4, 8, 4, 128, 512, 32), (16, 8, 4, 128, 2048, 128), (1, 1, 48, 64, 16,
                                                          32)])
def test_pa_layout_aligned_and_disjoint(b, kv, g, dh, t, span):
    lay = ops.pa_layout(b, kv, g, dh, t, span)
    h = kv * g
    nspan = -(-t // span)
    regions = [(0, 4 * b * h * dh + 4 * (2 * b * kv + 1)),   # zeroed
               (lay["glue"], 8), (lay["ml"], 8 * b * h),
               (lay["lsum"], 8 * b * h * nspan),
               (lay["smax"], 4 * b * h * nspan),
               (lay["e"], 4 * b * h * t)]
    assert lay["zero"] >= regions[0][1] and lay["zero"] % 16 == 0
    for (o1, n1), (o2, _) in zip(regions, regions[1:]):
        assert o2 % 16 == 0 and o1 + n1 <= o2
    assert lay["total"] == lay["e"] + 4 * b * h * t


def _pa_inputs(seed, b, kv, g, dh, page, nb, q_pos, dead_lane=False):
    r = np.random.default_rng(seed)
    p = b * nb + 1
    i8 = lambda *s: torch.from_numpy(  # noqa: E731
        r.integers(-127, 128, s).astype(np.int8))
    table = torch.arange(1, p, dtype=torch.int32).reshape(b, nb)
    if dead_lane:
        table[0] = 0
    return (i8(b, kv * g, dh), i8(p, page, kv, dh), i8(p, page, kv, dh),
            table, torch.tensor(q_pos, dtype=torch.int32))


def emulate_pa(q8, kp, vp, table, q_pos, t_valid, qs, ks, vs, *, sm_scale,
               k_a=8, span=32):
    """K6 as csrc/paged_attention.cu takes it, lane by lane on the CPU:
    scores of the swept positions only, m the max of the span maxima, e =
    exp32(s - m) and l their float64 sum rounded once, the batch's step
    from max 1/l (fp32 division), p = e / l in fp32, the p8 codes (0 past
    the sweep) and the int32 p.v, scaled by step * v_scale."""
    p_cnt, page, kv, dh = kp.shape
    b, h, _ = q8.shape
    g, t = h // kv, table.shape[1] * page
    kq = qs * ks
    sweep = ops.pa_sweep(q_pos, t_valid, t, float(kq), sm_scale, dh)
    tb = table.long().clamp(0, p_cnt - 1)
    es, ms, ls = [], torch.empty(b, h), torch.empty(b, h)
    for lane in range(b):
        sw = int(sweep[lane])
        pos = torch.arange(sw)
        k = kp[tb[lane, pos // page], pos % page]              # (sw, kv, dh)
        s = ref._int_dot(q8[lane].reshape(kv, g, dh),
                         k.permute(1, 2, 0)).float() * kq
        s = s * sm_scale
        ok = (pos <= q_pos[lane]) & (pos < t_valid)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF)).reshape(h, sw)
        m = torch.stack([s[:, i:i + span].amax(-1)
                         for i in range(0, sw, span)], -1).amax(-1)
        if sw < t:
            m = torch.clamp(m, min=NEG_INF)
        e = ref._exp32(s - m[:, None])
        es.append(e)
        ms[lane], ls[lane] = m, e.double().sum(-1).float()
    s_ = 2.0 ** (k_a - 1)
    amax = torch.round(torch.amax(1.0 / ls) * s_) / s_
    step = torch.clamp(ref._pow2_ceil(amax), min=2.0 ** -24) / s_
    pinv, pv = 1.0 / step, step * vs
    p8 = torch.zeros((b, h, t), dtype=torch.int8)
    out = torch.empty((b, h, dh))
    for lane in range(b):
        sw = es[lane].shape[1]
        pg = torch.round(es[lane] / ls[lane][:, None] * s_) / s_
        code = torch.clamp(torch.round(pg * pinv), -s_ + 1, s_ - 1)
        p8[lane, :, :sw] = code.to(torch.int8)
        pos = torch.arange(sw)
        v = vp[tb[lane, pos // page], pos % page]              # (sw, kv, dh)
        acc = ref._int_dot(code.to(torch.int8).reshape(kv, g, sw),
                           v.permute(1, 0, 2))
        out[lane] = acc.reshape(h, dh).float() * pv
    return {"m": ms, "l": ls, "p8": p8, "out": out}


@pytest.mark.parametrize("case", [
    "ragged", "page_edges_dead_lane", "t_valid_below", "all_masked",
    "t_valid_0", "g1", "g8", "g48", "dh64", "k_a4", "huge_scales",
    "long_spans"])
def test_pa_emulation_equals_plain(case):
    """Sweeping only the live positions, the glue's formulas inside the
    kernel and the fp32 divisions give the plain version's m, l, p8 and
    output bit for bit."""
    kv, g, dh, page, nb, span, k_a = 2, 4, 32, 4, 8, 32, 8
    q_pos, t_valid, dead = [5, 17, 31, 2], 32, False
    scales = (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)
    if case == "page_edges_dead_lane":
        q_pos, dead = [0, 3, 4, 31], True
    elif case == "t_valid_below":
        q_pos, t_valid = [30, 7, 25, 12], 10
    elif case == "all_masked":
        q_pos = [-1, 7, -3, 12]
    elif case == "t_valid_0":
        t_valid = 0
    elif case in ("g1", "g8", "g48"):
        g = int(case[1:])
        kv = 1 if g == 48 else 2
    elif case == "dh64":
        dh = 64
    elif case == "k_a4":
        k_a = 4
    elif case == "huge_scales":
        scales = (2.0 ** 10, 2.0 ** 10, 1.0)
    elif case == "long_spans":
        nb, span, q_pos, t_valid = 64, 128, [200, 255, 129, 64], 256
    q8, kp, vp, table, qp = _pa_inputs(len(case), 4, kv, g, dh, page, nb,
                                       q_pos, dead)
    sc = [torch.tensor(s, dtype=torch.float32) for s in scales]
    kw = dict(sm_scale=dh ** -0.5, k_a=k_a)
    got = emulate_pa(q8, kp, vp, table, qp, t_valid, *sc, span=span, **kw)
    want = ref.paged_attention_parts(q8, kp, vp, table, qp, t_valid, *sc,
                                     **kw)
    for part in ("m", "l", "p8", "out"):
        assert torch.equal(got[part], want[part]), part
    if case == "huge_scales":    # every lane swept all T positions
        assert ops.pa_sweep(qp, t_valid, nb * page, float(sc[0] * sc[1]),
                            kw["sm_scale"], dh).tolist() == [nb * page] * 4


# --------------------------------------------------------------------------
# K4 rows: the cluster route and its arithmetic
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,want", [
    (1, 8), (4, 8), (16, 8), (17, 4), (33, 4), (34, 2), (66, 2), (67, 1),
    (131, 1), (132, 1), (133, 1), (512, 1), (4096, 1)])
def test_ubn_cluster_route(m, want):
    cl = ops.ubn_cluster(m, 132)
    assert cl == want
    assert cl == 1 or m * cl <= 132


def emulate_ubn_rows(x, gamma, beta, kind, cl, *, k_mu=16, k_sigma=16,
                     k_bn=16, k_gamma=8, k_beta=8, eps=2.0 ** -8):
    """K4's rows as csrc/ubn.cu takes them: a row cut into `cl` slices of
    whole VEC-element groups (the kernel's per-block slices), each summed
    in float64, the sums added and rounded once to fp32 (the kernel adds
    per-warp partials in another fixed order; either order's float64 sum
    rounds to the plain version's fp32 statistic here); fp32 correctly
    rounded division and sqrt (PyTorch's fp32 `/` and `sqrt` on the CPU
    are IEEE)."""
    m, n = x.shape
    vec = 4 if n % 4 == 0 else 1
    groups = n // vec
    per = -(-groups // cl)
    tss = torch.zeros(m, dtype=torch.float64)
    ts = torch.zeros(m, dtype=torch.float64)
    for r in range(cl):
        lo, hi = r * per * vec, min(groups, (r + 1) * per) * vec
        xs = x[:, lo:hi].double()
        tss, ts = tss + (xs * xs).sum(1), ts + xs.sum(1)
    qd = lambda v, k: torch.round(v * 2.0 ** (k - 1)) / 2.0 ** (k - 1)  # noqa
    nf = torch.tensor(float(n))
    mean_sq = tss.float() / nf
    if kind == "layer":
        mu = ts.float() / nf
        var = mean_sq - mu * mu
        mu_q = qd(mu, k_mu)
        denom = qd(torch.sqrt(torch.clamp(var, min=0.0)), k_sigma) + eps
        xh = (x - mu_q[:, None]) / denom[:, None]
    else:
        denom = qd(torch.sqrt(mean_sq), k_sigma) + eps
        xh = x / denom[:, None]
    y = qd(gamma, k_gamma)[None, :] * qd(xh, k_bn)
    if kind == "layer":
        y = y + qd(beta, k_beta)[None, :]
    return y


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("cl", [1, 2, 4, 8])
@pytest.mark.parametrize("n,grid", [(4096, False), (4097, False),
                                    (100, True)])
def test_ubn_rows_emulation_equals_plain(kind, cl, n, grid):
    """Splitting a row over a cluster, summing the slices in rank order,
    and the fp32 division and sqrt give the plain version's output bit for
    bit (N(0, 1) values and k_BN-grid values)."""
    r = np.random.default_rng(n + cl)
    x = torch.from_numpy((r.standard_normal((6, n)) * 2 + 0.3)
                         .astype(np.float32))
    if grid:
        x = torch.round(x * 2.0 ** 15) / 2.0 ** 15
    gamma = torch.from_numpy((1 + 0.1 * r.standard_normal(n))
                             .astype(np.float32))
    beta = torch.from_numpy((0.1 * r.standard_normal(n)).astype(np.float32))
    want = ref.ubn_norm(x, gamma, beta, kind=kind)
    assert torch.equal(emulate_ubn_rows(x, gamma, beta, kind, cl), want)
    assert torch.equal(ops.ubn_norm(x, gamma, beta, kind=kind), want)
