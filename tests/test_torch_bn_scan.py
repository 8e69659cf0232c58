"""The launch plans of K4 ubn_norm's "batch" kind and K9 selective_scan, on
the CPU.

K4 batch takes a column strip over a thread-block cluster (x read once)
where the strip fits in shared memory, and two passes otherwise (partials
with the statistics folded into the last block of each column group, then
the normalize); K9 splits a channel's N states over N / 4 threads and
stages a tile of steps in shared memory.  The kernels run only on the card
(test_torch_cuda.py holds them there bit for bit); here the plans they
follow are pure Python (`ops.ubn_batch_plan`, `ops.sscan_plan`), tested at
every shape of the path and at ragged ones, and each kernel's arithmetic is
repeated in PyTorch step by step in the kernel's order (K4: the float64
sums per thread, the warp's shuffle tree, the warps, the cluster's blocks
or the chunk runs; K9: the split states' products gathered in n order, tile
by tile) and held bit for bit against the unchanged plain versions in
`kernels/ref.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# ResNet-50 at batch 32, 224 px: (M, C) of each quantized BN, and the calls
# a training step makes at that shape (52 in all)
RESNET50_BN = {(100352, 64): 6, (100352, 256): 4, (100352, 128): 1,
               (25088, 128): 7, (25088, 512): 5, (25088, 256): 1,
               (6272, 256): 11, (6272, 1024): 7, (6272, 512): 1,
               (1568, 512): 5, (1568, 2048): 4}


# --------------------------------------------------------------------------
# K4 batch: the plan
# --------------------------------------------------------------------------


def test_resnet50_bn_shapes_are_the_step():
    assert sum(RESNET50_BN.values()) == 52
    assert sum(m * c * k for (m, c), k in RESNET50_BN.items()) == 329_957_376


@pytest.mark.parametrize("m,n,route,cl", [
    (100352, 64, "two_pass", 1), (100352, 256, "two_pass", 1),
    (100352, 128, "two_pass", 1), (25088, 128, "two_pass", 1),
    (25088, 512, "two_pass", 1), (25088, 256, "two_pass", 1),
    (6272, 256, "two_pass", 1), (6272, 1024, "strip", 2),
    (6272, 512, "strip", 4), (1568, 512, "strip", 4),
    (1568, 2048, "strip", 1)])
def test_ubn_batch_plan_at_the_step_shapes(m, n, route, cl):
    p = ops.ubn_batch_plan(m, n, 132)
    assert (p["route"], p["cl"]) == (route, cl)
    if route == "strip":
        assert p["cw"] == 16 and p["groups"] == -(-n // 16)
        assert p["rows"] == -(-m // cl)
        assert p["rows"] * 64 <= ops.UBN_TILE_BYTES
        assert p["blocks"] == p["groups"] * cl >= 0.9 * 132
    else:
        assert p["cw"] == 32 and p["groups"] == -(-n // 32)
        assert p["rows"] * p["chunks"] >= m > p["rows"] * (p["chunks"] - 1)
        assert p["chunks"] <= 128 and -(-m // p["span"]) < 65536
        assert p["blocks"] == p["groups"] * p["chunks"]


@pytest.mark.parametrize("m,n", [(1, 9), (1, 4096), (63, 5), (64, 64),
                                 (257, 33), (1000, 96), (1000, 4096),
                                 (12345, 96), (3328, 2048), (3329, 2048),
                                 (30001, 40), (200000, 3), (4_000_000, 64)])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_ubn_batch_plan_ragged(m, n, sms):
    """Every plan fits the kernel's limits: a strip fits in shared memory,
    covers M and fills the card; the two-pass chunks follow from M alone."""
    p = ops.ubn_batch_plan(m, n, sms)
    if p["route"] == "strip":
        assert p["cw"] == 16 and p["cl"] in (1, 2, 4)
        assert p["rows"] * p["cl"] >= m > p["rows"] * (p["cl"] - 1)
        assert p["rows"] * 64 <= ops.UBN_TILE_BYTES
        assert 10 * p["blocks"] >= 9 * sms
        # no smaller cluster would do
        assert p["cl"] == 1 or 10 * p["groups"] * p["cl"] // 2 < 9 * sms \
            or -(-m // (p["cl"] // 2)) * 64 > ops.UBN_TILE_BYTES
    else:
        assert p == ops._ubn_two_pass(m, n)
        assert 0 < p["chunks"] <= 128
        assert p["rows"] == max(256, -(-m // 128))


def test_ubn_batch_plan_from_the_sm_count():
    # fewer SMs fill with fewer strips; a strip needs M <= 4 * 3328 rows
    assert ops.ubn_batch_plan(6272, 256, 132)["route"] == "two_pass"
    assert ops.ubn_batch_plan(6272, 256, 64)["cl"] == 4
    assert ops.ubn_batch_plan(6272, 256, 32)["cl"] == 2
    assert ops.ubn_batch_plan(1568, 2048, 256)["cl"] == 2
    assert ops.ubn_batch_plan(13312, 4096, 132)["cl"] == 4
    assert ops.ubn_batch_plan(13313, 4096, 132)["route"] == "two_pass"


# --------------------------------------------------------------------------
# K4 batch: the kernel's arithmetic, step by step
# --------------------------------------------------------------------------

BT = 256                              # threads of a block (csrc/ubn.cu)


def _block_sums(xb: torch.Tensor, cw: int, vec: int) -> tuple:
    """A block's float64 column sums of xb (rows, C) in the kernel's order:
    row lane i sums rows i, i + rpi, ... in order; the warp's row lanes by a
    shuffle tree (adjacent pairs first); the 8 warps in order from 0."""
    tpr = cw // vec
    rpi, per_warp = BT // tpr, 32 // tpr
    n = xb.shape[1]
    s = torch.zeros((rpi, n), dtype=torch.float64)
    ss = torch.zeros((rpi, n), dtype=torch.float64)
    for r0 in range(0, xb.shape[0], rpi):
        blk = xb[r0:r0 + rpi]
        k = blk.shape[0]
        s[:k] = s[:k] + blk
        ss[:k] = ss[:k] + blk * blk                  # fma: d*d is exact
    s, ss = s.view(BT // 32, per_warp, n), ss.view(BT // 32, per_warp, n)
    while s.shape[1] > 1:
        s, ss = s[:, 0::2] + s[:, 1::2], ss[:, 0::2] + ss[:, 1::2]
    ts = torch.zeros(n, dtype=torch.float64)
    tss = torch.zeros(n, dtype=torch.float64)
    for w in range(BT // 32):
        ts, tss = ts + s[w, 0], tss + ss[w, 0]
    return ts, tss


def emulate_ubn_batch(x, gamma, beta, plan, vec, *, k_mu=16, k_sigma=16,
                      k_bn=16, k_gamma=8, k_beta=8, eps=2.0 ** -8):
    """K4 "batch" as the kernel computes it under `plan`."""
    m, n = x.shape
    x64 = x.double()
    if plan["route"] == "strip":      # the cluster's blocks in rank order
        parts = [_block_sums(x64[r:r + plan["rows"]], plan["cw"], vec)
                 for r in range(0, plan["cl"] * plan["rows"], plan["rows"])]
        ts = torch.zeros(n, dtype=torch.float64)
        tss = torch.zeros(n, dtype=torch.float64)
        for a, b in parts:
            ts, tss = ts + a, tss + b
    else:                             # eight runs of chunks, then the runs
        rows, chunks = plan["rows"], plan["chunks"]
        parts = [_block_sums(x64[k * rows:(k + 1) * rows], 32, vec)
                 for k in range(chunks)]
        per = -(-chunks // 8)
        ts = torch.zeros(n, dtype=torch.float64)
        tss = torch.zeros(n, dtype=torch.float64)
        for q in range(8):
            us = torch.zeros(n, dtype=torch.float64)
            uss = torch.zeros(n, dtype=torch.float64)
            for a, b in parts[q * per:(q + 1) * per]:
                us, uss = us + a, uss + b
            ts, tss = ts + us, tss + uss
    mf = torch.tensor(float(m))
    mean_sq = ref._div32(tss.float(), mf)
    mu = ref._div32(ts.float(), mf)
    var = mean_sq - mu * mu
    den = ref._qd(ref._sqrt32(torch.clamp(var, min=0.0)), k_sigma) + eps
    xh = ref._qd(ref._div32(x - ref._qd(mu, k_mu), den), k_bn)
    return ref._qd(gamma, k_gamma) * xh + ref._qd(beta, k_beta)


def _bn_inputs(m, n, seed, grid):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, n)) * 2 + 0.3).astype(np.float32)
    if grid:                          # the convolutions' grid values
        x = np.round(x * 64) / 64
    g = (1 + 0.1 * r.standard_normal(n)).astype(np.float32)
    b = (0.1 * r.standard_normal(n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)


@pytest.mark.parametrize("m,n,sms,two_pass", [
    (1568, 64, 4, False), (1568, 64, 8, False), (1568, 64, 16, False), (6272, 48, 8, False),
    (13312, 16, 4, False), (257, 33, 3, False), (1, 9, 1, False),
    (30001, 40, 132, True), (5000, 33, 132, True), (700, 8, 132, True),
    (1, 9, 132, True)])
@pytest.mark.parametrize("grid", [False, True])
def test_ubn_batch_emulation_equals_plain(m, n, sms, two_pass, grid):
    x, g, b = _bn_inputs(m, n, m + n, grid)
    plan = ops._ubn_two_pass(m, n) if two_pass else ops.ubn_batch_plan(
        m, n, sms)
    assert plan["route"] == ("two_pass" if two_pass else "strip")
    want = ref.ubn_norm(x, g, b, kind="batch")
    for vec in ((4, 1) if n % 4 == 0 else (1,)):
        assert torch.equal(emulate_ubn_batch(x, g, b, plan, vec), want), vec


def test_ubn_batch_counters_are_per_device_and_reused():
    dev = torch.device("cpu")
    ops._UBN_COUNTS.pop(dev, None)
    c1 = ops._ubn_counts(dev, 8)
    assert c1.dtype == torch.int32 and int(c1.abs().sum()) == 0
    assert ops._ubn_counts(dev, 64) is c1            # reused, never zeroed
    c2 = ops._ubn_counts(dev, 1000)                  # grown, zeroed once
    assert c2.numel() >= 1000 and int(c2.abs().sum()) == 0
    ops._UBN_COUNTS.pop(dev, None)


# --------------------------------------------------------------------------
# K9: the plan and the split-state arithmetic
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,route,tile,stages,blocks", [
    ((1, 16, 8192, 16), "staged", 16, 1, 256),      # a prefill page
    ((4, 1, 8192, 16), "direct", 1, 0, 1024),       # a decode step
    ((1, 1, 8192, 16), "direct", 1, 0, 256),        # a prompt-tail token
    ((1, 4096, 8192, 16), "staged", 4, 4, 256),     # train_4k
    ((1, 4097, 8192, 16), "staged", 4, 4, 256),
    ((2, 37, 1000, 4), "staged", 4, 4, 16),         # the reduced N
    ((2, 17, 64, 4), "staged", 4, 4, 2),
    ((3, 33, 65, 16), "staged", 4, 4, 9),
    ((1, 2, 8192, 16), "staged", 2, 1, 256),
    ((2, 0, 64, 16), "direct", 1, 0, 4),            # no steps
    ((64, 64, 8192, 16), "staged", 4, 2, 16384)])   # many blocks an SM
def test_sscan_plan(shape, route, tile, stages, blocks):
    b, s, d, n = shape
    p = ops.sscan_plan(b, s, d, n, 132)
    assert (p["route"], p["tile"], p["stages"], p["blocks"]) == \
        (route, tile, stages, blocks)
    assert p["lanes"] == n // 4 and p["chans"] * p["lanes"] == 128
    if route == "staged":
        # a step of the block's channels is 4 KB of a and b at any N
        assert p["smem"] == 64 + stages * tile * (4096 + 4 * n)
        assert p["smem"] <= 227 * 1024
        assert s > 1 and (tile == s or s > 16)


def emulate_sscan(a, b, c, h0, plan):
    """K9 as the kernel computes it: tiles of `tile` steps (one step a tile
    on the direct route), h carried across them; each thread's four states
    h = a*h then + b in fp32; its four products exact in float64; the
    channel's first thread adds its own four, then each other thread's four
    in turn (n order), and rounds once."""
    bsz, s, d, n = a.shape
    lanes = n // 4
    h = torch.zeros((bsz, d, n)) if h0 is None else h0.clone()
    y = torch.empty((bsz, s, d))
    for t0 in range(0, s, plan["tile"]):
        for t in range(t0, min(s, t0 + plan["tile"])):
            h = a[:, t] * h
            h = h + b[:, t]
            p = (h.double() * c[:, t, None, :].double()).view(
                bsz, d, lanes, 4)
            acc = p[..., 0, 0]
            for k in range(1, 4):
                acc = acc + p[..., 0, k]
            for j in range(1, lanes):            # the shuffled products
                for k in range(4):
                    acc = acc + p[..., j, k]
            y[:, t] = acc.float()
    return y, h


@pytest.mark.parametrize("shape", [(1, 16, 256, 16), (4, 1, 256, 16),
                                   (1, 17, 96, 16), (2, 33, 40, 4),
                                   (1, 4097, 8, 16), (3, 5, 65, 16),
                                   (2, 0, 8, 4)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_sscan_emulation_equals_plain(shape, with_h0):
    r = np.random.default_rng(sum(shape))
    b, s, d, n = shape
    dt = np.exp(r.uniform(np.log(1e-3), np.log(1e-1), (b, s, d)))
    a = torch.from_numpy(np.exp(dt[..., None] * -np.arange(1, n + 1))
                         .astype(np.float32))
    bb = torch.from_numpy((0.1 * r.standard_normal(shape)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((b, s, n)).astype(np.float32))
    h0 = torch.from_numpy(r.standard_normal((b, d, n)).astype(np.float32)) \
        if with_h0 else None
    plan = ops.sscan_plan(b, s, d, n, 132)
    y, h = emulate_sscan(a, bb, c, h0, plan)
    yp, hp = ref.selective_scan(a, bb, c, h0)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    # the CPU route of the op is the plain version
    yo, ho = ops.selective_scan(a, bb, c, h0)
    assert torch.equal(yo, yp) and torch.equal(ho, hp)
