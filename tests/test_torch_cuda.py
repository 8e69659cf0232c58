"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the reference package, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel equals its plain version bit for bit: K1, K2, K3, K7 and K8
by construction (integer work, or one rounding per element); K4 (rows and
batch columns), K5 and K6 because both sides take their sums in float64
(K5's sums of quantized probabilities are exact in fp32) and every
division, sqrt and exp in float64, each rounded once to fp32 (K5's
per-score probability codes come from exact thresholds of that exp,
checked over every fp32 input); K9 because both sides round h twice per
step and sum y in float64 in n order; K9b because both sides recompute h
so, round each product and sum of the reverse recurrence once and add
dc's float64 products in one stated order; on bf16 carriers both run
that fp32 arithmetic and round each output once to bf16.
Without a card each test skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _i8(g, shape, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.cuda
def test_cuda_qmatmul_quantize_gather_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for m, k, n in ((4, 4096, 1024), (16, 256, 72), (5, 100, 30)):
        a, b = _i8(g, (m, k), cuda), _i8(g, (k, n), cuda)
        assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))
        inv = torch.tensor(2.0 ** -12, device=cuda)
        assert torch.equal(ops.qmatmul(a, b, inv), ref.qmatmul(a, b, inv))
        x = torch.randn((m, k), generator=g, device=cuda)
        assert torch.equal(ops.quantize(x, 32.0), ref.quantize(
            x, torch.tensor(32.0, device=cuda)))
    a, b = _i8(g, (8, 48, 128), cuda), _i8(g, (8, 128, 40), cuda)
    assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))
    pages = _i8(g, (9, 16, 8, 128), cuda)
    table = torch.tensor([[3, 0, 12], [-1, 8, 2]], device=cuda,
                         dtype=torch.int32)               # ids clamp
    assert torch.equal(ops.page_gather(pages, table),
                       ref.page_gather(pages, table))


@pytest.mark.cuda
def test_cuda_ubn_and_paged_attention_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((64, 4096), generator=g, device=cuda)
    gamma = 1.0 + 0.1 * torch.randn(4096, generator=g, device=cuda)
    beta = 0.1 * torch.randn(4096, generator=g, device=cuda)
    assert torch.equal(ops.ubn_norm(x, gamma), ref.ubn_norm(x, gamma))
    assert torch.equal(ops.ubn_norm(x, gamma, beta, kind="layer"),
                       ref.ubn_norm(x, gamma, beta, kind="layer"))
    # 4 lanes of 32 query / 8 KV heads of 128 over ragged contexts; lane 0
    # is dead (its table row is the trash page 0)
    r = np.random.default_rng(2)
    kp, vp = (torch.from_numpy(r.integers(-127, 128, (33, 16, 8, 128))
                               .astype(np.int8)).to(cuda) for _ in range(2))
    q8 = torch.from_numpy(r.integers(-127, 128, (4, 32, 128))
                          .astype(np.int8)).to(cuda)
    table = torch.zeros((4, 8), dtype=torch.int32)
    table[1:, :] = torch.arange(1, 25, dtype=torch.int32).reshape(3, 8)
    q_pos = torch.tensor([0, 17, 127, 60], dtype=torch.int32)
    args = (q8, kp, vp, table.to(cuda), q_pos.to(cuda), 128,
            *(torch.tensor(s, device=cuda)
              for s in (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)))
    pk = ops.paged_attention_parts(*args, sm_scale=128 ** -0.5)
    pp = ref.paged_attention_parts(*args, sm_scale=128 ** -0.5)
    for part in ("m", "l", "p8", "out"):
        assert torch.equal(pk[part], pp[part]), part


def _scal(inv, s1, s2, dev):
    return torch.tensor([inv, s1, s2], dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,inv", [("affine", 8, 2.0 ** 9),
                                        ("affine", 16, 2.0 ** 17),
                                        ("flag", 8, 2.0 ** 8)])
def test_cuda_dgrad_wgrad_bitwise(cuda, mode, k, inv):
    g = torch.Generator(device=cuda).manual_seed(3)
    scal = _scal(inv, 2.0 ** -16, 2.0 ** -23, cuda)
    # ragged tiles, an aligned case, and a long contraction that splits
    for m, n, kd in ((100, 96, 72), (256, 512, 128), (64, 8192, 64),
                     (37, 45, 19)):
        e = torch.randn((m, n), generator=g, device=cuda) * 0.01
        b8, a8 = _i8(g, (kd, n), cuda), _i8(g, (m, kd), cuda)
        assert torch.equal(ops.dgrad(e, b8, scal, mode=mode, k=k),
                           ref.dgrad(e, b8, scal, mode=mode, k=k)), (m, n, kd)
        assert torch.equal(ops.wgrad(a8, e, scal, mode=mode, k=k),
                           ref.wgrad(a8, e, scal, mode=mode, k=k)), (m, n, kd)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,inv", [("affine", 8, 2.0 ** 9),
                                        ("affine", 16, 2.0 ** 17),
                                        ("flag", 8, 2.0 ** 8)])
@pytest.mark.parametrize("m,n,kd", [(4100, 1000, 4160), (4096, 1024, 4096),
                                    (4096, 256, 256)])
def test_cuda_dgrad_wgrad_large_ragged_and_split(cuda, mode, k, inv, m, n,
                                                  kd):
    """K3 at M, N and K that are not multiples of the 128-wide tiles
    (the operand pass pads them with zero tiles), at the wk/wv shape of
    the training step (4096 -> 1024), and at a shape whose small output
    splits the contraction across blocks."""
    g = torch.Generator(device=cuda).manual_seed(10)
    scal = _scal(inv, 2.0 ** -16, 2.0 ** -23, cuda)
    e = torch.randn((m, n), generator=g, device=cuda) * 0.01
    b8, a8 = _i8(g, (kd, n), cuda), _i8(g, (m, kd), cuda)
    assert torch.equal(ops.dgrad(e, b8, scal, mode=mode, k=k),
                       ref.dgrad(e, b8, scal, mode=mode, k=k))
    assert torch.equal(ops.wgrad(a8, e, scal, mode=mode, k=k),
                       ref.wgrad(a8, e, scal, mode=mode, k=k))


@pytest.mark.cuda
def test_cuda_dgrad_int16_wraps_like_the_plain_version(cuda):
    n = 20000                   # 20000 * 32767 * 127 > 2^31: the sum wraps
    e = torch.ones((2, n), device=cuda)
    b8 = torch.full((3, n), 127, dtype=torch.int8, device=cuda)
    scal = _scal(2.0 ** 15, 1.0, 0.0, cuda)
    got = ops.dgrad(e, b8, scal, mode="affine", k=16)
    assert torch.equal(got, ref.dgrad(e, b8, scal, mode="affine", k=16))
    wrapped = (n * 32767 * 127 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert float(got[0, 0]) == float(np.float32(wrapped))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,dh,pad", [(True, 128, 0), (False, 64, 40),
                                           (True, 32, 17), (True, 112, 0),
                                           (False, 112, 40)])
def test_cuda_flash_attention_bitwise(cuda, causal, dh, pad):
    g = torch.Generator(device=cuda).manual_seed(4)
    b, s, t, h, kv = 2, 256, 256, 8, 2
    q8, k8, v8 = (_i8(g, (b, s, h, dh), cuda), _i8(g, (b, t, kv, dh), cuda),
                  _i8(g, (b, t, kv, dh), cuda))
    q_pos = torch.arange(s, device=cuda, dtype=torch.int32)
    k_pos = torch.arange(t, device=cuda, dtype=torch.int32)
    k_valid = (k_pos < t - pad).to(torch.int32)
    sc = [torch.tensor(v, device=cuda) for v in (2.0 ** -6, 2.0 ** -7,
                                                 2.0 ** -5)]
    kw = dict(causal=causal, sm_scale=dh ** -0.5, q_chunk=128, kv_chunk=64)
    args = (q8, k8, v8, q_pos, k_pos, k_valid, *sc)
    got = ops.flash_attention(*args, **kw)
    want = ref.flash_attention(*args, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _flash_case(dev, *, s, t, q_pos, k_pos, k_valid, causal, dh=128,
                k_a=8, q_chunk=128, kv_chunk=64, h=8, kv=2, seed=5):
    """K5 against its plain version on the card, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q8, k8, v8 = (_i8(g, (1, s, h, dh), dev), _i8(g, (1, t, kv, dh), dev),
                  _i8(g, (1, t, kv, dh), dev))
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)  # noqa
    sc = [torch.tensor(v, device=dev) for v in (2.0 ** -6, 2.0 ** -7,
                                                2.0 ** -5)]
    kw = dict(causal=causal, sm_scale=dh ** -0.5, q_chunk=q_chunk,
              kv_chunk=kv_chunk, k_a=k_a)
    args = (q8, k8, v8, i32(q_pos), i32(k_pos), i32(k_valid), *sc)
    got = ops.flash_attention(*args, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref.flash_attention(*args, **kw))


@pytest.mark.cuda
def test_cuda_flash_attention_offset_positions(cuda):
    """Queries at the end of a longer key range (q_pos = T - S + i, as a
    chunked prefill continues a context): the tile skip reads positions,
    not indices."""
    s, t = 128, 384
    _flash_case(cuda, s=s, t=t, q_pos=np.arange(s) + t - s,
                k_pos=np.arange(t), k_valid=np.ones(t), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_leading_padding(cuda, causal):
    """k_valid masks the whole first kv chunk: every row's running max is
    NEG_INF there, so the masked keys' p = exp(0) = 1 terms enter l and o
    until a valid key wipes them (alpha = 0)."""
    t = 256
    _flash_case(cuda, s=256, t=t, q_pos=np.arange(256), k_pos=np.arange(t),
                k_valid=np.arange(t) >= 64, causal=causal)


@pytest.mark.cuda
def test_cuda_flash_attention_rows_without_keys(cuda):
    """Causal queries before the first key position see no valid key at
    all: their output is the plain version's average over masked keys."""
    t = 256
    _flash_case(cuda, s=256, t=t, q_pos=np.arange(256),
                k_pos=np.arange(t) + 100, k_valid=np.ones(t), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k_a,dh,causal", [(4, 128, True), (4, 64, False),
                                           (2, 96, True), (8, 64, True),
                                           (4, 112, True), (8, 16, False),
                                           (8, 48, True), (8, 80, False)])
def test_cuda_flash_attention_k_a_and_dh(cuda, k_a, dh, causal):
    """k_a below 8 (the a4 preset's 4, and the smallest, 2) and the head
    widths below 128: every multiple of 16 that is no multiple of 32 runs
    q.k over zero-padded bytes and p.v at the next multiple of 32."""
    _flash_case(cuda, s=256, t=256, q_pos=np.arange(256),
                k_pos=np.arange(256), k_valid=np.arange(256) < 230,
                causal=causal, dh=dh, k_a=k_a, seed=k_a * dh)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["g1_causal", "g1_not_causal",
                                  "g1_ragged_chunk"])
def test_cuda_flash_attention_zamba2_heads(cuda, case):
    """zamba2-7b's shared attention: heads of 112, one query head per KV
    head (G = 1: 64-row blocks of one head), causal and not, and its
    monolithic prefill's one ragged kv chunk (a 100-token prompt)."""
    t = 100 if case == "g1_ragged_chunk" else 256
    _flash_case(cuda, s=t, t=t, q_pos=np.arange(t), k_pos=np.arange(t),
                k_valid=np.arange(t) < t - 9, causal=case != "g1_not_causal",
                dh=112, h=4, kv=4, q_chunk=min(t, 128), kv_chunk=min(t, 64)
                if t % 64 == 0 else t, seed=t)


@pytest.mark.cuda
def test_cuda_flash_attention_ragged_rows_and_skip_count(cuda):
    """Three query heads per KV head: 128-row blocks span q chunks (of 40
    positions) and the last block is partial.  The visited-tile count of a
    causal run is what the skip rule gives from the positions."""
    s, t, g_ = 120, 192, 3
    _flash_case(cuda, s=s, t=t, q_pos=np.arange(s) + 50, k_pos=np.arange(t),
                k_valid=np.ones(t), causal=True, h=6, kv=2, q_chunk=40)
    gen = torch.Generator(device=cuda).manual_seed(11)
    q8 = _i8(gen, (1, s, 6, 64), cuda)
    k8, v8 = _i8(gen, (1, t, 2, 64), cuda), _i8(gen, (1, t, 2, 64), cuda)
    visits = torch.zeros(2, dtype=torch.int64, device=cuda)
    pos = torch.arange(t, device=cuda, dtype=torch.int32)
    ops.flash_attention(q8, k8, v8, pos[:s] + 50, pos, torch.ones_like(pos),
                        1.0, 1.0, 1.0, causal=True, sm_scale=0.125,
                        q_chunk=40, kv_chunk=64, visits=visits)
    # per KV head, blocks of 128 rows = positions 50 + R // 3: the tiles of
    # 64 keys starting past the block's last position are skipped
    want = 0
    for r0 in range(0, s * g_, 128):
        qmax = 50 + (min(r0 + 128, s * g_) - 1) // g_
        want += sum(64 * tt <= qmax for tt in range(t // 64))
    assert visits.tolist() == [2 * want, 2 * want]


@pytest.mark.cuda
def test_cuda_flash_attention_pcode_exhaustive(cuda):
    """K5 takes each probability's code rint(exp(x) * 2^(k_a-1)) from a
    fast exp2 guess corrected by exact thresholds instead of a float64 exp
    per score; over every fp32 x <= 0 and every k_a from 2 to 8 it equals
    the plain version's rint(float(exp(double(x))) * 2^(k_a-1))."""
    assert ops.flash_pcode_mismatches(cuda) == [0] * 7


def _prefill_flash(dev, t, *, q_pos=None, k_pos=None, k_valid=None,
                   causal=True, seed=0):
    """K5 as monolithic prefill calls it for a prompt of t tokens at the
    serving widths (32 query / 8 KV heads of 128): chunks min(1024, t) and
    min(512, t), the operands padded to chunk multiples as _FlashFused pads
    them.  Returns (kernel out, plain out at the same kv_chunk, launches)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qc, kc = min(1024, t), min(512, t)
    sp, tp = -t % qc, -t % kc
    q8 = _i8(g, (1, t + sp, 32, 128), dev)
    k8, v8 = _i8(g, (1, t + tp, 8, 128), dev), _i8(g, (1, t + tp, 8, 128), dev)
    i32 = lambda x, n: torch.cat([torch.as_tensor(  # noqa: E731
        x, dtype=torch.int32, device=dev), torch.zeros(n, dtype=torch.int32,
                                                      device=dev)])
    ar = np.arange(t)
    qp = i32(ar if q_pos is None else q_pos, sp)
    kp = i32(ar if k_pos is None else k_pos, tp)
    kv = i32(np.ones(t) if k_valid is None else k_valid, tp)
    sc = [torch.tensor(v, device=dev) for v in (2.0 ** -6, 2.0 ** -7,
                                                2.0 ** -7)]
    kw = dict(causal=causal, sm_scale=128 ** -0.5, q_chunk=qc, kv_chunk=kc)
    args = (q8, k8, v8, qp, kp, kv, *sc)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(*args, **kw)
    launched = ops.LAUNCHES["flash_attention"] - before
    return got, ref.flash_attention(*args, **kw), launched


@pytest.mark.cuda
@pytest.mark.parametrize("t", [37, 100, 300, 1500])
def test_cuda_flash_attention_prefill_lengths(cuda, t):
    """Monolithic prefill's shapes: a prompt shorter than the kv chunk is
    one ragged chunk (37, 100, 300: no multiple of 64), which the wrapper
    pads with absent keys; 1500 runs 2 q chunks and 3 kv chunks.  The
    kernel launches (no refusal, no plain fallback) and equals the plain
    version at kv_chunk = T bit for bit."""
    got, want, launched = _prefill_flash(cuda, t, seed=t)
    assert launched == 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows_without_keys", "masked_not_causal"])
def test_cuda_flash_attention_ragged_chunk_masks(cuda, case):
    """The absent keys of a ragged chunk add nothing even where a row sees
    no valid key (its p = 1 terms run over the T real keys only, as the
    plain version's do at kv_chunk = T), and beside masked real keys."""
    t = 100
    if case == "rows_without_keys":
        kw = dict(k_pos=np.arange(t) + 30)
    else:
        kw = dict(k_valid=np.arange(t) % 3 != 0, causal=False)
    got, want, launched = _prefill_flash(cuda, t, seed=7, **kw)
    assert launched == 1
    assert torch.equal(got, want)


# ResNet-50's quantized BNs at batch 32 (M = N*H*W, C): every shape of a step
_BN_STEP = [(100352, 64), (100352, 256), (100352, 128), (25088, 128),
            (25088, 512), (25088, 256), (6272, 256), (6272, 1024),
            (6272, 512), (1568, 512), (1568, 2048)]


def _bn_case(dev, m, n, grid, seed=None):
    g = torch.Generator(device=dev).manual_seed(m if seed is None else seed)
    x = torch.randn((m, n), generator=g, device=dev) * 2 + 0.3
    if grid:
        x = torch.round(x * 64) / 64
    gamma = 1.0 + 0.1 * torch.randn(n, generator=g, device=dev)
    beta = 0.1 * torch.randn(n, generator=g, device=dev)
    return x, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,grid", [(100352, 256, False), (1568, 2048, False),
                                      (25088, 512, True), (1000, 96, False),
                                      (257, 33, True)]
                         + [(m, n, grid) for m, n in _BN_STEP
                            for grid in (False, True)
                            if (m, n) not in ((100352, 256), (1568, 2048))]
                         + [(1, 9, False), (1, 64, False), (63, 5, True),
                            (255, 128, False), (30001, 40, True),
                            (30001, 38, False), (1568, 2047, True),
                            (13312, 2048, False), (13313, 2048, False)])
def test_cuda_ubn_batch_bitwise(cuda, m, n, grid):
    """K4 "batch" at every BN shape of a ResNet-50 step at batch 32 (both
    routes: strips over clusters of 1, 2 or 4 blocks at 1568 x 512 and
    2048 and 6272 x 512 and 1024, two passes at the others), ragged M and
    C (C % 4 != 0: scalar columns, on either route), M = 1, M below one
    chunk, the routes' boundary (M 13312 / 13313 at C 2048), N(0, 1) and
    grid-valued inputs as the convolutions give."""
    x, gamma, beta = _bn_case(cuda, m, n, grid)
    before = ops.LAUNCHES["ubn_norm"]
    got = ops.ubn_norm(x, gamma, beta, kind="batch")
    assert ops.LAUNCHES["ubn_norm"] == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref.ubn_norm(x, gamma, beta, kind="batch"))


@pytest.mark.cuda
def test_cuda_ubn_batch_repeats_and_interleaves(cuda):
    """Calls of both routes and of different shapes, interleaved on one
    stream and repeated, each equal their plain version and each other:
    the two-pass route's arrival counters are left at 0 by every call."""
    cases = [_bn_case(cuda, m, n, False, seed=i) for i, (m, n) in enumerate(
        [(100352, 64), (1568, 512), (30001, 40), (100352, 256), (257, 33)])]
    want = [ref.ubn_norm(*c, kind="batch") for c in cases]
    for _ in range(3):
        for c, w in zip(cases + cases[::-1], want + want[::-1]):
            assert torch.equal(ops.ubn_norm(*c, kind="batch"), w)
    counts = [c for d, c in ops._UBN_COUNTS.items() if d.type == "cuda"]
    assert counts and all(int(c.abs().sum()) == 0 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(100352, 64), (1568, 512), (1000, 96)])
def test_cuda_ubn_batch_unaligned_view(cuda, m, n):
    """x a contiguous view that starts 4 bytes into its storage (scalar
    loads on either route)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(m * n + 1, generator=g, device=cuda) * 2)[1:].view(m, n)
    assert x.data_ptr() % 16
    gamma = 1.0 + 0.1 * torch.randn(n, generator=g, device=cuda)
    beta = 0.1 * torch.randn(n, generator=g, device=cuda)
    assert torch.equal(ops.ubn_norm(x, gamma, beta, kind="batch"),
                       ref.ubn_norm(x, gamma, beta, kind="batch"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4608, 512), (37, 70), (1, 9)])
def test_cuda_cq_stochastic_bitwise(cuda, shape):
    """K8 on a ResNet-50 weight leaf's shape (3x3x512 -> 512) and ragged
    ones, from the int32 pattern of uint32 bits."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(shape, generator=g, device=cuda) * 0.02
    bits = torch.randint(-2 ** 31, 2 ** 31, shape, generator=g, device=cuda,
                         dtype=torch.int32)
    inv = torch.tensor(2.0 ** 12, device=cuda)
    for dr in (128.0, 64.0):
        got = ops.cq_stochastic(x, bits, inv, dr)
        assert torch.equal(got, ref.cq_stochastic(x, bits, inv, dr))


@pytest.mark.cuda
def test_cuda_qconv_refuses_tf32(cuda):
    """The convolution of grid values runs in full fp32 or not at all."""
    from repro_torch.core import preset, qconv
    x = torch.zeros((1, 8, 8, 4), device=cuda)
    w = torch.zeros((3, 3, 4, 4), device=cuda)
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            qconv(preset("full8"), x, w, 1)
        torch.backends.cudnn.allow_tf32 = False
        assert qconv(preset("full8"), x, w, 2).shape == (1, 4, 4, 4)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_cuda_sim_and_fp32_products_refuse_tf32(cuda):
    """sim and fp32 qeinsum products run in full fp32 or not at all."""
    from repro_torch.core import preset
    from repro_torch.core.qdense import qeinsum
    a = torch.ones((4, 8), device=cuda)
    b = torch.ones((8, 2), device=cuda)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for mode in ("sim", "fp32"):
            cfg = preset("full8", mode)
            torch.backends.cuda.matmul.allow_tf32 = True
            with pytest.raises(RuntimeError, match="allow_tf32"):
                qeinsum(cfg, "mk,kn->mn", "default", True, a, b)
            torch.backends.cuda.matmul.allow_tf32 = False
            assert torch.equal(qeinsum(cfg, "mk,kn->mn", "default", True,
                                       a, b), torch.full((4, 2), 8.0,
                                                         device=cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 16])
def test_cuda_qmatmul_ssm_shapes(cuda, m):
    """K1 at falcon-mamba-7b's projections: in_proj (4096 -> 16384),
    x_proj (8192 -> 288, ragged against the 64-wide tile), dt_proj
    (256 -> 8192) and out_proj (8192 -> 4096), plain and requantized."""
    g = torch.Generator(device=cuda).manual_seed(7)
    inv = torch.tensor(2.0 ** -14, device=cuda)
    for k, n in ((4096, 16384), (8192, 288), (256, 8192), (8192, 4096)):
        a, b = _i8(g, (m, k), cuda), _i8(g, (k, n), cuda)
        assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b)), (m, k, n)
        assert torch.equal(ops.qmatmul(a, b, inv), ref.qmatmul(a, b, inv)), \
            (m, k, n)


def _scan_inputs(g, shape, dev):
    """The model's scan inputs: a = exp(dt A), dt log-uniform in
    [1e-3, 1e-1], A = -(1..N); b ~ 0.1 N(0, 1); c, h0 ~ N(0, 1)."""
    b, s, d, n = shape
    dt = torch.empty((b, s, d), device=dev).uniform_(
        np.log(1e-3), np.log(1e-1), generator=g).exp()
    a = torch.exp(dt[..., None] * -torch.arange(1, n + 1, device=dev,
                                                 dtype=torch.float32))
    bb = torch.randn(shape, generator=g, device=dev) * 0.1
    c = torch.randn((b, s, n), generator=g, device=dev)
    h0 = torch.randn((b, d, n), generator=g, device=dev)
    return a, bb, c, h0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_h0", [
    ((1, 16, 8192, 16), True),      # a prefill page of falcon-mamba-7b
    ((4, 1, 8192, 16), True),       # a decode step of 4 lanes
    ((1, 4096, 8192, 16), False),   # train_4k from zero: the TPU kernel's
    ((2, 37, 1000, 4), True),       # ragged S and D, the reduced N
    ((2, 37, 1000, 4), False),
    ((3, 5, 65, 16), True),
    ((1, 17, 8192, 16), True),      # across the staged tiles' boundaries
    ((2, 33, 300, 4), True),
    ((2, 33, 300, 16), False),
    ((1, 4097, 512, 16), True),
    ((1, 4097, 1000, 4), False),
    ((1, 1, 8192, 16), True),       # a prompt-tail token (direct route)
    ((5, 1, 100, 4), False),
    ((64, 3, 2048, 16), True)])     # more blocks than stay resident
def test_cuda_selective_scan_bitwise(cuda, shape, with_h0):
    """K9 equals its plain version bit for bit: h with two roundings per
    step, y the n-ordered float64 sum rounded once, on both sides."""
    g = torch.Generator(device=cuda).manual_seed(8)
    a, b, c, h0 = _scan_inputs(g, shape, cuda)
    h0 = h0 if with_h0 else None
    y, h = ops.selective_scan(a, b, c, h0)
    yp, hp = ref.selective_scan(a, b, c, h0)
    assert torch.isfinite(y).all()
    assert torch.equal(y, yp) and torch.equal(h, hp)


@pytest.mark.cuda
def test_cuda_selective_scan_continues_and_checks(cuda):
    """A scan continued from its h_last equals one scan on the card; an
    unaligned view runs; an N the kernel is not built for raises."""
    g = torch.Generator(device=cuda).manual_seed(9)
    a, b, c, h0 = _scan_inputs(g, (2, 40, 300, 16), cuda)
    y, h = ops.selective_scan(a, b, c, h0)
    y1, h1 = ops.selective_scan(a[:, :13], b[:, :13], c[:, :13], h0)
    y2, h2 = ops.selective_scan(a[:, 13:], b[:, 13:], c[:, 13:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    cv = torch.randn(2 * 40 * 16 + 1, generator=g, device=cuda)[1:].reshape(
        2, 40, 16)                                  # starts 4 bytes in
    assert torch.equal(ops.selective_scan(a, b, cv, h0)[0],
                       ref.selective_scan(a, b, cv, h0)[0])
    a8, b8, c8, h8 = _scan_inputs(g, (1, 4, 32, 8), cuda)
    with pytest.raises(ValueError, match="N = 8"):
        ops.selective_scan(a8, b8, c8, h8)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 16, 17, 33])
@pytest.mark.parametrize("n", [4, 16])
def test_cuda_selective_scan_views_and_repeats(cuda, s, n):
    """A non-contiguous c and a (B, S, D, N) a sliced along D (both
    copied by the wrapper), an S of 0, and repeated calls: equal to the
    plain version, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(10 + s + n)
    a, b, c, h0 = _scan_inputs(g, (2, s, 96, n), cuda)
    ct = torch.randn((2, s, 2 * n), generator=g, device=cuda)[..., ::2]
    assert not ct.is_contiguous()
    want = ref.selective_scan(a, b, ct, h0)
    for _ in range(2):
        before = ops.LAUNCHES["selective_scan"]
        y, h = ops.selective_scan(a, b, ct, h0)
        assert ops.LAUNCHES["selective_scan"] == before + 1
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    a2, b2 = a[:, :, 8:72], b[:, :, 8:72]
    y, h = ops.selective_scan(a2, b2, c, h0[:, 8:72])
    yp, hp = ref.selective_scan(a2, b2, c, h0[:, 8:72])
    assert torch.equal(y, yp) and torch.equal(h, hp)
    y, h = ops.selective_scan(a[:, :0], b[:, :0], c[:, :0], h0)
    assert y.shape == (2, 0, 96) and torch.equal(h, h0)


def _bwd_inputs(g, shape, dev):
    a, b, c, h0 = _scan_inputs(g, shape, dev)
    dy = torch.randn(shape[:3], generator=g, device=dev)
    dh = torch.randn(shape[:1] + shape[2:], generator=g, device=dev)
    return a, b, c, h0, dy, dh


def _bwd_equal(got, want) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_h0,with_dh", [
    ((1, 4096, 8192, 16), False, False),  # train_4k: the ssm_train step's
    ((1, 16, 8192, 16), True, True),      # a prefill page
    ((4, 1, 8192, 16), True, True),       # B > 1, one step
    ((2, 37, 1000, 4), True, False),      # ragged S (chunks of 8), D, N 4
    ((2, 37, 1000, 4), False, True),
    ((3, 9, 65, 16), True, True),         # one step past a chunk, D 65
    ((1, 17, 300, 16), False, True),
    ((2, 33, 128, 4), False, False),      # the reduced SSM's width
    ((1, 4097, 512, 16), True, True),
    ((64, 3, 2048, 16), True, False)])    # more blocks than stay resident
def test_cuda_selective_scan_bwd_bitwise(cuda, shape, with_h0, with_dh):
    """K9b equals its plain version bit for bit: h recomputed with the
    forward's roundings, the carry and products rounded once, dc's float64
    sum in the stated order (per-block partials, then the blocks in
    order), with and without h0 and dh_last."""
    g = torch.Generator(device=cuda).manual_seed(11 + shape[1])
    a, b, c, h0, dy, dh = _bwd_inputs(g, shape, cuda)
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    got = ops.selective_scan_bwd(a, b, c, dy, h0, dh)
    want = ref.selective_scan_bwd(a, b, c, dy, h0, dh)
    assert (got[3] is None) == (h0 is None)
    assert all(torch.isfinite(x).all() for x in got if x is not None)
    assert _bwd_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16])
def test_cuda_selective_scan_bwd_repeats_and_checks(cuda, n):
    """Repeated calls give the same bits and count one launch each;
    autograd through ops.selective_scan runs K9b (and the forward's K9
    once); views are copied; S = 0 passes dh_last through; an N the
    kernel lacks raises."""
    g = torch.Generator(device=cuda).manual_seed(20 + n)
    a, b, c, h0, dy, dh = _bwd_inputs(g, (2, 45, 200, n), cuda)
    first = ops.selective_scan_bwd(a, b, c, dy, h0, dh)
    for _ in range(3):
        before = ops.LAUNCHES["selective_scan_bwd"]
        again = ops.selective_scan_bwd(a, b, c, dy, h0, dh)
        assert ops.LAUNCHES["selective_scan_bwd"] == before + 1
        assert _bwd_equal(again, first)
    ar, br, cr, hr = (t.clone().requires_grad_() for t in (a, b, c, h0))
    before = dict(ops.LAUNCHES)
    y, h = ops.selective_scan(ar, br, cr, hr)
    torch.autograd.backward((y, h), (dy, dh))
    assert ops.LAUNCHES["selective_scan"] == before["selective_scan"] + 1
    assert ops.LAUNCHES["selective_scan_bwd"] == \
        before["selective_scan_bwd"] + 1
    assert _bwd_equal((ar.grad, br.grad, cr.grad, hr.grad), first)
    dyt = torch.randn((2, 200, 45), generator=g, device=cuda).transpose(1, 2)
    assert _bwd_equal(ops.selective_scan_bwd(a, b, c, dyt, h0, dh),
                      ref.selective_scan_bwd(a, b, c, dyt, h0, dh))
    z = ops.selective_scan_bwd(a[:, :0], b[:, :0], c[:, :0], dy[:, :0], h0,
                               dh)
    assert z[0].shape == (2, 0, 200, n) and torch.equal(z[3], dh)
    a8, b8, c8, h8 = _scan_inputs(g, (1, 4, 32, 8), cuda)
    with pytest.raises(ValueError, match="N = 8"):
        ops.selective_scan_bwd(a8, b8, c8, torch.zeros(1, 4, 32,
                                                       device=cuda), h8)


BF = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_h0", [
    ((1, 16, 8192, 16), True),      # a prefill page, bf16 carriers
    ((1, 4096, 8192, 16), False),   # train_4k: ssm_train's bf16 step
    ((4, 1, 8192, 16), True),       # one step (direct route)
    ((1, 17, 8192, 16), True),      # across the staged tiles' boundaries
    ((2, 33, 300, 16), False),
    ((3, 5, 65, 16), True),
    ((1, 4097, 512, 16), True),
    ((2, 37, 1000, 4), True),       # N 4: the direct route at every S
    ((2, 33, 128, 4), False),
    ((64, 3, 2048, 16), True)])
def test_cuda_selective_scan_bf16_bitwise(cuda, shape, with_h0):
    """K9 on bf16 carriers equals its plain version bit for bit: the fp32
    route on the exact fp32 values, y and h_last rounded once to bf16."""
    g = torch.Generator(device=cuda).manual_seed(30 + shape[1])
    a, b, c, h0 = (t.to(BF) for t in _scan_inputs(g, shape, cuda))
    h0 = h0 if with_h0 else None
    y, h = ops.selective_scan(a, b, c, h0)
    yp, hp = ref.selective_scan(a, b, c, h0)
    assert y.dtype == h.dtype == BF and torch.isfinite(y.float()).all()
    assert torch.equal(y, yp) and torch.equal(h, hp)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_h0,with_dh", [
    ((1, 4096, 8192, 16), False, False),  # train_4k: ssm_train's bf16 step
    ((1, 16, 8192, 16), True, True),
    ((2, 37, 1000, 4), True, False),      # ragged S (chunks of 8), D, N 4
    ((3, 9, 65, 16), True, True),
    ((1, 17, 300, 16), False, True),
    ((1, 4097, 512, 16), True, True),
    ((64, 3, 2048, 16), True, False)])
def test_cuda_selective_scan_bwd_bf16_bitwise(cuda, shape, with_h0,
                                              with_dh):
    """K9b on bf16 carriers equals its plain version bit for bit: the
    checkpoints in their own fp32 buffer, every output rounded once to
    bf16 (dc from its float64 sum through fp32)."""
    g = torch.Generator(device=cuda).manual_seed(40 + shape[1])
    a, b, c, h0, dy, dh = (t.to(BF) for t in _bwd_inputs(g, shape, cuda))
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    got = ops.selective_scan_bwd(a, b, c, dy, h0, dh)
    want = ref.selective_scan_bwd(a, b, c, dy, h0, dh)
    assert all(x.dtype == BF for x in got if x is not None)
    assert _bwd_equal(got, want)


@pytest.mark.cuda
def test_cuda_selective_scan_bf16_checks_and_autograd(cuda):
    """Mixed f32 and bf16 operands raise ValueError (nothing upcasts);
    autograd through ops.selective_scan on bf16 runs K9 and K9b once each
    and gives bf16 gradients equal to the plain backward's."""
    g = torch.Generator(device=cuda).manual_seed(50)
    a, b, c, h0, dy, dh = _bwd_inputs(g, (2, 45, 200, 16), cuda)
    ab, bb, cb, hb, dyb, dhb = (t.to(BF) for t in (a, b, c, h0, dy, dh))
    for args in ((ab, bb, c, hb), (ab, bb, cb, h0), (a, bb, cb, hb)):
        with pytest.raises(ValueError, match="bf16|dtype|float"):
            ops.selective_scan(*args)
    with pytest.raises(ValueError):
        ops.selective_scan_bwd(ab, bb, cb, dy, hb, dhb)
    with pytest.raises(ValueError):
        ops.selective_scan(a.to(torch.float16), b.to(torch.float16),
                           c.to(torch.float16))
    leaves = [t.clone().requires_grad_() for t in (ab, bb, cb, hb)]
    before = dict(ops.LAUNCHES)
    y, h = ops.selective_scan(*leaves)
    torch.autograd.backward((y, h), (dyb, dhb))
    assert ops.LAUNCHES["selective_scan"] == before["selective_scan"] + 1
    assert ops.LAUNCHES["selective_scan_bwd"] == \
        before["selective_scan_bwd"] + 1
    want = ref.selective_scan_bwd(ab, bb, cb, dyb, hb, dhb)
    assert _bwd_equal([t.grad for t in leaves], want)
    assert all(t.grad.dtype == BF for t in leaves)


@pytest.mark.cuda
def test_cuda_ssm_bf16_prefill_then_decode(cuda):
    """falcon-mamba-7b.reduced() with scan_dtype "bf16" on the kernels: a
    monolithic prefill (K9 on bf16 carriers; its state h is bf16, as the
    reference's) then 3 decode steps (fp32, the state widened), logits
    equal to the plain versions' run bit for bit."""
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.models import build_model
    model = build_model(get("falcon-mamba-7b").reduced(),
                        preset("full8").replace(scan_dtype="bf16"),
                        device="cuda").init(0)
    g = torch.Generator(device=cuda).manual_seed(60)
    toks = torch.randint(0, 128, (2, 21), generator=g, device=cuda)
    nxt = torch.randint(0, 128, (3, 2), generator=g, device=cuda)

    def run():
        st, lg = model.prefill(toks)
        assert st["h"].dtype == BF
        out = [lg]
        for t in nxt:
            st, lg = model.serve_step(st, t)
            out.append(lg)
        assert st["h"].dtype == torch.float32
        return out

    before = ops.LAUNCHES["selective_scan"]
    got = run()
    assert ops.LAUNCHES["selective_scan"] > before
    with ops.plain_reference():
        want = run()
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# reduced configs the kernels take: K5 wants heads of 32 or more and
# chunks of 64 (one kv chunk at 64 tokens)
REMAT_CASES = {
    "granite-3-8b": ("granite-3-8b", dict(head_dim=32, q_chunk=64,
                                          kv_chunk=64)),
    "zamba2-7b": ("zamba2-7b", dict(n_layers=3, attn_every=2, head_dim=112,
                                    q_chunk=64, kv_chunk=64,
                                    scan_chunk=16)),
    "falcon-mamba-7b": ("falcon-mamba-7b", {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", REMAT_CASES)
def test_cuda_remat_full_equals_none(cuda, case):
    """Per-layer remat on the card, at reduced configs (the hybrid nested,
    with a tail layer): the loss, every gradient and one full8 step's
    weights and accumulator with remat "full" equal those with "none" bit
    for bit (deterministic algorithms on, as in chip_smoke.py), and the
    recompute launches the forward's kernels again."""
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.data import TokenTask
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import flatten, init_momentum
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {}
        name, over = REMAT_CASES[case]
        for remat in ("full", "none"):
            acfg = get(name).reduced().replace(remat=remat, **over)
            model = build_model(acfg, preset("full8"), device="cuda").init(0)
            batch = TokenTask(acfg.vocab, 64, 2).batch(0)
            ops.reset_launches()
            loss, _ = model.loss(batch)
            loss.backward()
            launches = dict(ops.LAUNCHES)
            grads = [p.grad.clone() for p in flatten(model.params())]
            opt = init_momentum(model.params())
            make_train_step(model, model.q, lr=0.05)(opt, batch, 0)
            out[remat] = (loss.detach(), grads, launches,
                          [p.detach().clone() for p in
                           flatten(model.params())],
                          [t.clone() for t in flatten(opt.acc)])
        (lf, gf, nf, pf, af), (ln, gn, nn, pn, an) = out["full"], out["none"]
        assert torch.equal(lf, ln)
        assert all(torch.equal(x, y) for x, y in zip(gf, gn))
        assert all(torch.equal(x, y) for x, y in zip(pf, pn))
        assert all(torch.equal(x, y) for x, y in zip(af, an))
        assert nf["qmatmul"] > nn["qmatmul"] > 0
        assert nf["dgrad"] == nn["dgrad"] > 0
    finally:
        torch.use_deterministic_algorithms(was)


# --------------------------------------------------------------------------
# K1's two routes (M <= 16 narrow, M > 16 wide) and K7's pools and layouts
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 16, 17, 63, 64, 4096])
def test_cuda_qmatmul_routes_bitwise(cuda, m):
    """K1 on each side of the route boundary (M = 16 narrow, 17 wide) and
    at the wide route's small and full tiles, plain and requantized."""
    g = torch.Generator(device=cuda).manual_seed(11)
    inv = torch.tensor(2.0 ** -13, device=cuda)
    for k, n in ((4096, 1024), (384, 200)):
        a, b = _i8(g, (m, k), cuda), _i8(g, (k, n), cuda)
        assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b)), (m, k, n)
        assert torch.equal(ops.qmatmul(a, b, inv), ref.qmatmul(a, b, inv)), \
            (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 16, 96])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("ta,tb", [(True, False), (False, True),
                                   (True, True)])
def test_cuda_qmatmul_transposed_operands(cuda, m, batch, ta, tb):
    """A given as (K, M) and B as (N, K), transposed views read as they
    lie, 2-D and batched, on both routes."""
    g = torch.Generator(device=cuda).manual_seed(12)
    k, n = 320, 272
    lead = () if batch is None else (batch,)
    a = _i8(g, lead + (k, m), cuda).transpose(-1, -2) if ta \
        else _i8(g, lead + (m, k), cuda)
    b = _i8(g, lead + (n, k), cuda).transpose(-1, -2) if tb \
        else _i8(g, lead + (k, n), cuda)
    assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))
    inv = torch.tensor(2.0 ** -12, device=cuda)
    assert torch.equal(ops.qmatmul(a, b, inv), ref.qmatmul(a, b, inv))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 40])
def test_cuda_qmatmul_unaligned_operands(cuda, m):
    """Operands the 16-byte loads cannot take (a row pitch of 100 bytes, a
    start one byte in) go through the byte-wise loaders of both routes,
    row-major and transposed."""
    g = torch.Generator(device=cuda).manual_seed(17)
    k, n = 100, 90
    a = _i8(g, (m * k + 1,), cuda)[1:].reshape(m, k)        # starts 1 byte in
    b = _i8(g, (k, n), cuda)
    at = _i8(g, (k, m), cuda).t()
    bt = _i8(g, (n * k + 1,), cuda)[1:].reshape(n, k).t()
    for x, y in ((a, b), (at, b), (a, bt), (at, bt)):
        assert torch.equal(ops.qmatmul(x, y), ref.qmatmul(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 128, 512), (4096, 512, 128),
                                   (512, 4096, 128), (128, 4096, 512)])
def test_cuda_qmatmul_attention_chunk_shapes(cuda, m, k, n):
    """K1 at the training step's attention-chunk contractions, batch 8
    (B KV) contiguous."""
    g = torch.Generator(device=cuda).manual_seed(13)
    a, b = _i8(g, (8, m, k), cuda), _i8(g, (8, k, n), cuda)
    assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))


@pytest.mark.cuda
def test_cuda_int_contract_attention_views(cuda):
    """The six attention-chunk contractions of the training step and the
    prefill page's two, through _int_contract on permuted views (heads
    joined to the batch, the other operand broadcast over them, the
    grouped depth summed after): equal to the plain versions."""
    from repro_torch.core.qdense import _int_contract
    g = torch.Generator(device=cuda).manual_seed(14)
    for s in (1024, 16):                       # a q chunk, a prefill page
        q, k = _i8(g, (1, s, 8, 4, 128), cuda), _i8(g, (1, 512, 8, 128), cuda)
        sc = _i8(g, (1, s, 8, 4, 512), cuda)
        kh = _i8(g, (1, 8, 512, 128), cuda).permute(0, 2, 1, 3)  # head-major
        specs = [("bskgd,btkd->bskgt", q, k), ("bskgt,btkd->bskgd", sc, k),
                 ("bskgd,btkd->bskgt", q, kh), ("bskgt,btkd->bskgd", sc, kh)]
        if s == 1024:
            specs += [("bskgd,bskgt->btkd", q, sc),
                      ("bskgt,bskgd->btkd", sc, q)]
        for spec, x, y in specs:
            got = _int_contract(spec, x, y)
            with ops.plain_reference():
                want = _int_contract(spec, x, y)
            assert torch.equal(got, want), (s, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 4096, 256), (16, 8192, 288),
                                   (64, 8192, 96), (4, 100, 288),
                                   (40, 100, 288), (3, 7, 5)])
def test_cuda_qmatmul_split_requant_and_ragged(cuda, m, k, n):
    """A long contraction over few output columns splits across blocks,
    the requantize epilogue following the exact combine; ragged N (x_proj's
    288) and K not a multiple of 64 or 16."""
    g = torch.Generator(device=cuda).manual_seed(15)
    a, b = _i8(g, (m, k), cuda), _i8(g, (k, n), cuda)
    splits, _ = ops._qmm_splits(1, m, n, k, ops._sm_count(cuda))
    if k >= 4096:
        assert splits > 1, "the shape meant to split did not"
    assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))
    for inv in (2.0 ** -14, 2.0 ** -6):        # rounds, and saturates
        t = torch.tensor(inv, device=cuda)
        assert torch.equal(ops.qmatmul(a, b, t), ref.qmatmul(a, b, t))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_cuda_qmatmul_int32_worst_case(cuda, m):
    """Every product at its largest, -128 x -128, over K = 12800: the
    int32 sum 209715200 on both routes, whole and split."""
    a = torch.full((m, 12800), -128, dtype=torch.int8, device=cuda)
    b = torch.full((12800, 256), -128, dtype=torch.int8, device=cuda)
    got = ops.qmatmul(a, b)
    assert torch.equal(got, ref.qmatmul(a, b))
    assert int(got[0, 0]) == 128 * 128 * 12800


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("head_major", [False, True])
def test_cuda_page_gather_pools_and_layouts(cuda, two, head_major):
    """K7 with one and two pools through one table, in the default and the
    head-major layout, with ids past both ends clamped; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(16)
    kp, vp = _i8(g, (40, 16, 8, 128), cuda), _i8(g, (40, 16, 8, 128), cuda)
    table = torch.randint(-3, 45, (3, 32), generator=g, device=cuda,
                          dtype=torch.int32)
    before = ops.LAUNCHES["page_gather"]
    got = ops.page_gather(kp, table, pages2=vp if two else None,
                          head_major=head_major)
    assert ops.LAUNCHES["page_gather"] == before + 1
    with ops.plain_reference():
        want = ops.page_gather(kp, table, pages2=vp if two else None,
                               head_major=head_major)
    got, want = (got, want) if two else ((got,), (want,))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if head_major:
        assert got[0].shape == (3, 8, 32 * 16, 128)
    odd = _i8(g, (9, 5, 3, 7), cuda)          # rows of 7 bytes: byte copies
    t2 = torch.tensor([[4, 0, 11]], device=cuda, dtype=torch.int32)
    assert torch.equal(ops.page_gather(odd, t2, head_major=head_major),
                       ops.page_gather(odd.cpu(), t2.cpu(),
                                       head_major=head_major).to(cuda))


# K6 at the edges of its sweep: each case is (lanes, KV heads, query heads
# per KV head, dh, pages a lane, q_pos, t_valid, k_a); "dead0" puts lane 0
# on the trash page 0
_PA_CASES = {
    "lanes_apart_dead0": (4, 8, 4, 128, 32, [0, 52, 271, 79], None, 8),
    "mid_page_and_edges": (4, 8, 4, 128, 32, [7, 15, 16, 511], None, 8),
    "t_valid_below": (4, 8, 4, 128, 32, [300, 52, 271, 79], 100, 8),
    "all_masked": (4, 8, 4, 128, 8, [-1, 5, -9, 60], 128, 8),
    "t_valid_0": (3, 8, 4, 128, 8, [5, 60, 100], 0, 8),
    "g1": (4, 8, 1, 128, 8, [10, 100, 127, 3], None, 8),
    "g4_dh64": (4, 8, 4, 64, 8, [10, 100, 127, 3], None, 8),
    "g8": (4, 4, 8, 128, 8, [10, 100, 127, 3], None, 8),
    "g48": (2, 1, 48, 128, 8, [100, 31], None, 8),
    "k_a4": (4, 8, 4, 128, 8, [10, 100, 127, 3], None, 4),
    "g1_dh112": (2, 32, 1, 112, 8, [100, 31], None, 8),     # zamba2's heads
    "long_context": (16, 8, 4, 128, 128, "long", None, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_PA_CASES))
def test_cuda_paged_attention_sweep_edges(cuda, case):
    """K6 sweeps each lane to min(q_pos + 1, t_valid, T) only (all T where
    that is empty): m, l, p8 and the output equal the plain version's bit
    for bit; a call is at most three launches on the card."""
    b, kv, gq, dh, nb, qp, tv, k_a = _PA_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(19)
    p = b * nb + 1
    kp, vp = _i8(g, (p, 16, kv, dh), cuda), _i8(g, (p, 16, kv, dh), cuda)
    q8 = _i8(g, (b, kv * gq, dh), cuda)
    table = torch.arange(1, p, device=cuda, dtype=torch.int32).reshape(b, nb)
    if case.endswith("dead0"):
        table[0] = 0
    q_pos = (torch.randint(1024, 2048, (b,), generator=g, device=cuda,
                           dtype=torch.int32) if qp == "long"
             else torch.tensor(qp, device=cuda, dtype=torch.int32))
    t_valid = q_pos.max() + 1 if tv is None else tv
    args = (q8, kp, vp, table, q_pos, t_valid,
            *(torch.tensor(s, device=cuda)
              for s in (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)))
    kw = dict(sm_scale=dh ** -0.5, k_a=k_a)
    pk = ops.paged_attention_parts(*args, **kw)
    pp = ref.paged_attention_parts(*args, **kw)
    for part in ("m", "l", "p8", "out"):
        assert torch.equal(pk[part], pp[part]), part
    assert torch.equal(ops.paged_attention(*args, **kw), pp["out"])
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.paged_attention(*args, **kw)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(on_card) <= 3 * 5


@pytest.mark.cuda
def test_cuda_paged_attention_sweeps_all_past_the_score_bound(cuda):
    """With q_scale * k_scale so large that a score could reach the mask
    value, every lane sweeps all T positions, as the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(20)
    kp, vp = _i8(g, (17, 16, 8, 128), cuda), _i8(g, (17, 16, 8, 128), cuda)
    q8 = _i8(g, (2, 32, 128), cuda)
    table = torch.arange(1, 17, device=cuda, dtype=torch.int32).reshape(2, 8)
    q_pos = torch.tensor([10, 60], device=cuda, dtype=torch.int32)
    for s in (2.0 ** 8, 2.0 ** 12):
        args = (q8, kp, vp, table, q_pos, 128,
                *(torch.tensor(x, device=cuda) for x in (s, s, 1.0)))
        pk = ops.paged_attention_parts(*args, sm_scale=128 ** -0.5)
        pp = ref.paged_attention_parts(*args, sm_scale=128 ** -0.5)
        for part in ("m", "l", "p8", "out"):
            assert torch.equal(pk[part], pp[part]), (s, part)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("m", [1, 4, 16, 512, 4096])
@pytest.mark.parametrize("n", [4096, 8192, 4097])
def test_cuda_ubn_rows_routes_bitwise(cuda, kind, m, n):
    """K4's rows on both routes (a row over a cluster of ops.ubn_cluster(M)
    blocks below the SM count, a block a row above), N of the path, twice
    it and ragged (scalar groups), N(0, 1) and k_BN-grid values."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, n), generator=g, device=cuda) * 2 + 0.3
    gamma = 1.0 + 0.1 * torch.randn(n, generator=g, device=cuda)
    beta = 0.1 * torch.randn(n, generator=g, device=cuda)
    for xx in (x, torch.round(x * 2.0 ** 15) / 2.0 ** 15):
        before = ops.LAUNCHES["ubn_norm"]
        got = ops.ubn_norm(xx, gamma, beta, kind=kind)
        assert ops.LAUNCHES["ubn_norm"] == before + 1
        assert torch.equal(got, ref.ubn_norm(xx, gamma, beta, kind=kind))


@pytest.mark.cuda
def test_cuda_fp32_division_and_sqrt_match_float64(cuda):
    """__fdiv_rn and __fsqrt_rn (K4's rows, K6) equal the float64 division
    and sqrt rounded once that the plain versions take: 2^28 random pairs,
    every pair of the edge values, every fp32 sqrt input."""
    assert ops.fp32_rounding_mismatches(cuda) == [0, 0, 0]


# the MoE's expert contractions (models/moe.py): the gate / up product and
# its two backward specs, the down product and its two, at (experts,
# capacity, d_model, d_ff) of granite-moe-1b-a400m at train_4k (cap =
# ceil(4096 * 8 / 32 * 1.25) = 1280), its 4-lane decode step (dropless:
# cap = 4 * 8 = 32), a 16-token prefill page (cap 5, K1's narrow route) and
# moonshot-v1-16b-a3b at train_4k (cap = ceil(4096 * 6 / 64 * 1.25) = 480)
MOE_SPECS = ("ecd,edf->ecf", "ecf,edf->ecd", "ecd,ecf->edf",
             "ecf,efd->ecd", "ecd,efd->ecf", "ecf,ecd->efd")


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(32, 1280, 1024, 512),
                                     (32, 32, 1024, 512),
                                     (32, 5, 1024, 512),
                                     (64, 480, 2048, 1408)])
@pytest.mark.parametrize("spec", MOE_SPECS)
def test_cuda_qmatmul_moe_expert_shapes(cuda, e, c, d, f, spec):
    """K1 batched over the experts through _int_contract, on the views it
    passes (the backward specs read transposed operands): equal to
    ref.qmatmul."""
    from repro_torch.core.qdense import _int_contract
    g = torch.Generator(device=cuda).manual_seed(17)
    size = {"e": e, "c": c, "d": d, "f": f}
    sa, sb = spec.split("->")[0].split(",")
    x = _i8(g, tuple(size[i] for i in sa), cuda)
    y = _i8(g, tuple(size[i] for i in sb), cuda)
    got = _int_contract(spec, x, y)
    with ops.plain_reference():
        want = _int_contract(spec, x, y)
    assert got.shape == tuple(size[i] for i in spec.split("->")[1])
    assert torch.equal(got, want), (spec, e, c, d, f)


@pytest.mark.cuda
def test_cuda_encdec_reduced_kernels_equal_plain(cuda):
    """The enc-dec (seamless-m4t-large-v2.reduced(), heads widened to 32
    and chunks to 64, which K5 takes) on the kernels against its plain run
    on the card, from one init: one make_train_step's loss, parameters and
    accumulator, and prefill + 4 greedy serve_steps' tokens and logits,
    bit for bit; the kernel run launches K1-K5 (K4 kind "layer", K5 on the
    encoder's, the decoder's causal and the cross shapes), the plain run
    none."""
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import flatten, init_momentum
    acfg = get("seamless-m4t-large-v2").reduced().replace(
        head_dim=32, q_chunk=64, kv_chunk=64)
    g = torch.Generator(device=cuda).manual_seed(0)
    frames = torch.randn((2, 128, 64), generator=g, device=cuda)
    toks = torch.randint(0, 128, (2, 33), generator=g, device=cuda)
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run():
        model = build_model(acfg, preset("full8"), device="cuda").init(0)
        opt = init_momentum(model.params())
        before = dict(ops.LAUNCHES)
        loss = float(make_train_step(model, model.q)(opt, batch, 0)["loss"])
        cache, tok, steps = model.prefill(frames, 32), \
            torch.zeros(2, dtype=torch.int32, device=cuda), []
        for _ in range(4):
            cache, lg = model.serve_step(cache, tok)
            tok = lg[:, :128].argmax(-1).to(torch.int32)
            steps.append((tok.cpu(), lg.cpu()))
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
        state = [t.detach().cpu() for t in flatten((model.params(),
                                                   opt.acc))]
        return loss, state, steps, ran

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, state, steps, ran = run()
        with ops.plain_reference():
            ploss, pstate, psteps, pran = run()
    finally:
        torch.use_deterministic_algorithms(det)
    for k in ("qmatmul", "quantize", "dgrad", "wgrad", "ubn_norm",
              "flash_attention"):
        assert ran[k] > 0, k
    assert not any(pran.values()), pran
    assert loss == ploss and np.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(state, pstate))
    for (t, lg), (pt, plg) in zip(steps, psteps):
        assert torch.equal(t, pt) and torch.equal(lg, plg)


@pytest.mark.cuda
@pytest.mark.parametrize("prefill_mode", ["monolithic", "chunked"])
def test_cuda_hybrid_reduced_kernels_equal_plain(cuda, prefill_mode):
    """The hybrid (zamba2-7b.reduced() with 3 layers, a shared block after
    every 2, heads widened to zamba2's 112 and chunks to 64, which K5
    takes) on the kernels against its plain run on the card, from one
    init: one make_train_step's loss, parameters and accumulator, and the
    engine's greedy tokens over 3 requests on 2 lanes, bit for bit; the
    kernel run launches K1-K6 (K5 in training and monolithic prefill, K6
    in decode), the plain run none."""
    from repro_torch.configs import get
    from repro_torch.core import preset
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import flatten, init_momentum
    from repro_torch.serving import Engine
    acfg = get("zamba2-7b").reduced().replace(
        n_layers=3, attn_every=2, head_dim=112, q_chunk=64, kv_chunk=64,
        scan_chunk=16)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, 128, (2, 65), generator=g, device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    prompts = [np.arange(n, dtype=np.int32) % 97 + 3 for n in (21, 8, 13)]

    def run():
        model = build_model(acfg, preset("full8"), device="cuda").init(0)
        opt = init_momentum(model.params())
        before = dict(ops.LAUNCHES)
        loss = float(make_train_step(model, model.q)(opt, batch, 0)["loss"])
        eng = Engine(model, max_lanes=2, page_size=8, max_ctx=32,
                     prefill_mode=prefill_mode, prefill_chunk=2)
        rids = [eng.submit(p, 5) for p in prompts]
        out = eng.drain()
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
        state = [t.detach().cpu() for t in flatten((model.params(),
                                                   opt.acc))]
        return loss, state, [out[r] for r in rids], ran

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, state, got, ran = run()
        with ops.plain_reference():
            ploss, pstate, pgot, pran = run()
    finally:
        torch.use_deterministic_algorithms(det)
    for k in ("qmatmul", "quantize", "dgrad", "wgrad", "ubn_norm",
              "flash_attention", "paged_attention"):
        assert ran[k] > 0, k
    assert not any(pran.values()), pran
    assert loss == ploss and np.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(state, pstate))
    assert got == pgot
