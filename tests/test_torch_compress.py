"""The port's integer gradient wire (repro_torch.runtime.compress) against
the JAX reference (repro.runtime.compress) and numpy.

  wire_shift / wire_limit / wire_plan / _clip_limit_f32: equal values and
     equal refusals over bits {4, 8, 16, 32} x shift 0-15.
  wire_quantize and wire_presum: bitwise against the reference's on the
     same numpy inputs (the reference's pow2 made exact, ROADMAP F1).
  pack_int8_pairs / unpack_int16_pairs: bitwise against the reference's,
     and every int8 value (-128 included) round-trips.
  The overflow bound of tests/test_qtensor.py's sweep, on the port: no
     payload passes wire_limit and no n-way sum passes the hop width.
  Collectives: one gloo world of 2 and one of 4 ranks (tests/torch_dist.py)
     run every case: ring_allreduce_int (1 and 2 buckets, packed) equals
     numpy's integer sum; wire_sync_tree equals wire_sync_mean leaf by
     leaf, bitwise, and both equal the one-process run over the same
     virtual shards and a numpy model of the algorithm; compressed_psum_int
     and ring_reduce_scatter_int equal numpy's model of them; every hop
     message is the hop width's integer dtype, every gather int32, and the
     only fp32 message is the scale's max.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.runtime import compress as J
from repro_torch.runtime import compress as C

import torch_dist as TD
from torch_parity import exact_pow2  # noqa: F401

BITS = (4, 8, 16, 32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_pow2_ceil(m: np.float32) -> np.float32:
    if m <= 0:
        return np.float32(1.0)
    mant, ex = np.frexp(np.float32(m))
    return np.float32(np.ldexp(np.float32(1.0), ex - 1 if mant == 0.5
                               else ex))


def _np_grid(g: np.ndarray, amax, bits: int, shift: int):
    """numpy model of the wire grid: (fp32 rounded, clipped values, scale)."""
    clip_shift, _ = J.wire_plan(bits, shift)
    lim = J._clip_limit_f32(bits, clip_shift)
    scale = np.float32(_np_pow2_ceil(np.float32(amax))
                       * np.float32(2.0 ** (1 - bits + clip_shift)))
    v = np.clip(np.round(g.astype(np.float32) / scale), -lim, lim)
    return v.astype(np.float32), scale


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("bits", BITS)
def test_wire_plan_limit_and_clip_equal_reference(bits):
    for shift in range(16):
        assert _outcome(C.wire_plan, bits, shift) == \
            _outcome(J.wire_plan, bits, shift)
        assert _outcome(C.wire_limit, bits, shift) == \
            _outcome(J.wire_limit, bits, shift)
        got = _outcome(C._clip_limit_f32, bits, shift)
        want = _outcome(J._clip_limit_f32, bits, shift)
        assert type(got) is type(want) and got == want
        if not isinstance(got, tuple):
            assert float(got) <= C.wire_limit(bits, shift)
    for n in (1, 2, 3, 4, 5, 8, 9, 255, 256, 257, 40000):
        assert C.wire_shift(n) == J.wire_shift(n)


def test_wire_plan_units():
    """tests/test_subbit.py's units, on the port."""
    assert C.wire_plan(16, 4) == (4, 16)
    assert C.wire_plan(8, 6) == (6, 8)
    assert C.wire_plan(32, 10) == (10, 32)
    assert C.wire_plan(4, 2) == (2, 4)
    assert C.wire_plan(4, 3) == (0, 16)
    assert C.wire_plan(4, 12) == (0, 16)
    assert C.wire_plan(8, 7) == (0, 16)
    assert C.wire_plan(4, 13) == (1, 16)
    assert C.wire_plan(4, 14) == (2, 16)
    with pytest.raises(ValueError):
        C.wire_plan(4, 15)
    with pytest.raises(ValueError):
        C.wire_plan(16, 15)
    assert float(C._clip_limit_f32(32, 0)) < 2.0 ** 31 - 1


def _wire_inputs(seed: int):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((4, 3, 37)) * 10.0 ** rng.uniform(-4, 1)
         ).astype(np.float32)
    g[0, 0, :3] = [0.25, -0.5, 2.0 ** -7]       # pow2 values and ties
    return g


@pytest.mark.parametrize("bits", BITS)
def test_wire_quantize_and_presum_bitwise(bits, exact_pow2):
    for seed in range(3):
        g = _wire_inputs(seed)
        for amax in (np.abs(g).max(), np.float32(0.25), np.float32(0.0)):
            for shift in (0, 2, 3, 7):
                try:
                    jq = J.wire_quantize(jnp.asarray(g), jnp.float32(amax),
                                         bits, shift)
                except ValueError:
                    with pytest.raises(ValueError):
                        C.wire_quantize(_t(g), _t(np.float32(amax)), bits,
                                        shift)
                    continue
                tq = C.wire_quantize(_t(g), _t(np.float32(amax)), bits,
                                     shift)
                assert tq.data.dtype == {
                    4: torch.int8, 8: torch.int8, 16: torch.int16,
                    32: torch.int32}[bits] and tq.k == jq.k
                np.testing.assert_array_equal(tq.data.numpy(),
                                              np.asarray(jq.data))
                assert float(tq.scale) == float(jq.scale)
                jps, js = J.wire_presum(jnp.asarray(g), jnp.float32(amax),
                                        bits, shift)
                tps, ts = C.wire_presum(_t(g), _t(np.float32(amax)), bits,
                                        shift)
                assert tps.dtype == torch.int32
                np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
                assert float(ts) == float(js) == float(tq.scale)


def test_staged_wire_exact_sum():
    """bits=4 at an 8-way fan-in (test_subbit.py's case): payloads keep
    full 4-bit resolution (|n| <= 7) in int8 storage, every partial sum
    fits int16, and the pre-sum equals the payload sum."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.normal(size=(8, 33)) * 1e-3).astype(np.float32))
    amax = g.abs().max()
    qt = C.wire_quantize(g, amax, 4, 3)
    data = qt.data.numpy()
    assert data.dtype == np.int8
    assert np.abs(data).max() <= 7
    assert np.abs(data.astype(np.int64).sum(0)).max() < 2 ** 15
    ps, scale = C.wire_presum(g, amax, 4, 3)
    np.testing.assert_array_equal(ps.numpy(), data.astype(np.int64).sum(0))
    assert float(scale) == float(qt.scale)


def test_pack_unpack_every_int8():
    every = np.arange(-128, 128, dtype=np.int8)
    x = np.stack([every, every[::-1], np.roll(every, 77)])     # (3, 256)
    packed = C.pack_int8_pairs(_t(x))
    assert packed.dtype == torch.int16 and packed.shape == (3, 128)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(J.pack_int8_pairs(
                                      jnp.asarray(x))))
    back = C.unpack_int16_pairs(packed)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(J.unpack_int16_pairs(jnp.asarray(
            packed.numpy()))))


def _sweep_arrays():
    """tests/test_qtensor.py's sweep inputs."""
    corners = [np.asarray([0.2500001, -0.125], np.float32),
               np.asarray([1.0, 0.5, 2.0 ** -7], np.float32),
               np.asarray([0.0, 0.0], np.float32),
               np.asarray([2.0000001], np.float32)]
    rng = np.random.default_rng(11)
    rand = [(rng.normal(size=17) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32) for _ in range(12)]
    return corners + rand


@pytest.mark.parametrize("bits", BITS)
def test_wire_overflow_bound_sweep(bits):
    """Any n-way sum of payloads fits the hop width (the property of
    test_qtensor.py::test_wire_overflow_bound_sweep): the payloads stay
    within wire_limit(bits, clip_shift), n * that limit is below the hop's
    2^(hop_bits-1), and the observed sums are; only fan-ins no int16 hop
    can carry (shift > 14) refuse."""
    for n in (1, 2, 3, 8, 17, 64, 256, 40000):
        shift = C.wire_shift(n)
        if shift > bits - 2:
            with pytest.raises(ValueError):
                C.wire_limit(bits, shift)
        try:
            clip_shift, hop_bits = C.wire_plan(bits, shift)
        except ValueError:
            assert shift > 14
            continue
        lim = C.wire_limit(bits, clip_shift)
        assert n * lim < 2.0 ** (hop_bits - 1)
        for x in _sweep_arrays()[:6]:
            xt = torch.from_numpy(x)
            chunks = torch.stack([xt * (i + 1) / n for i in range(n)])
            qt = C.wire_quantize(chunks, chunks.abs().max(), bits, shift)
            data = qt.data.numpy().astype(np.int64)
            assert np.abs(data).max(initial=0) <= lim
            assert np.abs(data.sum(0)).max(initial=0) < 2 ** (hop_bits - 1)


def test_default_wire_codec_by_backend():
    assert C.default_wire_codec("nccl")[0] == "packed"
    codec, why = C.default_wire_codec("gloo")
    assert codec == "leaf" and why.startswith("gloo:")
    assert C.default_wire_codec()[0] == "leaf"     # no group: gloo's


def test_one_process_collectives_are_identities():
    """With no process group the wire is one rank: nothing is sent."""
    C.TRACE = []
    try:
        x = torch.arange(-5, 6, dtype=torch.int32)
        assert torch.equal(C.ring_allreduce_int(x, None, 1, 16), x)
        w = TD.grad_tree(0, 1, 4)["w"]
        got = C.wire_sync_mean(torch.from_numpy(w), n_shards=4, n_dev=1)
        v, scale = _np_grid(w, np.abs(w).max(), 16, 2)
        want = (v.sum(0).astype(np.int32).astype(np.float32) * scale
                / np.float32(4))
        np.testing.assert_array_equal(got.numpy(), want)
        assert C.TRACE == []
    finally:
        C.TRACE = None


# --------------------------------------------------------------------------
# collectives in gloo worlds of 2 and 4 ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    n = request.param
    return n, TD.run_world(n, "torch_dist:compress_cases")


def test_world_ranks(world):
    n, res = world
    assert [(r["rank"], r["size"]) for r in res] == [(i, n) for i in range(n)]


@pytest.mark.parametrize("case", TD.RING_CASES,
                         ids=[f"hop{b}-pack{int(p)}-buckets{k}"
                              for b, p, k in TD.RING_CASES])
def test_ring_allreduce_int_is_the_integer_sum(world, case):
    n, res = world
    bits, pack, buckets = case
    for shape in TD.RING_SHAPES:
        want = sum(TD.ring_input(r, n, bits, shape).astype(np.int64)
                   for r in range(n))
        for r in range(n):
            got, trace = res[r][("ring",) + case + (shape,)]
            assert got.dtype == np.int32 and got.shape == shape
            np.testing.assert_array_equal(got, want)
            hops = [t for t in trace if t[0] == "hop"]
            assert len(hops) == (n - 1) * buckets
            hop_dtype = "torch.int16" if pack else str(C.payload_dtype(bits))
            assert all(d == hop_dtype for _, d, _ in hops), trace
            assert [t for t in trace if t[0] != "hop"] == \
                [("gather", "torch.int32", trace[-1][2])]


def _np_sync(bits: int, vs_total: int, tree_of) -> dict:
    """numpy model of the DP-invariant mean over vs_total virtual shards."""
    shards = tree_of(0, 1, vs_total)
    out = {}
    for k, g in shards.items():
        v, scale = _np_grid(g, np.abs(g).max(), bits,
                            C.wire_shift(vs_total))
        total = v.astype(np.int64).sum(0).astype(np.float32)
        out[k] = total * scale / np.float32(vs_total)
    return out


@pytest.mark.parametrize("bits", TD.SYNC_BITS)
def test_wire_sync_tree_equals_mapped_mean(world, bits):
    n, res = world
    want = _np_sync(bits, TD.SYNC_SHARDS, TD.grad_tree)
    one = C.wire_sync_tree({k: torch.from_numpy(v) for k, v in TD.grad_tree(
        0, 1, TD.SYNC_SHARDS).items()}, n_shards=TD.SYNC_SHARDS, n_dev=1,
        bits=bits)
    for r in range(n):
        packed, leaf, tr_tree, tr_leaf, n_leaves = res[r][("sync", bits)]
        for k in want:
            np.testing.assert_array_equal(packed[k], leaf[k], k)
            np.testing.assert_array_equal(packed[k], one[k].numpy(), k)
            np.testing.assert_array_equal(packed[k], want[k], k)
        # the packed codec's int8 hops ride two-per-int16
        leaf_hop = str(C.payload_dtype(bits))
        for trace, amax_shapes, hop in (
                (tr_tree, [(n_leaves,)], "torch.int16"),
                (tr_leaf, [()] * n_leaves, leaf_hop)):
            assert [s for w, d, s in trace if w == "amax"] == amax_shapes
            for w, d, s in trace:
                assert (w, d) in {("amax", "torch.float32"), ("hop", hop),
                                  ("gather", "torch.int32")}, trace
        # the packed codec sends 2 (n - 1) hop messages, the leaf codec
        # n - 1 per leaf
        assert sum(w == "hop" for w, _, _ in tr_tree) == 2 * (n - 1)
        assert sum(w == "hop" for w, _, _ in tr_leaf) == n_leaves * (n - 1)


@pytest.mark.parametrize("bits", (16, 8))
def test_compressed_psum_and_reduce_scatter_match_numpy(world, bits):
    n, res = world
    xs = [TD.flat_input(r) for r in range(n)]
    shape = xs[0].shape
    pad = -xs[0].size % n
    chunks = [np.pad(x.reshape(-1), (0, pad)).reshape(n, -1) for x in xs]
    amax = max(np.abs(c).max() for c in chunks)
    qs = [_np_grid(c, amax, bits, C.wire_shift(n)) for c in chunks]
    total = sum(q.astype(np.int64) for q, _ in qs).astype(np.float32)
    mean = total * qs[0][1] / np.float32(n)                   # (n, chunk)
    full = mean.reshape(-1)[: xs[0].size].reshape(shape)
    for r in range(n):
        np.testing.assert_array_equal(res[r][("psum", bits)], full)
        np.testing.assert_array_equal(res[r][("rs", bits)], mean[r])
