"""The port's core ops, layers and model steps against the JAX reference.

Same numpy inputs through `repro` (native full8, fused kernels, CPU
oracles) and `repro_torch` (device="cpu", plain versions).  Tolerances:

  qfuncs pow2, qact, qdense, kv_quantize, page writes: bitwise.
  rope: |d| <= 2^-20 * max|x| (exp/cos/sin differ by an ulp between XLA
     and PyTorch on the CPU).
  qrmsnorm: the K4 row bound (torch_parity.ubn_rows_ok).
  paged prefill / decode attention: equal pow2 output scale; at most 2% of
     output payload codes differ, by at most 2 (a probability code flipped
     by an ulp of exp moves the pre-Q_A output by at most one output step).
  model steps: equal argmax and |d logits| <= 2^-8 * max|logits| (an int8
     flip inside the stack moves the fp32 logits a little).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import preset as jpreset
from repro.core import qact as jqact
from repro.core import qdense as jqdense
from repro.core import qfuncs as jqf
from repro.core.qdense import _int_contract as j_int_contract
from repro.core.qtensor import QTensor as JQT
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.configs import get as jget
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.core import preset, qact, qdense, qfuncs, qrmsnorm
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.serving.pool import PagePool

from torch_parity import exact_pow2, ubn_rows_ok  # noqa: F401

JCFG = jpreset("full8", "native")
CFG = preset("full8")


def _t(x):
    return torch.from_numpy(np.array(x))


def _qt_pair(r, shape, scale=2.0 ** -6):
    data = r.integers(-127, 128, shape).astype(np.int8)
    jq = JQT(jnp.asarray(data), jnp.float32(scale), 8).with_carrier()
    return jq, QTensor(_t(data), torch.tensor(scale), 8)


def _attn_ok(got: QTensor, want) -> None:
    assert float(got.scale) == float(want.scale)
    d = np.abs(got.data.numpy().astype(int) - np.asarray(want.data).astype(int))
    assert d.max() <= 2 and np.mean(d > 0) <= 0.02


# --------------------------------------------------------------------------
# qfuncs / quantizers
# --------------------------------------------------------------------------


def test_pow2_exact_where_the_reference_is_not():
    """ROADMAP F1: the port's pow2 is exact for every exponent; the test
    records how many exponents in [-40, 40] the unpatched reference's
    exp2-based pow2_ceil misses on this CPU."""
    ks = np.arange(-40, 41)
    m = np.ldexp(np.float32(1.0), ks).astype(np.float32)
    got = qfuncs.pow2_ceil(_t(m)).numpy()
    np.testing.assert_array_equal(got, m)
    np.testing.assert_array_equal(qfuncs.pow2_round(_t(m)).numpy(), m)
    ref = np.asarray(jqf.pow2_ceil(jnp.asarray(m)))
    print(f"unpatched reference pow2_ceil inexact at "
          f"{int((ref != m).sum())} of {len(ks)} exponents")


def test_pow2_ceil_round_match_patched_reference(exact_pow2):
    r = np.random.default_rng(0)
    m = np.concatenate([np.abs(r.standard_normal(500)) * 10.0 ** r.integers(
        -12, 12, 500), [0.0, 1.0, 0.75, 1.5, 2.0 ** -30]]).astype(np.float32)
    np.testing.assert_array_equal(qfuncs.pow2_ceil(_t(m)).numpy(),
                                  np.asarray(jqf.pow2_ceil(jnp.asarray(m))))
    np.testing.assert_array_equal(qfuncs.pow2_round(_t(m)).numpy(),
                                  np.asarray(jqf.pow2_round(jnp.asarray(m))))


@pytest.mark.parametrize("act", ["none", "silu"])
def test_qact_bitwise(act, exact_pow2):
    x = (np.random.default_rng(1).standard_normal((6, 40)) * 3).astype(
        np.float32)
    want = jqact(JCFG, act, jnp.asarray(x))
    got = qact(CFG, act, _t(x))
    assert float(got.scale) == float(want.scale)
    d = np.abs(got.data.numpy().astype(int) - np.asarray(want.data))
    if act == "none":
        assert d.max() == 0
    else:   # sigmoid differs by an ulp on a few inputs: a rare code flip
        assert d.max() <= 1 and np.mean(d > 0) <= 0.01


def test_qdense_bitwise(exact_pow2):
    r = np.random.default_rng(2)
    x = (r.standard_normal((5, 64)) * 2).astype(np.float32)
    w = np.clip(np.round(r.standard_normal((64, 96)) / 8 * 2 ** 23) / 2 ** 23,
                -1 + 2 ** -23, 1 - 2 ** -23).astype(np.float32)
    want = jqdense(JCFG, jqact(JCFG, "none", jnp.asarray(x)), jnp.asarray(w))
    got = qdense(CFG, qact(CFG, "none", _t(x)), _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # raw fp32 input: decomposed once by the grid quantizer
    want2 = jqdense(JCFG, jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(qdense(CFG, _t(x), _t(w)).numpy(),
                                  np.asarray(want2))


QD = importlib.import_module("repro_torch.core.qdense")

# spec, a's shape, b's shape, b a head-major view (the prefill's gather)
# (b, s, KV, G, dh) = (1, 8, 2, 3, 16), T = 12
_CONTRACTS = {
    "qdense dgrad": ("mn,kn->mk", (24, 40), (20, 40), False),
    "qdense wgrad": ("mk,mn->kn", (24, 20), (24, 40), False),
    "scores": ("bskgd,btkd->bskgt", (1, 8, 2, 3, 16), (1, 12, 2, 16), False),
    "scores dq": ("bskgt,btkd->bskgd", (1, 8, 2, 3, 12), (1, 12, 2, 16),
                  False),
    "scores dk": ("bskgd,bskgt->btkd", (1, 8, 2, 3, 16), (1, 8, 2, 3, 12),
                  False),
    "out": ("bskgt,btkd->bskgd", (1, 8, 2, 3, 12), (1, 12, 2, 16), False),
    "out dp": ("bskgd,btkd->bskgt", (1, 8, 2, 3, 16), (1, 12, 2, 16), False),
    "out dv": ("bskgt,bskgd->btkd", (1, 8, 2, 3, 12), (1, 8, 2, 3, 16),
               False),
    "prefill scores": ("bskgd,btkd->bskgt", (1, 8, 2, 3, 16), (1, 12, 2, 16),
                       True),
    "prefill out": ("bskgt,btkd->bskgd", (1, 8, 2, 3, 12), (1, 12, 2, 16),
                    True),
}


@pytest.mark.parametrize("name", list(_CONTRACTS))
def test_int_contract_passes_views(name, monkeypatch):
    """The integer contractions of the qdense backward (unfused), the six
    of an attention chunk and the prefill page's two reach ops.qmatmul as
    views of the payloads, which it reads as they lie (no copy on either
    side), and equal the reference's int32 einsum."""
    spec, ash, bsh, head_major = _CONTRACTS[name]
    r = np.random.default_rng(len(name))
    a8 = _t(r.integers(-127, 128, ash).astype(np.int8))
    if head_major:            # (b, KV, T, dh) -> the (b, T, KV, dh) view
        b8 = _t(r.integers(-127, 128, (bsh[0], bsh[2], bsh[1], bsh[3]))
                .astype(np.int8)).permute(0, 2, 1, 3)
    else:
        b8 = _t(r.integers(-127, 128, bsh).astype(np.int8))
    seen = []
    real = ops.qmatmul
    monkeypatch.setattr(ops, "qmatmul",
                        lambda x, y, *a, **k: seen.append((x, y))
                        or real(x, y, *a, **k))
    got = QD._int_contract(spec, a8, b8)
    assert len(seen) == 1
    x, y = seen[0]
    for view, src in ((x, a8), (y, b8)):
        assert view.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr()
    kx, ky, _, _ = ops._qmm_operands(x, y)
    assert kx is x and ky is y
    want = j_int_contract(spec, jnp.asarray(a8.numpy()),
                          jnp.asarray(b8.numpy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_prefill_gathers_once_head_major(monkeypatch):
    """One prefill page gathers K and V in one page_gather call, head-major,
    and both contractions read the gathered pages and the payloads as
    views."""
    r = np.random.default_rng(12)
    page, kv, g, dh, p = 8, 2, 2, 16, 7
    _, tq = _qt_pair(r, (1, page, kv * g, dh))
    kp, vp = (_t(r.integers(-127, 128, (p, page, kv, dh)).astype(np.int8))
              for _ in range(2))
    table = torch.tensor([[2, 5, 1, 3]], dtype=torch.int32)
    gathers, mm = [], []
    real_g, real_mm = ops.page_gather, ops.qmatmul

    def spy_gather(*a, **k):
        out = real_g(*a, **k)
        gathers.append((k, out))
        return out

    monkeypatch.setattr(ops, "page_gather", spy_gather)
    monkeypatch.setattr(ops, "qmatmul", lambda x, y, *a, **k: mm.append(
        (x, y)) or real_mm(x, y, *a, **k))
    ts = torch.tensor(2.0 ** -7)
    L.paged_prefill_attention(CFG, tq, kp, vp, table, ts, ts,
                              q_pos=torch.arange(page) + 16)
    assert len(gathers) == 1
    kw, (k8, v8) = gathers[0]
    assert kw["head_major"] and kw["pages2"] is vp
    assert k8.shape == v8.shape == (1, kv, 4 * page, dh)
    assert len(mm) == 2
    ptr = lambda t: t.untyped_storage().data_ptr()  # noqa: E731
    assert ptr(mm[0][0]) == ptr(tq.data) and ptr(mm[0][1]) == ptr(k8)
    assert ptr(mm[1][1]) == ptr(v8)
    for x, y in mm:
        kx, ky, _, _ = ops._qmm_operands(x, y)
        assert kx is x and ky is y


def test_qrmsnorm_row_bound(exact_pow2):
    r = np.random.default_rng(3)
    x = (r.standard_normal((2, 8, 64)) * 0.5).astype(np.float32)
    g = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    from repro.core import qrmsnorm as jq
    want = np.asarray(jq(JCFG, jnp.asarray(x), jnp.asarray(g)))
    got = qrmsnorm(CFG, _t(x), _t(g)).numpy()
    ubn_rows_ok(got.reshape(-1, 64), want.reshape(-1, 64))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rope_within_ulps():
    r = np.random.default_rng(4)
    x = r.standard_normal((1, 8, 4, 16)).astype(np.float32)
    pos = np.arange(40, 48, dtype=np.int32)
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos)))
    got = L.rope(_t(x), _t(pos)).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -20 * np.abs(x).max()
    # decode: one token per lane at its own position
    xb = r.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pb = np.array([5, 0, 300], np.int32)
    from repro.models.transformer import _rope_batched
    want = np.asarray(_rope_batched(jnp.asarray(xb), jnp.asarray(pb), 1e4))
    got = L.rope(_t(xb), _t(pb).reshape(3, 1)).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -20 * np.abs(xb).max()


def test_kv_quantize_and_page_writes_bitwise():
    r = np.random.default_rng(5)
    jq, tq = _qt_pair(r, (3, 2, 16), scale=2.0 ** -5)
    want = np.asarray(JL.kv_quantize(jq, jnp.float32(2.0 ** -7)))
    tok = L.kv_quantize(tq, torch.tensor(2.0 ** -7))
    np.testing.assert_array_equal(tok.numpy(), want)
    pages = r.integers(-127, 128, (6, 4, 2, 16)).astype(np.int8)
    # lanes 0 and 2 are dead (table rows 0): both name slot (0, 0)
    table = np.array([[0, 0], [3, 4], [0, 0]], np.int32)
    pos = np.array([0, 5, 0], np.int32)
    jp = JL.page_scatter_token(jnp.asarray(pages), jnp.asarray(table),
                               jnp.asarray(pos), jnp.asarray(want))
    tp = _t(pages)
    L.page_scatter_token(tp, _t(table), _t(pos), tok)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    blk = r.integers(-127, 128, (4, 2, 16)).astype(np.int8)
    jp2 = JL.page_write(jnp.asarray(pages), jnp.int32(2), jnp.asarray(blk))
    tp2 = _t(pages)
    L.page_write(tp2, torch.tensor(2), _t(blk))
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))


@pytest.mark.parametrize("pos0", [0, 8, 24])
def test_paged_prefill_attention_within_bounds(pos0, exact_pow2):
    r = np.random.default_rng(6 + pos0)
    page, kv, g, dh, p = 8, 2, 2, 16, 7
    jq, tq = _qt_pair(r, (1, page, kv * g, dh))
    kp = r.integers(-127, 128, (p, page, kv, dh)).astype(np.int8)
    vp = r.integers(-127, 128, (p, page, kv, dh)).astype(np.int8)
    table = np.array([[2, 5, 1, 3]], np.int32)
    pos = pos0 + np.arange(page, dtype=np.int32)
    s = jnp.float32(2.0 ** -7)
    want = JL.paged_prefill_attention(
        JCFG, jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), s, s,
        q_pos=jnp.asarray(pos))
    ts = torch.tensor(2.0 ** -7)
    got = L.paged_prefill_attention(CFG, tq, _t(kp), _t(vp), _t(table), ts,
                                    ts, q_pos=_t(pos))
    _attn_ok(got, want)


def test_paged_decode_attention_within_bounds(exact_pow2):
    r = np.random.default_rng(7)
    page, kv, g, dh, p, b = 4, 2, 2, 16, 9, 3
    jq, tq = _qt_pair(r, (b, 1, kv * g, dh))
    kp = r.integers(-127, 128, (p, page, kv, dh)).astype(np.int8)
    vp = r.integers(-127, 128, (p, page, kv, dh)).astype(np.int8)
    table = np.array([[0, 0, 0], [1, 2, 3], [4, 5, 0]], np.int32)
    pos = np.array([0, 10, 6], np.int32)
    s = jnp.float32(2.0 ** -7)
    want = JL.paged_decode_attention(
        JCFG, jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), s, s,
        q_pos=jnp.asarray(pos), t_valid=jnp.int32(11))
    ts = torch.tensor(2.0 ** -7)
    got = L.paged_decode_attention(CFG, tq, _t(kp), _t(vp), _t(table), ts,
                                   ts, q_pos=_t(pos), t_valid=11)
    _attn_ok(got, want)


def test_winit_grid_and_scale():
    w = torch.empty(256, 512)
    L.winit_(CFG, w, 256, torch.Generator().manual_seed(0))
    n = w * 2 ** 23
    assert torch.equal(n, torch.round(n)) and float(w.abs().max()) < 1.0
    assert abs(float(w.std()) * math.sqrt(256) - 1.0) < 0.02


# --------------------------------------------------------------------------
# model steps on carried-over weights
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    acfg = jget("granite-3-8b").reduced()
    jm = jbuild(acfg, JCFG)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get("granite-3-8b").reduced(), CFG, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _logits_ok(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_model_prefill_page_and_decode_step(models):
    jm, params, tm = models
    a = tm.a
    page, n_pages, lanes = 8, 9, 3
    jpool = PagePool(n_pages, page, a.n_layers, a.n_kv, a.dh, device="cpu")
    kv_shape = tuple(jpool.k.shape)
    jk = jnp.zeros(kv_shape, jnp.int8)
    jv = jnp.zeros(kv_shape, jnp.int8)
    sc = jnp.full((a.n_layers,), 2.0 ** -7, jnp.float32)
    row = np.array([[3, 1, 0, 0]], np.int32)
    toks = np.random.default_rng(8).integers(0, a.vocab, 2 * page)
    for j in range(2):                         # two prompt pages
        view = {"k_pages": jk, "v_pages": jv, "k_scale": sc, "v_scale": sc,
                "table": jnp.asarray(row)}
        lg, _, nc = jm.prefill_page(params, {"pos": jnp.zeros((1,), jnp.int32)},
                                    view, jnp.asarray(toks[j * page:(j + 1)
                                                           * page]),
                                    j * page)
        jk, jv = nc["k_pages"], nc["v_pages"]
        tlg, _ = tm.prefill_page({"pos": torch.zeros(1, dtype=torch.int32)},
                                 jpool.view(_t(row)),
                                 _t(toks[j * page:(j + 1) * page]), j * page)
        _logits_ok(tlg.numpy(), lg)
    np.testing.assert_array_equal(jpool.k.numpy(), np.asarray(jk))
    # one decode step: lane 1 continues at position 16, lanes 0/2 dead
    table = np.array([[0, 0, 0, 0], [3, 1, 6, 0], [0, 0, 0, 0]], np.int32)
    tok = np.array([5, 7, 0], np.int32)
    pos = np.array([0, 16, 0], np.int32)
    view = {"k_pages": jk, "v_pages": jv, "k_scale": sc, "v_scale": sc,
            "table": jnp.asarray(table)}
    lg, _, nc = jm.paged_decode_step(params, {"pos": jnp.asarray(pos)}, view,
                                     jnp.asarray(tok))
    tlg, _ = tm.paged_decode_step({"pos": _t(pos)}, jpool.view(_t(table)),
                                  _t(tok))
    _logits_ok(tlg.numpy(), lg)
    np.testing.assert_array_equal(jpool.k.numpy(), np.asarray(nc["k_pages"]))
    assert lanes == tlg.shape[0]


def test_model_layouts_match_reference(models):
    jm, params, tm = models
    for k, v in params["layers"].items():
        assert tuple(tm.layers[k].shape) == v.shape, k
    assert tuple(tm.embed.shape) == params["embed"].shape
    assert tuple(tm.lm_head.shape) == params["lm_head"].shape
    full = get("granite-3-8b")
    assert (full.d_model, full.n_heads, full.n_kv, full.dh, full.d_ff,
            full.vocab, full.vocab_padded) == (4096, 32, 8, 128, 12800,
                                               49155, 49664)
