"""The port's kernel ops (repro_torch.kernels) against the JAX reference.

On the CPU each op runs its plain PyTorch version; it is held against
`repro.kernels.ref` and against the Pallas kernel in interpret mode on the
same numpy inputs.  Tolerances:

  K1 qmatmul, K2 quantize, K7 page_gather: bitwise.
  K4 ubn_norm: a row's statistic is a sum taken in another order (float64
     here, fp32 in the reference) and an sqrt that XLA and PyTorch round
     differently on the CPU, so its k_sigma-grid value may land one grid
     step away: at most max(2, M // 20) rows (5%) may differ, each element
     by at most 2^-10 of its row's largest magnitude (torch_parity.py).
  K6 paged_attention: the scores and the row max m are bitwise equal; the
     row sum l is an fp32 sum of T exp terms (exp differs by an ulp between
     the two libraries, and the order differs), so |dl| <= T * 2^-23 * l;
     the probability payload may flip by one code, which shows in the
     output as at most 2 * 127 * step * v_scale, on at most 2% of entries.

The CUDA kernels are held against the plain versions on the card in
test_torch_cuda.py.
"""
import functools
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.page_gather import page_gather as pallas_page_gather
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.qmatmul import qmatmul as pallas_qmatmul
from repro.kernels.quantize import quantize_fused as pallas_quantize
from repro.kernels.ubn import ubn_norm as pallas_ubn
from repro_torch.kernels import ops

from torch_parity import exact_pow2, ubn_rows_ok  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _i8(r, shape):
    return r.integers(-127, 128, shape).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# K1 qmatmul
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (4, 64, 96), (16, 96, 64),
                                   (37, 64, 129), (1, 256, 64)])
def test_qmatmul_bitwise(m, k, n):
    r = np.random.default_rng(m * k + n)
    a, b = _i8(r, (m, k)), _i8(r, (k, n))
    got = ops.qmatmul(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.qmatmul_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        pallas_qmatmul(jnp.asarray(a), jnp.asarray(b), bm=32, bn=32, bk=64,
                       interpret=True)))


@pytest.mark.parametrize("inv", [2.0 ** -7, 2.0 ** -12])
def test_qmatmul_requant_bitwise(inv):
    r = np.random.default_rng(3)
    a, b = _i8(r, (16, 64)), _i8(r, (64, 32))
    got = ops.qmatmul(_t(a), _t(b), torch.tensor(inv), lim=127.0)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.qmatmul_requant_ref(jnp.asarray(a), jnp.asarray(b),
                                 jnp.float32(inv))))


def test_qmatmul_batched_matches_per_batch():
    r = np.random.default_rng(4)
    a, b = _i8(r, (3, 8, 40)), _i8(r, (3, 40, 24))
    got = ops.qmatmul(_t(a), _t(b)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(
            jref.qmatmul_ref(jnp.asarray(a[i]), jnp.asarray(b[i]))))


def test_qmatmul_int32_worst_case_exact():
    k = 12800                     # the FFN's K at full width
    a = torch.full((2, k), 127, dtype=torch.int8)
    b = torch.full((k, 3), -127, dtype=torch.int8)
    assert int(ops.qmatmul(a, b)[0, 0]) == -k * 127 * 127


# --------------------------------------------------------------------------
# K2 quantize
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16), (100, 70), (1, 8), (4, 64)])
@pytest.mark.parametrize("inv", [128.0, 4.0, 1 / 64.0])
def test_quantize_bitwise(shape, inv):
    x = (np.random.default_rng(5).standard_normal(shape) * 3).astype(
        np.float32)
    got = ops.quantize(_t(x), inv).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.quantize_ref(jnp.asarray(x), jnp.float32(inv), 127.0)))
    np.testing.assert_array_equal(got, np.asarray(
        pallas_quantize(jnp.asarray(x), jnp.float32(inv), bm=64, bn=64,
                        interpret=True)))


def test_quantize_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0])
    assert ops.quantize(x, 1.0).tolist() == [0, 2, 2, 0, -2, 127, -127]


# --------------------------------------------------------------------------
# K4 ubn_norm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rms", "layer", "batch"])
@pytest.mark.parametrize("m,n", [(16, 64), (4, 64), (200, 96)])
def test_ubn_norm_row_bound(kind, m, n, exact_pow2):
    r = np.random.default_rng(m + n)
    x = (r.standard_normal((m, n)) * 2 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.1 * r.standard_normal(n)).astype(np.float32)
    beta = None if kind == "rms" else (0.1 * r.standard_normal(n)).astype(
        np.float32)
    got = ops.ubn_norm(_t(x), _t(gamma), None if beta is None else _t(beta),
                       kind=kind).numpy()
    jb = None if beta is None else jnp.asarray(beta)
    kw = dict(kind=kind, k_mu=16, k_sigma=16, k_bn=16, k_gamma=8, k_beta=8,
              eps=2.0 ** -8)
    want = np.asarray(jref.ubn_norm_ref(jnp.asarray(x), jnp.asarray(gamma),
                                        jb, **kw))
    if kind == "batch":          # stats per column: compare transposed rows
        ubn_rows_ok(got.T, want.T)
        return
    ubn_rows_ok(got, want)
    kern = np.asarray(pallas_ubn(jnp.asarray(x), jnp.asarray(gamma), jb,
                                 bt=8, interpret=True, **kw))
    ubn_rows_ok(got, kern)


# --------------------------------------------------------------------------
# K7 page_gather
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p,page,d,b,nb", [(9, 4, 32, 2, 3), (5, 8, 16, 3, 2),
                                           (17, 16, 64, 1, 4)])
def test_page_gather_bitwise(p, page, d, b, nb):
    r = np.random.default_rng(p)
    pages = _i8(r, (p, page, d))
    table = r.integers(-2, p + 3, (b, nb)).astype(np.int32)   # ids clamp
    got = ops.page_gather(_t(pages), _t(table)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.page_gather_ref(jnp.asarray(pages), jnp.asarray(table))))
    np.testing.assert_array_equal(got, np.asarray(
        pallas_page_gather(jnp.asarray(pages), jnp.asarray(table),
                           interpret=True)))


def test_page_gather_trailing_dims():
    r = np.random.default_rng(1)
    pages = _i8(r, (6, 4, 2, 8))
    table = np.array([[1, 5], [0, 3]], np.int32)
    got = ops.page_gather(_t(pages), _t(table))
    assert got.shape == (2, 2, 4, 2, 8)
    np.testing.assert_array_equal(got.numpy(), pages[table])


# --------------------------------------------------------------------------
# K6 paged_attention
# --------------------------------------------------------------------------


def paged_case(p, page, kv, g, dh, b, nb, seed=0):
    """Pages + a table with a dead lane (trash page 0), multi-page contexts
    and ragged last pages (the reference test's construction)."""
    r = np.random.default_rng(seed)
    kp, vp = _i8(r, (p, page, kv, dh)), _i8(r, (p, page, kv, dh))
    q8 = _i8(r, (b, kv * g, dh))
    table = np.zeros((b, nb), np.int32)
    q_pos = np.zeros((b,), np.int32)
    ids = list(range(1, p))
    for lane in range(1, b):
        n_blk = 1 + (lane % nb)
        take, ids = ids[:n_blk], ids[n_blk:] + ids[:n_blk]
        table[lane, :n_blk] = take
        q_pos[lane] = n_blk * page - 1 - (lane % page)
    return q8, kp, vp, table, q_pos, int(q_pos.max()) + 1


SCALES = (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)


@functools.partial(jax.jit, static_argnames=("tv", "sm"))
def _jax_paged(q8, kp, vp, table, q_pos, tv, qs, ks, vs, *, sm):
    """The reference's output, plus its row max m and row sum l computed by
    the reference's own formulas (one jitted program: eager jnp is slow)."""
    out = jref.paged_attention_ref(q8, kp, vp, table, q_pos, tv, qs, ks, vs,
                                   sm_scale=sm)
    b, nb = table.shape
    page, kv, dh = kp.shape[1:]
    t, g = nb * page, q8.shape[1] // kv
    k8 = kp[table].reshape(b, t, kv, dh)
    s = jnp.einsum("bkgd,btkd->bkgt", q8.reshape(b, kv, g, dh), k8,
                   preferred_element_type=jnp.int32).astype(jnp.float32)
    s = s * (qs * ks) * sm
    kpos = jnp.arange(t)
    mask = (kpos[None] <= q_pos[:, None]) & (kpos[None] < tv)
    s = jnp.where(mask[:, None, None], s, jref.NEG_INF)
    m = jnp.max(s, -1)
    return out, m, jnp.sum(jnp.exp(s - m[..., None]), -1)


@pytest.mark.parametrize("p,page,kv,g,dh,b,nb,interp", [
    (9, 4, 2, 2, 8, 3, 4, True), (17, 8, 2, 4, 16, 4, 3, False),
    (9, 4, 4, 1, 8, 2, 2, False), (33, 16, 2, 4, 16, 4, 8, False)])
def test_paged_attention_within_bounds(p, page, kv, g, dh, b, nb, interp,
                                       exact_pow2):
    q8, kp, vp, table, q_pos, tv = paged_case(p, page, kv, g, dh, b, nb)
    sm = 1.0 / float(np.sqrt(dh))
    sc = [torch.tensor(s) for s in SCALES]
    parts = ops.paged_attention_parts(_t(q8), _t(kp), _t(vp), _t(table),
                                      _t(q_pos), tv, *sc, sm_scale=sm)
    jargs = (jnp.asarray(q8), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(table), jnp.asarray(q_pos), tv,
             *(jnp.float32(s) for s in SCALES))
    want, m, l = (np.asarray(t) for t in _jax_paged(*jargs, sm=sm))
    if interp:     # the Pallas kernel equals its oracle (slow: one case)
        kern = np.asarray(pallas_paged(*jargs, sm_scale=sm, interpret=True))
        np.testing.assert_array_equal(want, kern)
    t = nb * page
    np.testing.assert_array_equal(parts["m"].numpy(), m.reshape(b, -1))
    l = l.reshape(b, -1)
    assert (np.abs(parts["l"].numpy() - l) <= t * 2.0 ** -23 * l).all()
    got = parts["out"].numpy()
    step_v = 2.0 ** -7 * SCALES[2]        # p8 step <= 2^-7 (amax <= 1)
    assert np.abs(got - want).max() <= 2 * 127 * step_v
    assert np.mean(got != want) <= 0.02
    assert np.array_equal(ops.paged_attention(
        _t(q8), _t(kp), _t(vp), _t(table), _t(q_pos), tv, *sc,
        sm_scale=sm).numpy(), got)


def test_paged_attention_dead_lanes_read_trash_page():
    q8, kp, vp, table, q_pos, tv = paged_case(9, 4, 2, 2, 8, 3, 4)
    parts = ops.paged_attention_parts(
        _t(q8), _t(kp), _t(vp), _t(table), _t(q_pos), tv,
        *(torch.tensor(s) for s in SCALES), sm_scale=8 ** -0.5)
    # lane 0 is dead (table row 0, position 0): one valid slot, l == 1 and
    # its probability is the saturated code 127 on the 2^-7 step
    assert parts["l"][0].tolist() == [1.0] * 4
    assert parts["p8"][0, :, 0].tolist() == [127] * 4


# --------------------------------------------------------------------------
# dispatch, counters and the import contract
# --------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_route():
    ops.reset_launches()
    ops.qmatmul(torch.zeros(2, 4, dtype=torch.int8),
                torch.zeros(4, 2, dtype=torch.int8))
    ops.quantize(torch.zeros(3), 1.0)
    ops.ubn_norm(torch.ones(2, 8), torch.ones(8))
    ops.page_gather(torch.zeros(3, 2, 4, dtype=torch.int8),
                    torch.zeros(1, 2, dtype=torch.int32))
    assert ops.LAUNCHES == dict.fromkeys(ops.OPS, 0)
    assert set(ops.OPS) == {"qmatmul", "quantize", "ubn_norm",
                            "page_gather", "paged_attention"}


def test_every_kernel_has_a_source():
    from repro_torch.kernels import _build
    for name in _build.NAMES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces repro/kernels/" in src
        assert "sm_90a" in " ".join(_build.FLAGS)
        assert re.search(r'extern "C" int \w+_launch', src)


def test_ops_raise_without_a_fallback():
    text = (ROOT / "src/repro_torch/kernels/ops.py").read_text()
    assert "except" not in text      # no try that falls back to ref


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _port_modules()
    assert "repro_torch.serving.engine" in mods
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                  "PATH": "/usr/bin:/bin"})
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    for f in list((ROOT / "src/repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f


def test_every_port_module_imports_on_cpu():
    for m in _port_modules():
        importlib.import_module(m)
