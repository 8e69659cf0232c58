"""The port's kernel ops (repro_torch.kernels) against the JAX reference.

On the CPU each op runs its plain PyTorch version; it is held against
`repro.kernels.ref` and against the Pallas kernel in interpret mode on the
same numpy inputs.  Tolerances:

  K1 qmatmul, K2 quantize, K3 dgrad/wgrad, K7 page_gather, K8
     cq_stochastic: bitwise (K3's int16 planes included, whose int32 sums
     wrap as the reference's do).
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
  K5 flash_attention: the final row max m is bitwise equal; the row sum l
     is rescaled by exp(m_old - m_new) at each kv step (exp differs by an
     ulp between the libraries), so |dl| <= T * 2^-23 * l; the output's
     Q_A payload codes (the grid the layer puts it on) differ by at most 1
     on at most 1% of entries.

The CUDA kernels are held against the plain versions on the card in
test_torch_cuda.py.
"""
import functools
import importlib
import math
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
from repro.kernels.backward import bwd_dgrad as pallas_dgrad
from repro.kernels.backward import bwd_wgrad as pallas_wgrad
from repro.kernels.paged_attention import flash_attention as pallas_flash
from repro.kernels.page_gather import page_gather as pallas_page_gather
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.qmatmul import qmatmul as pallas_qmatmul
from repro.kernels.quantize import cq_stochastic as pallas_cq
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


def _views(r, m, k, n, batch, ta, tb):
    """int8 operands of (batch.., M, K) x (batch.., K, N) as transposed
    views where asked, with their contiguous copies."""
    a = _t(_i8(r, batch + (k, m))).transpose(-1, -2) if ta \
        else _t(_i8(r, batch + (m, k)))
    b = _t(_i8(r, batch + (n, k))).transpose(-1, -2) if tb \
        else _t(_i8(r, batch + (k, n)))
    return a, b


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
@pytest.mark.parametrize("ta,tb", [(True, False), (False, True),
                                   (True, True)])
def test_qmatmul_views_equal_contiguous(batch, ta, tb):
    """ops.qmatmul on transposed and permuted views equals the product of
    the contiguous copies (and the reference's), requantized too."""
    r = np.random.default_rng(len(batch) * 4 + 2 * ta + tb)
    a, b = _views(r, 6, 40, 24, batch, ta, tb)
    assert not (a.is_contiguous() and b.is_contiguous())
    got = ops.qmatmul(a, b)
    np.testing.assert_array_equal(
        got.numpy(), ops.qmatmul(a.contiguous(), b.contiguous()).numpy())
    np.testing.assert_array_equal(got.reshape(-1, 6, 24).numpy(), np.stack(
        [np.asarray(jref.qmatmul_ref(jnp.asarray(x), jnp.asarray(y)))
         for x, y in zip(a.reshape(-1, 6, 40).numpy(),
                         b.reshape(-1, 40, 24).numpy())]))
    inv = torch.tensor(2.0 ** -9)
    np.testing.assert_array_equal(
        ops.qmatmul(a, b, inv).numpy(),
        ops.qmatmul(a.contiguous(), b.contiguous(), inv).numpy())


def _emulate(x, flag, ld, strides, sizes, rows, cols):
    """The (z, rows, cols) matrices K1 reads for one operand: its storage
    addressed as the kernel does from the descriptor."""
    flat = torch.empty(0, dtype=torch.int8).set_(x.untyped_storage())
    n0, n1, n2 = sizes
    mats = []
    for z in range(n0 * n1 * n2):
        off = x.storage_offset() + (z // (n1 * n2)) * strides[0] \
            + (z // n2) % n1 * strides[1] + (z % n2) * strides[2]
        st = (1, ld) if flag else (ld, 1)
        mats.append(torch.as_strided(flat, (rows, cols), st, off))
    return torch.stack(mats)


@pytest.mark.parametrize("case", ["2d", "batched_t", "broadcast",
                                  "attention", "four_dims", "odd_strides"])
def test_qmm_operands_address_like_the_kernel(case):
    """The descriptor K1 gets (batch strides, row pitch, layout flag per
    operand, batch sizes) addresses exactly the operands' elements: the
    product of the matrices read through it equals the plain product."""
    r = np.random.default_rng(5)
    if case == "2d":
        a, b = _views(r, 5, 33, 7, (), False, True)
    elif case == "batched_t":
        a, b = _views(r, 5, 33, 7, (3,), True, True)
    elif case == "broadcast":
        a, b = _t(_i8(r, (2, 3, 5, 16))), _t(_i8(r, (2, 1, 16, 9)))
    elif case == "attention":      # q (b,s,k,g,d) x k (b,t,k,d) as qdense does
        q, k = _t(_i8(r, (2, 6, 3, 2, 8))), _t(_i8(r, (2, 10, 3, 8)))
        a = q.permute(0, 2, 3, 1, 4)
        b = k.permute(0, 2, 3, 1)[:, :, None]
    elif case == "four_dims":      # more batch dims than the kernel takes
        a = _t(_i8(r, (2, 3, 2, 3, 4, 6))).permute(0, 2, 1, 3, 4, 5)
        b = _t(_i8(r, (3, 2, 3, 6, 5))).permute(1, 0, 2, 3, 4)[None]
    else:                          # rows not contiguous either way
        a = _t(_i8(r, (4, 12, 9)))[:, ::2, ::3]
        b = _t(_i8(r, (3, 7)))
    x, y, shape, desc = ops._qmm_operands(a, b)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    sizes = (math.prod(shape) // max(desc[10] * desc[11], 1), desc[10],
             desc[11])
    ea = _emulate(x, desc[4], desc[3], desc[0:3], sizes, m, k)
    eb = _emulate(y, desc[9], desc[8], desc[5:8], sizes, k, n)
    want = ops.qmatmul(a, b).reshape(-1, m, n)
    np.testing.assert_array_equal(ops.qmatmul(ea, eb).numpy(), want.numpy())
    if case in ("2d", "batched_t", "broadcast", "attention"):
        assert x is a and y is b          # read as they lie: no copy


@pytest.mark.parametrize("z,m,n,k,split", [
    (1, 4, 12800, 4096, True),       # decode: the weight streams, sliced
    (1, 16, 288, 8192, True),        # x_proj: three column blocks
    (1, 4096, 12800, 4096, False),   # training qdense: 3200 tiles
    (32, 1024, 512, 128, False),     # attention chunk, one k tile
    (32, 128, 512, 1024, True),      # dk / dv: 128 tiles, 8 k tiles
    (1, 4, 64, 100, False)])         # too shallow to split
def test_qmm_splits(z, m, n, k, split):
    """K1 splits the contraction only where the blocks cannot fill the
    card: on the narrow route until some four blocks an SM run, each slice
    at least four 64-deep stages; on the wide route only when the tiles
    are fewer than the SMs.  Every depth is covered exactly once."""
    splits, kper = ops._qmm_splits(z, m, n, k, 132)
    assert (splits > 1) == split
    step = 128 if m > 16 else 64
    assert kper % step == 0 and (splits - 1) * kper < k <= splits * kper
    if m <= 16 and split:
        assert z * -(-n // 128) * splits >= 2 * 132 or kper == 4 * 64


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
# K8 cq_stochastic
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16), (37, 70), (1, 9), (300, 257)])
@pytest.mark.parametrize("inv,dr", [(2.0 ** 12, 128.0), (2.0 ** 9, 64.0)])
def test_cq_stochastic_bitwise(shape, inv, dr):
    """The port takes the uint32 bits as the int32 of the same pattern (and
    as torch.uint32 too); ragged shapes pad the Pallas kernel's blocks."""
    r = np.random.default_rng(shape[0] + int(dr))
    x = (r.standard_normal(shape) * 0.02).astype(np.float32)
    bits = r.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    got = ops.cq_stochastic(_t(x), _t(bits.view(np.int32)), inv, dr)
    assert got.dtype == torch.int16
    jargs = (jnp.asarray(x), jnp.asarray(bits), jnp.float32(inv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.cq_stochastic_ref(*jargs, dr)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        pallas_cq(*jargs, dr=dr, bm=64, bn=64, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), ops.cq_stochastic(
        _t(x), torch.from_numpy(bits), inv, dr).numpy())


# --------------------------------------------------------------------------
# K3 dgrad / wgrad
# --------------------------------------------------------------------------

BWD_MODES = [("affine", 8, 2.0 ** 9), ("affine", 16, 2.0 ** 17),
             ("flag", 8, 2.0 ** 8)]


@pytest.mark.parametrize("mode,k,inv", BWD_MODES)
@pytest.mark.parametrize("m,n,kd", [(37, 70, 45), (16, 64, 32), (5, 600, 9)])
def test_dgrad_wgrad_bitwise(mode, k, inv, m, n, kd):
    r = np.random.default_rng(m * n + kd + k)
    g = (r.standard_normal((m, n)) * 0.01).astype(np.float32)
    b8, a8 = _i8(r, (kd, n)), _i8(r, (m, kd))
    scal = np.array([inv, 2.0 ** -16, 2.0 ** -23], np.float32)
    jg, js = jnp.asarray(g), jnp.asarray(scal)
    kw = dict(mode=mode, k=k)
    got = ops.dgrad(_t(g), _t(b8), _t(scal), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.dgrad_ref(jg, jnp.asarray(b8), js, **kw)))
    np.testing.assert_array_equal(got, np.asarray(pallas_dgrad(
        jg, jnp.asarray(b8), js, bm=32, bk=32, bn=32, interpret=True, **kw)))
    got = ops.wgrad(_t(a8), _t(g), _t(scal), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.wgrad_ref(jnp.asarray(a8), jg, js, **kw)))
    np.testing.assert_array_equal(got, np.asarray(pallas_wgrad(
        jnp.asarray(a8), jg, js, bm=32, bk=32, bn=32, interpret=True, **kw)))


def test_dgrad_int16_sum_wraps_like_the_reference():
    n = 2000                   # 2000 * 32767 * 127 > 2^31: int32 wraps
    g = np.ones((2, n), np.float32)
    b8 = np.full((3, n), 127, np.int8)
    scal = np.array([2.0 ** 15, 1.0, 0.0], np.float32)
    got = ops.dgrad(_t(g), _t(b8), _t(scal), mode="affine", k=16).numpy()
    want = np.asarray(jref.dgrad_ref(jnp.asarray(g), jnp.asarray(b8),
                                     jnp.asarray(scal), mode="affine", k=16))
    np.testing.assert_array_equal(got, want)
    wrapped = (n * 32767 * 127 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert got[0, 0] == np.float32(wrapped) and wrapped != n * 32767 * 127


@pytest.mark.parametrize("mode,k,inv", BWD_MODES)
def test_error_planes_match_the_reference(mode, k, inv):
    from repro_torch.kernels import ref
    g = (np.random.default_rng(k).standard_normal((9, 33)) * 0.03).astype(
        np.float32)
    got = ref.bwd_error_planes(_t(g), torch.tensor(inv), mode=mode, k=k)
    want = jref.bwd_error_planes_ref(jnp.asarray(g), jnp.float32(inv),
                                     mode=mode, k=k)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# K5 flash_attention
# --------------------------------------------------------------------------


def _jax_flash_ml(q8, k8, qp, kp, kval, scales, *, causal, sm, qc, kc):
    """The reference oracle's final m and l per row, by its own formulas
    (flash_attention_ref keeps them internal)."""
    b, s, h, dh = q8.shape
    t, kv = k8.shape[1], k8.shape[2]
    g = h // kv
    qf = (q8.astype(jnp.float32) * scales[0]).reshape(b, s, kv, g, dh)
    kf = k8.astype(jnp.float32) * scales[1]
    ms, ls = [], []
    for iq in range(s // qc):
        qi8, q_step = jref._grid_decompose(qf[:, iq * qc:(iq + 1) * qc], 8)
        qpos = qp[iq * qc:(iq + 1) * qc]
        m = jnp.full(qi8.shape[:-1], jref.NEG_INF, jnp.float32)
        l = jnp.zeros_like(m)
        for j in range(t // kc):
            ki8, k_step = jref._grid_decompose(kf[:, j * kc:(j + 1) * kc], 8)
            sc = jnp.einsum("bskgd,btkd->bskgt", qi8, ki8,
                            preferred_element_type=jnp.int32
                            ).astype(jnp.float32) * (q_step * k_step)
            sc = sc * sm
            kval_j = kval[j * kc:(j + 1) * kc] != 0
            mask = kval_j[None, :] if not causal else (
                (qpos[:, None] >= kp[j * kc:(j + 1) * kc][None, :])
                & kval_j[None, :])
            sc = jnp.where(mask[None, :, None, None, :], sc, jref.NEG_INF)
            m_new = jnp.maximum(m, jnp.max(sc, axis=-1))
            p = jnp.round(jnp.exp(sc - m_new[..., None]) * 128.0) / 128.0
            l = l * jnp.exp(m - m_new) + jnp.sum(p, axis=-1)
            m = m_new
        ms.append(m)
        ls.append(l)
    return (np.asarray(jnp.concatenate(ms, 1)).reshape(b, s, h),
            np.asarray(jnp.concatenate(ls, 1)).reshape(b, s, h))


@pytest.mark.parametrize("causal,b,s,t,h,kv,dh,qc,kc,pad,interp", [
    (True, 1, 32, 32, 4, 2, 16, 16, 16, 0, True),
    (False, 2, 32, 48, 4, 2, 16, 16, 16, 5, False),
    (True, 1, 64, 64, 8, 2, 16, 32, 16, 3, False),
    (True, 1, 48, 48, 4, 4, 32, 16, 16, 0, False)])
def test_flash_attention_within_bounds(causal, b, s, t, h, kv, dh, qc, kc,
                                       pad, interp, exact_pow2):
    r = np.random.default_rng(s + t + dh)
    q8, k8, v8 = _i8(r, (b, s, h, dh)), _i8(r, (b, t, kv, dh)), \
        _i8(r, (b, t, kv, dh))
    qp, kp = np.arange(s, dtype=np.int32), np.arange(t, dtype=np.int32)
    kval = (kp < t - pad).astype(np.int32)
    scales = (2.0 ** -6, 2.0 ** -7, 2.0 ** -5)
    sm = 1.0 / float(np.sqrt(dh))
    kw = dict(causal=causal, sm_scale=sm, q_chunk=qc, kv_chunk=kc)
    from repro_torch.kernels import ref
    parts = ref.flash_attention_parts(
        *(_t(x) for x in (q8, k8, v8, qp, kp, kval)),
        *(torch.tensor(x) for x in scales), **kw)
    jargs = (jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8),
             jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(kval),
             *(jnp.float32(x) for x in scales))
    want = np.asarray(jax.jit(functools.partial(jref.flash_attention_ref,
                                                **kw))(*jargs))
    if interp:     # the Pallas kernel equals its oracle (slow: one case)
        kern = np.asarray(pallas_flash(*jargs, interpret=True, **kw))
        np.testing.assert_array_equal(want, kern)
    m, l = _jax_flash_ml(*jargs[:2], *jargs[3:6], jargs[6:], causal=causal,
                         sm=sm, qc=qc, kc=kc)
    np.testing.assert_array_equal(parts["m"].numpy(), m)
    assert (np.abs(parts["l"].numpy() - l) <= t * 2.0 ** -23 * l).all()
    got = parts["out"].numpy()
    step = 2.0 ** (np.ceil(np.log2(np.abs(want).max())) - 7)
    d = np.abs(np.round(got / step) - np.round(want / step))
    assert d.max() <= 1 and np.mean(d > 0) <= 0.01
    np.testing.assert_array_equal(ops.flash_attention(
        *(_t(x) for x in (q8, k8, v8, qp, kp, kval)),
        *(torch.tensor(x) for x in scales), **kw).numpy(), got)


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


@pytest.mark.parametrize("head_major", [False, True])
def test_page_gather_two_pools_against_reference(head_major):
    """K and V through one table in one call, in the default layout and
    head-major (B, KV, NB * page, dh): the reference's page_gather_ref of
    each pool, permuted for the head-major layout."""
    r = np.random.default_rng(11)
    kp, vp = _i8(r, (9, 4, 3, 16)), _i8(r, (9, 4, 3, 16))
    table = r.integers(-2, 12, (2, 5)).astype(np.int32)       # ids clamp
    got = ops.page_gather(_t(kp), _t(table), pages2=_t(vp),
                          head_major=head_major)
    assert isinstance(got, tuple) and len(got) == 2
    for x, pool in zip(got, (kp, vp)):
        want = np.asarray(jref.page_gather_ref(jnp.asarray(pool),
                                               jnp.asarray(table)))
        if head_major:
            want = want.transpose(0, 3, 1, 2, 4).reshape(2, 3, 5 * 4, 16)
        np.testing.assert_array_equal(x.numpy(), want)
    one = ops.page_gather(_t(kp), _t(table), head_major=head_major)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


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
    scal = torch.tensor([1.0, 1.0, 0.0])
    ops.dgrad(torch.zeros(2, 4), torch.zeros(3, 4, dtype=torch.int8), scal,
              mode="affine", k=8)
    ops.wgrad(torch.zeros(2, 3, dtype=torch.int8), torch.zeros(2, 4), scal,
              mode="flag", k=8)
    z8 = torch.zeros(1, 4, 2, 8, dtype=torch.int8)
    pos = torch.arange(4)
    ops.flash_attention(z8, z8, z8, pos, pos, torch.ones(4), 1.0, 1.0, 1.0,
                        causal=True, sm_scale=0.5, q_chunk=2, kv_chunk=2)
    ops.ubn_norm(torch.ones(6, 4), torch.ones(4), torch.zeros(4),
                 kind="batch")
    ops.cq_stochastic(torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                      1.0)
    ops.selective_scan(torch.ones(1, 2, 3, 4), torch.ones(1, 2, 3, 4),
                       torch.ones(1, 2, 4))
    ops.selective_scan_bwd(torch.ones(1, 2, 3, 4), torch.ones(1, 2, 3, 4),
                           torch.ones(1, 2, 4), torch.ones(1, 2, 3))
    assert ops.LAUNCHES == dict.fromkeys(ops.OPS, 0)
    assert set(ops.OPS) == {"qmatmul", "quantize", "ubn_norm",
                            "page_gather", "paged_attention", "dgrad",
                            "wgrad", "flash_attention", "cq_stochastic",
                            "selective_scan", "selective_scan_bwd"}


def test_every_kernel_has_a_source():
    """Each source names the TPU kernel it replaces, or, for the port-only
    K9b (the scan's gradient, which the reference takes by autodiff of an
    XLA scan), says that it replaces none."""
    from repro_torch.kernels import _build
    for name in _build.NAMES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert ("Replaces no TPU kernel" if name == "selective_scan_bwd"
                else "Replaces repro/kernels/") in src
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
    assert "repro_torch.checkpoint.manager" in mods
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


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A library's file name hashes the shared headers under csrc/ as well
    as its source: one changed byte of hopper.cuh (which qmatmul.cu,
    backward.cu and flash_attention.cu include) renames, and so rebuilds,
    all three; the header is not a kernel of its own."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = {n: _build._target(n) for n in _build.NAMES}
    assert before == {n: _build._target(n) for n in _build.NAMES}
    hdr = csrc / "hopper.cuh"
    for name in ("backward", "flash_attention", "qmatmul"):
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()
    data = bytearray(hdr.read_bytes())
    data[-2] ^= 1
    hdr.write_bytes(bytes(data))
    after = {n: _build._target(n) for n in _build.NAMES}
    for name in ("backward", "flash_attention", "qmatmul"):
        assert after[name] != before[name]
    assert "hopper" not in _build.NAMES
