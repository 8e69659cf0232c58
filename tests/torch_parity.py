"""Shared helpers of the test_torch_*.py parity tests (port vs reference).

`exact_pow2` patches the reference package's pow2 helpers with exact
versions for one test (ROADMAP F1: `jnp.exp2` on the CPU is inexact for
integer k <= -15 and most k >= 13, so the reference's "pow2" scales are not
always powers of two there).  The port builds its scales from exponent
bits; with the patch both packages follow the paper's pow2 semantics.  No
file of the reference package changes.

The reference's module-level `jax.jit`s (e.g. in kernels/paged_attention.py)
read the patched helpers when they trace, so the patch clears JAX's caches
before it applies and again after it is undone: no trace made under the
patch outlives it, and none made without it is reused under it, whatever
order the test files run in within one process.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _pow2_int(e):
    return jnp.ldexp(jnp.float32(1.0), e.astype(jnp.int32))


def exact_pow2_ceil(m):
    safe = jnp.where(m > 0, m, 1.0)
    mant, ex = jnp.frexp(safe)
    ex = jnp.where(mant == 0.5, ex - 1, ex)
    return jnp.where(m > 0, _pow2_int(ex), 1.0).astype(jnp.float32)


def exact_pow2_round(m):
    safe = jnp.where(m > 0, m, 1.0)
    mant, ex = jnp.frexp(safe)
    ex = jnp.where(2.0 * mant > 2.0 ** 0.5, ex, ex - 1)
    return jnp.where(m > 0, _pow2_int(ex), 1.0).astype(jnp.float32)


@contextlib.contextmanager
def exact_pow2_patched():
    """The reference's pow2 helpers made exact inside the block."""
    import repro.core.qfuncs as qf
    import repro.kernels.paged_attention as pa
    import repro.kernels.ref as kref
    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(qf, "pow2_ceil", exact_pow2_ceil)
            mp.setattr(qf, "pow2_round", exact_pow2_round)
            mp.setattr(kref, "_pow2_ceil", exact_pow2_ceil)
            mp.setattr(pa, "_pow2_ceil", exact_pow2_ceil)
            yield
    finally:
        jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a whole test module (autouse where a module
    imports it).  Under the suite's parallel workers the port's many small
    CPU ops wait on thread pools that the other workers also hold; the
    tests' bounds do not depend on the thread count."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def exact_pow2():
    with exact_pow2_patched():
        yield


def ubn_rows_ok(got: np.ndarray, want: np.ndarray) -> None:
    """The K4 (UBN) tolerance: a row's statistic is a sum in another order
    (and an sqrt that XLA and PyTorch round differently on the CPU), so its
    k_sigma-grid value may land one grid step away.  At most
    max(2, M // 20) rows (5%) may differ, each element by at most 2^-10 of
    its row's largest magnitude; all other rows are bitwise equal."""
    rows = (got != want).any(axis=1)
    assert rows.sum() <= max(2, got.shape[0] // 20), rows.sum()
    if rows.any():
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= 2.0 ** -10 * scale)[rows].all()
