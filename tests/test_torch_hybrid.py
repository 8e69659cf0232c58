"""The port's hybrid zamba2-7b (repro_torch.models.Zamba2: Mamba2 layers and
one shared attention + MLP block) against the reference package's
(repro.models.hybrid.Zamba2), on the CPU: configuration, layouts,
weights, the loss, monolithic prefill and dense-cache decode.

Sizes are zamba2-7b.reduced() (2 Mamba2 layers, a shared block after each,
d_model 64, d_inner 128 in 16 SSD heads of 8, N = 4, 4 query / 2 KV heads
of 16, FFN 96, vocab 128) and the same with 3 layers and a shared block
after every 2 (one group and a 1-layer tail).  The reference's weights
come from its `Zamba2.init` through `hybrid_params_from_jax`; every test
that runs the quantized model uses the `exact_pow2` fixture.  Serving is
tests/test_torch_hybrid_serve.py, training
tests/test_torch_hybrid_train.py, the Mamba2 block alone
tests/test_torch_mamba2.py.

Tolerances, and why:
- Logits: argmax equal and within 2^-10 of the largest |logit|; the
  shared block's int8 KV: at most 1% of the payloads one code apart; the
  Mamba2 state: conv windows equal, h within 2^-20 of max |h|.  The
  Mamba2 block's fp32 parts round differently from XLA's (its associative
  `cumsum`, its `exp` and dot orders: tests/test_torch_mamba2.py), which
  can move a payload code.  Measured: logits and payloads equal bit for
  bit, h within 2^-22.2 of max |h|.
- The loss within 2 ulps (2^-22 relative): its logsumexp reduces in
  another order (measured 1 ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.models.hybrid import Zamba2 as JZamba2
from repro_torch.configs import get
from repro_torch.convert import hybrid_params_from_jax
from repro_torch.core import preset
from repro_torch.models import Zamba2, build_model
from repro_torch.optim import flatten

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

NAME = "zamba2-7b"
CONFIGS = {"reduced": {}, "tail": {"n_layers": 3, "attn_every": 2}}


def _t(x):
    return torch.tensor(np.asarray(x))


@functools.cache
def _models(cfg: str):
    """(the reference's Zamba2 and params, the port's Zamba2 with the same
    weights) at zamba2-7b.reduced() with CONFIGS[cfg]."""
    jm = JZamba2(jget(NAME).reduced().replace(**CONFIGS[cfg]),
                 jpreset("full8", "native"))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get(NAME).reduced().replace(**CONFIGS[cfg]),
                     preset("full8"), device="cpu")
    tm.load_params(hybrid_params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _logits_close(got, want):
    got, want = np.asarray(got)[..., :128], np.asarray(want)[..., :128]
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert np.abs(got - want).max() <= 2.0 ** -10 * np.abs(want).max()


def _state_close(got: dict, want: dict):
    """conv windows equal, h within 2^-20 of max |h| (a cache's "m_conv"
    and "m_h")."""
    np.testing.assert_array_equal(got["m_conv"].numpy(),
                                  np.asarray(want["m_conv"]))
    h = np.asarray(want["m_h"])
    assert np.abs(got["m_h"].numpy() - h).max() <= 2.0 ** -20 * np.abs(
        h).max()


# --------------------------------------------------------------------------
# configuration, layouts and weights
# --------------------------------------------------------------------------


def test_configs_match_reference():
    for cfg, jcfg in ((get(NAME), jget(NAME)),
                      (get(NAME).reduced(), jget(NAME).reduced())):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv",
                  "d_ff", "vocab", "vocab_padded", "dh", "norm", "act",
                  "ssm_state", "ssm_kind", "d_conv", "expand", "d_inner",
                  "headdim", "attn_every", "scan_chunk", "q_chunk",
                  "kv_chunk", "rope_theta"):
            assert getattr(cfg, f) == getattr(jcfg, f), f


def test_full_width_layout_at_cut_depth():
    """chip_smoke.py's model: every width of zamba2-7b, 13 of 81 layers (two
    groups of 6 and a 1-layer tail; built on the meta device: shapes
    only, no storage)."""
    model = build_model(get(NAME).replace(n_layers=13), preset("full8"),
                        device="meta")
    assert isinstance(model, Zamba2)
    assert (model.n_groups, model.tail) == (2, 1)
    assert model.decode_state_spec()["kv_layers"] == 2
    shapes = {k: tuple(p.shape[1:]) for k, p in model.layers.items()}
    assert shapes["in_proj"] == (3584, 14336)
    assert shapes["bc_proj"] == (3584, 128)
    assert shapes["dt_proj"] == (3584, 112)
    assert shapes["out_proj"] == (7168, 3584)
    assert shapes["conv_w"] == (4, 7168) and shapes["A_log"] == (112,)
    assert tuple(model.shared["wq"].shape) == (3584, 3584)
    assert tuple(model.shared["w_down"].shape) == (14336, 3584)
    assert tuple(model.embed.shape) == (32256, 3584)
    per_layer = sum(p[0].numel() for p in model.layers.values())
    assert per_layer == 77_977_424
    assert model.n_params() == 1_450_449_168


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_params_from_jax_carries_each(cfg):
    """The reference's init, carried by hybrid_params_from_jax, loads into
    the port's model leaf for leaf, in JAX flatten order, with the
    reference's labels; the port's own init draws the same layouts."""
    jm, params, tm = _models(cfg)
    leaves = jax.tree.leaves(params)
    assert len(flatten(tm.params())) == len(leaves)
    for got, want in zip(flatten(tm.params()), leaves):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(params))
    fresh = build_model(tm.a, preset("full8"), device="cpu").init(3)
    assert [tuple(p.shape) for p in flatten(fresh.params())] == \
        [tuple(np.shape(w)) for w in leaves]


# --------------------------------------------------------------------------
# the model: loss, monolithic prefill, dense-cache decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_loss_prefill_and_serve_step(cfg, exact_pow2):
    """The loss of 2 x 21 tokens within 2 ulps; prefill of the same tokens
    into a 32-position cache, then 4 serve_steps: logits at every step, the
    shared block's int8 KV and the Mamba2 state against the reference's."""
    jm, params, tm = _models(cfg)
    r = np.random.default_rng(7)
    toks = r.integers(0, 128, (2, 21)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    lj, _ = jm.loss(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        lt, _ = tm.loss({k: _t(v) for k, v in batch.items()})
    assert abs(float(lt) - float(lj)) <= 2.0 ** -22 * abs(float(lj))
    cj, gj = jm.prefill(params, jnp.asarray(toks), 32)
    ct, gt = tm.prefill(_t(toks), 32)
    _logits_close(gt, gj)
    for _ in range(4):
        nxt = r.integers(0, 128, (2,)).astype(np.int32)
        cj, gj = jm.serve_step(params, cj, jnp.asarray(nxt))
        ct, gt = tm.serve_step(ct, _t(nxt))
        _logits_close(gt, gj)
    assert ct["pos"].tolist() == np.asarray(cj["pos"]).tolist() == [25, 25]
    for k in ("k", "v"):
        d = np.abs(ct[k].numpy().astype(np.int32)
                   - np.asarray(cj[k]).astype(np.int32))
        assert d.max() <= 1 and d.mean() <= 0.01
    _state_close(ct, cj)
    assert tuple(ct["k"].shape)[:2] == (tm.n_groups, 2)


def test_slot_api_matches_prefill(exact_pow2):
    """slot_from_cache splits a prefill cache into the dense Mamba2 slot
    and the (G, T, KV, dh) KV payloads, as the reference's does; one page
    through prefill_page from the zero slot advances every layer's state
    and writes its KV page into the pool for every application."""
    jm, params, tm = _models("tail")
    toks = np.random.default_rng(11).integers(0, 128, 8).astype(np.int32)
    cj, _ = jm.prefill(params, jnp.asarray(toks[None]), 16)
    ct, _ = tm.prefill(_t(toks[None]), 16)
    (dj, kvj), (dt, kvt) = jm.slot_from_cache(cj, 0), tm.slot_from_cache(ct, 0)
    assert set(dt) == set(dj) == set(tm.decode_state_spec()["dense_axes"])
    assert int(dt["pos"]) == 8 and tuple(kvt[0].shape) == (1, 16, 2, 16)
    np.testing.assert_array_equal(kvt[0].numpy(), np.asarray(kvj[0]))
    from repro_torch.serving.pool import PagePool
    pool = PagePool(4, 8, tm.n_groups, 2, 16, device="cpu")
    lg, dense = tm.prefill_page(tm.init_slots(1), pool.view(
        torch.tensor([[2, 0]], dtype=torch.int32)), _t(toks), 0)
    assert tuple(dense["m_h"].shape) == (3, 1, 16, 4, 8)
    assert int(dense["pos"]) == 0 and pool.k[:, 2].any()
    assert not pool.k[:, 1].any() and not pool.k[:, 3].any()
    assert torch.isfinite(lg).all()
