"""The port's encoder-decoder (seamless-m4t-large-v2) against the reference
package's `repro.models.encdec.EncDec`, on the CPU, at the reduced config
(2 encoder + 2 decoder layers, d 64, 4 heads on 2 KV heads of 16, FFN 96,
vocab 128, chunks 16), from the reference's init carried by
`encdec_params_from_jax`, on numpy inputs from a seed (2 sequences of 64
frames, 16 target tokens).  Training is tests/test_torch_encdec_train.py.

Tolerances, and why:

- gelu.  `jax.nn.gelu` (approximate) and its `jax.grad`, written out in
  JAX's order.  They are not bitwise on the CPU: XLA's tanh and
  PyTorch's differ by a few ulps (near -1 one gives -1 where the other
  gives -1 + 2^-24), and XLA's CPU compiler contracts x + a * x^3 into
  one fused multiply-add, which PyTorch's separate ops round twice.  So
  the value is within 2 and the derivative within 8 units of 2^-23 *
  max(1, |x|) (measured 1.99 and 6.57); after Q_A a payload may move by
  one code, on at most 0.1% of the elements.
- The LayerNorm (K4 kind "layer").  The port takes a row's sum and sum of
  squares in float64, rounded once (so the kernel and its plain version
  agree on the card); the reference sums in fp32.  A row whose sigma or mu
  sits near a k_sigma / k_mu grid edge may so land one step away: on the
  encoder's activations at most 5% of the rows differ, each element by at
  most 2^-10 of its row's largest magnitude (`ubn_rows_ok`; measured 1
  row of 256 at the second encoder layer).  That row then differs after
  every later product (attention mixes it into every row), so natively:
    encode: measured 33.4% of the elements apart, by at most 0.95% of
      max |y|; bound 50% and 2^-5 of max |y|;
    cross K/V (the int8 cache): measured 4.9% of the payloads apart, by
      at most 16 codes; bound 10% and 32 codes;
    loss: measured 1.05e-4 relative; bound 2e-3;
  and greedy tokens part where two logits sit within the gap (the second
  lane's first token does here: logits 1.2e-2 apart).  With the port's
  float64 statistics put in place of the reference's (`port_layer_stats`,
  the way tests/test_torch_moe.py puts the reference's gates into the
  port) encode, the cross K/V, and the greedy tokens and logits of
  `prefill` + 6 `serve_step`s on 2 lanes are bitwise equal, and the loss
  within one ulp (its logsumexp and mean sum in another order).
- sim and fp32 (the unfused LayerNorm body in fp32 on both sides): the
  greedy tokens of `prefill` + 6 `serve_step`s EQUAL the reference's with
  no patch; sim's logits are bitwise, fp32's within 2^-16 (fp32 products
  summed in another order).
"""
import contextlib
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as JE
from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.core import qact as jqact
from repro.core import qlayernorm as jqlayernorm
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS, ArchConfig, get
from repro_torch.convert import encdec_params_from_jax
from repro_torch.core import preset, qact, qlayernorm
from repro_torch.kernels import ref as tref
from repro_torch.models import EncDec, LMTransformer, build_model
from repro_torch.optim import flatten
from repro_torch.serving import make_engine

from torch_parity import exact_pow2_patched, ubn_rows_ok

tqdense = importlib.import_module("repro_torch.core.qdense")

NAME = "seamless-m4t-large-v2"
S, B, STEPS = 64, 2, 6               # frames, lanes, decode steps
T = S // 4                           # target positions (tgt_ratio 4)


@pytest.fixture(autouse=True, scope="module")
def _module_setup():
    """One intra-op thread, as in test_torch_resnet.py (the reduced model
    runs many tiny ops, whose thread pools wait on the other workers'),
    and the reference's pow2 helpers made exact (torch_parity.exact_pow2)
    for the whole module, so its traces and results are made once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with exact_pow2_patched():
        yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def port_layer_stats():
    """The reference's LayerNorm (its XLA oracle of the UBN kernel, kind
    "layer") replaced by the port's plain version (`ref.ubn_norm`, float64
    sums rounded once) through a host callback; rms and batch unchanged."""
    import repro.kernels.ref as kref
    real = kref.ubn_norm_ref

    def patched(x, gamma, beta, *, kind, **kw):
        if kind != "layer":
            return real(x, gamma, beta, kind=kind, **kw)

        def host(x, g, b):
            return tref.ubn_norm(*(torch.from_numpy(np.array(t))
                                   for t in (x, g, b)),
                                 kind=kind, **kw).numpy()
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(x.shape, jnp.float32), x, gamma, beta)

    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kref, "ubn_norm_ref", patched)
            yield
    finally:
        jax.clear_caches()


@functools.cache
def _params():
    """The reference's init (full8's k_WU grid, jitted), drawn once: every
    mode's models start from it (fp32 weights may sit on a grid)."""
    jm = jbuild(jget(NAME).reduced(), jpreset("full8", "native"))
    return jax.jit(jm.init)(jax.random.PRNGKey(0))


def _models(mode="native"):
    """(reference model, its params, the port's EncDec holding them), made
    once per mode (no test changes the parameters)."""
    return _models_of(mode)


@functools.cache
def _models_of(mode: str):
    jm = jbuild(jget(NAME).reduced(), jpreset("full8", mode))
    tm = build_model(get(NAME).reduced(), preset("full8", mode),
                     device="cpu")
    tm.load_params(encdec_params_from_jax(jax.tree.map(np.asarray,
                                                       _params())))
    return jm, _params(), tm


def _frames(seed=0, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, S, 64)).astype(np.float32)


def _batch(seed=0):
    toks = np.random.default_rng(seed + 1).integers(0, 128, (B, T + 1))
    return {"frames": _frames(seed), "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# configs, layouts, parameters
# --------------------------------------------------------------------------


def test_config_matches_reference():
    """Every field the port keeps, and dh and vocab_padded, equal the
    reference's, in full and reduced() form."""
    assert NAME in ARCHS
    fields = [f.name for f in dataclasses.fields(ArchConfig)]
    for cfg, jcfg in ((get(NAME), jget(NAME)),
                      (get(NAME).reduced(), jget(NAME).reduced())):
        for f in fields + ["dh", "vocab_padded"]:
            assert getattr(cfg, f) == getattr(jcfg, f), f
    a = get(NAME)
    assert (a.enc_layers, a.dec_layers, a.d_model, a.n_heads, a.n_kv, a.dh,
            a.d_ff, a.vocab_padded, a.norm, a.act, a.tgt_ratio) == \
        (24, 24, 1024, 16, 16, 64, 8192, 256512, "layernorm", "gelu", 4)


def test_full_width_layout_on_meta():
    """The published model, every width at full depth (24 + 24 layers;
    chip_smoke.py runs 12 + 12 of them), on the meta device (shapes
    only): 1.63 G parameters."""
    model = build_model(get(NAME), preset("full8"), device="meta")
    assert isinstance(model, EncDec)
    d, f, vp = 1024, 8192, 256512
    att = {"ln_g": (d,), "ln_b": (d,), "wq": (d, d), "wk": (d, d),
           "wv": (d, d), "wo": (d, d)}
    mlp = {"mlp_ln_g": (d,), "mlp_ln_b": (d,), "w_up": (d, f),
           "w_down": (f, d)}
    assert {k: tuple(p.shape) for k, p in model.enc.items()} == \
        {k: (24,) + s for k, s in {**att, **mlp}.items()}
    assert {k: tuple(p.shape) for k, p in model.dec.items()} == \
        {k: (24,) + s for k, s in {**att, **{"x_" + k: s for k, s in
                                             att.items()}, **mlp}.items()}
    enc = 4 * d * d + 2 * d * f + 4 * d
    dec = 8 * d * d + 2 * d * f + 6 * d
    assert model.n_params() == 24 * (enc + dec) + 2 * vp * d + 2 * d
    assert round(model.n_params() / 1e9, 2) == 1.63


def test_params_from_jax_carries_each():
    """The reference's init, carried by encdec_params_from_jax, loads into
    the port leaf for leaf in JAX flatten order; labels() matches."""
    jm, params, tm = _models()
    leaves = jax.tree.leaves(params)
    assert len(flatten(tm.params())) == len(leaves) == 30
    for got, want in zip(flatten(tm.params()), leaves):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(params))


def test_tp_size_2_raises():
    """Both packages refuse tensor parallelism with the same message."""
    acfg = jget(NAME).reduced()
    with pytest.raises(ValueError) as want:
        jbuild(acfg, jpreset("full8", "native"), tp_size=2)
    with pytest.raises(ValueError) as got:
        EncDec(get(NAME).reduced(), preset("full8"), device="cpu", tp_size=2)
    assert str(got.value) == str(want.value)


def test_make_engine_refuses_encdec():
    """The engine serves decoder-only LMs (the reference's EncDec has no
    paged_decode_step either): make_engine names the enc-dec's own path
    before it builds anything; LMTransformer still refuses the family."""
    with pytest.raises(NotImplementedError,
                       match="EncDec.prefill.*serve_step"):
        make_engine(NAME, device="cpu")
    with pytest.raises(NotImplementedError, match="does not build"):
        LMTransformer(get(NAME).reduced(), preset("full8"), device="meta")


# --------------------------------------------------------------------------
# gelu and the LayerNorm
# --------------------------------------------------------------------------


def _gelu_inputs():
    r = np.random.default_rng(3)
    return np.concatenate([r.standard_normal(50000).astype(np.float32) * 3,
                           np.linspace(-10, 10, 20001, dtype=np.float32)])


def test_gelu_within_ulps_and_qact_flips():
    """PyTorch's own tanh: value within 2, derivative within 8 units of
    2^-23 * max(1, |x|); Q_A(gelu) payloads at most one code apart on at
    most 0.1% of the elements, on the same Q_A step."""
    x = _gelu_inputs()
    unit = 2.0 ** -23 * np.maximum(1.0, np.abs(x))
    fn, dfn = tqdense._ACT["gelu"]
    want = np.asarray(jax.jit(jax.nn.gelu)(x), np.float64)
    dwant = np.asarray(jax.jit(lambda x: jax.grad(
        lambda t: jax.nn.gelu(t).sum())(x))(x), np.float64)
    gap = np.abs(fn(torch.from_numpy(x)).numpy() - want) / unit
    dgap = np.abs(dfn(torch.from_numpy(x)).numpy() - dwant) / unit
    print(f"gelu: {gap.max():.2f} units (bound 2), derivative "
          f"{dgap.max():.2f} (bound 8)")
    assert gap.max() <= 2 and dgap.max() <= 8
    cfg, jcfg = preset("full8"), jpreset("full8", "native")
    for scale in (0.5, 3.0):          # an MLP's pre-activations, two ranges
        u = (np.random.default_rng(4).standard_normal((256, 96)) * scale
             ).astype(np.float32)
        jq = jax.jit(lambda u: jqact(jcfg, "gelu", u))(u)
        tq = qact(cfg, "gelu", torch.from_numpy(u))
        assert float(tq.scale) == float(jq.scale)
        d = np.abs(tq.data.numpy().astype(np.int32)
                   - np.asarray(jq.data, np.int32))
        print(f"Q_A(gelu) at scale {scale}: payloads apart "
              f"{np.mean(d > 0):.5f} (bound 0.001), max {d.max()}")
        assert d.max() <= 1 and np.mean(d > 0) <= 1e-3


def test_layernorm_rows_on_encoder_activations():
    """K4 kind "layer" (its plain version on the CPU) against the
    reference's qlayernorm on the encoder's second-layer input: within
    `ubn_rows_ok` (float64 sums against fp32 ones)."""
    jm, params, tm = _models()
    jcfg, cfg = jm.q, tm.q
    pos = jnp.arange(S)
    lp0 = jax.tree.map(lambda t: t[0], params["enc"])
    lp1 = jax.tree.map(lambda t: t[1], params["enc"])
    x1 = jax.jit(lambda x: JE._mlp_block(jcfg, jm.a, lp0, JE._attn(
        jcfg, jm.a, lp0, x, None, causal=False, q_pos=pos, k_pos=pos)[0]))(
        _frames(0, 4))
    for g, b in (("ln_g", "ln_b"), ("mlp_ln_g", "mlp_ln_b")):
        want = np.asarray(jax.jit(lambda x: jqlayernorm(
            jcfg, x, lp1[g], lp1[b]))(x1)).reshape(-1, 64)
        got = qlayernorm(cfg, torch.from_numpy(np.asarray(x1)),
                         torch.from_numpy(np.asarray(lp1[g])),
                         torch.from_numpy(np.asarray(lp1[b]))).reshape(-1, 64)
        rows = int((got.numpy() != want).any(axis=1).sum())
        print(f"LayerNorm {g}: rows apart {rows} of {want.shape[0]}")
        ubn_rows_ok(got.numpy(), want)


# --------------------------------------------------------------------------
# encode, cross K/V, loss; prefill and serve_step
# --------------------------------------------------------------------------


def _reference(mode="native", port_stats=False):
    """The reference's tokens and logits of prefill + STEPS greedy
    serve_steps from token 0 on B lanes, and in native mode its encode,
    prefill cache and loss on `_frames()` / `_batch()` (with the port's
    LayerNorm statistics when `port_stats`), made once."""
    return _reference_run(mode, port_stats)


@functools.cache
def _reference_run(mode: str, port_stats: bool) -> dict:
    forward = mode == "native"
    jm, params, _ = _models(mode)
    frames = jnp.asarray(_frames())
    with port_layer_stats() if port_stats else contextlib.nullcontext():
        cache = jax.jit(lambda p, f: jm.prefill(p, f, T))(params, frames)
        out = {"cache": jax.tree.map(np.asarray, cache)}
        if forward:
            out["encode"] = np.asarray(jax.jit(jm.encode)(params, frames))
            out["loss"] = float(jax.jit(lambda p, b: jm.loss(p, b)[0])(
                params, jax.tree.map(jnp.asarray, _batch())))
        step = jax.jit(jm.serve_step)
        tok, out["tokens"], out["logits"] = np.zeros(B, np.int32), [], []
        for _ in range(STEPS):
            cache, lg = step(params, cache, jnp.asarray(tok))
            tok = np.asarray(lg)[:, :128].argmax(-1).astype(np.int32)
            out["tokens"].append(tok.tolist())
            out["logits"].append(np.asarray(lg))
    return out


def _port(mode="native"):
    """The port's (encode, prefill cache, loss) on the same inputs."""
    tm = _models(mode)[2]
    frames = _frames()
    with torch.no_grad():
        return tm.encode(frames), tm.prefill(frames, T), tm.loss(_batch())[0]


def _greedy(mode="native", port_stats=False):
    """The port's prefill + STEPS greedy serve_steps beside the
    reference's: (reference tokens, port tokens, the largest logit gap over
    the steps whose tokens so far agree)."""
    tm, want = _models(mode)[2], _reference(mode, port_stats)
    cache = tm.prefill(_frames(), T)
    tok, got, gap = torch.zeros(B, dtype=torch.int32), [], 0.0
    for i in range(STEPS):
        cache, lg = tm.serve_step(cache, tok)
        if got == want["tokens"][:i]:
            gap = max(gap, float(np.abs(want["logits"][i]
                                        - lg.numpy()).max()))
        tok = lg[:, :128].argmax(-1).to(torch.int32)
        got.append(tok.tolist())
    assert [int(p) for p in cache["pos"]] == [STEPS] * B
    return want["tokens"], got, gap


def test_encode_cross_kv_loss_native_within_bounds():
    """Native, unpatched: the encoder's output, the int8 cross K/V and the
    loss within the LayerNorm statistics' bounds (module docstring)."""
    want = _reference()
    te, tc, tl = _port()
    je, te = want["encode"], _np(te)
    d = np.abs(je - te)
    print(f"encode: apart {np.mean(d > 0):.4f} (bound 0.5), max "
          f"{d.max() / np.abs(je).max():.5f} of max |y| (bound 2^-5)")
    assert np.mean(d > 0) <= 0.5 and d.max() <= 2.0 ** -5 * np.abs(je).max()
    for k in ("xk", "xv"):
        c = np.abs(want["cache"][k].astype(np.int32)
                   - _np(tc[k]).astype(np.int32))
        print(f"{k}: payloads apart {np.mean(c > 0):.4f} (bound 0.1), max "
              f"{c.max()} codes (bound 32)")
        assert np.mean(c > 0) <= 0.1 and c.max() <= 32
    rel = abs(float(tl) - want["loss"]) / want["loss"]
    print(f"loss: {want['loss']:.6f} against {float(tl):.6f}, rel "
          f"{rel:.2e} (bound 2e-3)")
    assert rel <= 2e-3


def test_encode_cross_kv_loss_bitwise_with_port_stats():
    """With the port's LayerNorm statistics in the reference: encode and
    the int8 cross K/V bitwise equal, the loss within one ulp."""
    want = _reference(port_stats=True)
    te, tc, tl = _port()
    np.testing.assert_array_equal(_np(te), want["encode"])
    for k in ("xk", "xv", "x_scale", "k_scale"):
        np.testing.assert_array_equal(_np(tc[k]), want["cache"][k])
    gap = abs(float(tl) - want["loss"])
    print(f"loss: {want['loss']:.9f} against {float(tl):.9f}")
    assert gap <= np.spacing(np.float32(want["loss"]))


def test_greedy_tokens_native_with_port_stats():
    """prefill + 6 greedy serve_steps on 2 lanes, native, with the port's
    LayerNorm statistics in the reference: tokens and logits bitwise equal.
    Unpatched, the tokens part where two logits sit within the LayerNorm
    gap (printed, not held)."""
    want, got, gap = _greedy(port_stats=True)
    assert got == want and gap == 0.0
    want0, got0, gap0 = _greedy()
    print(f"unpatched: reference {want0}, port {got0}, largest logit gap "
          f"while the tokens agree {gap0:.3e}")


@pytest.mark.parametrize("mode,bound", [("sim", 0.0), ("fp32", 2.0 ** -16)])
def test_greedy_tokens_sim_fp32(mode, bound):
    """sim and fp32, unpatched: the same greedy tokens as the reference's;
    logits bitwise (sim) or within 2^-16 (fp32)."""
    want, got, gap = _greedy(mode)
    print(f"{mode}: tokens {got}, largest logit gap {gap:.3e}")
    assert got == want and gap <= bound
