"""The port's MoE LMs (granite-moe-1b-a400m, moonshot-v1-16b-a3b) against
the reference package, on the CPU.

`repro_torch.models.moe.moe_ffn` beside `repro.models.moe.moe_ffn` on the
same numpy inputs, at three settings: the reduced config (4 experts,
top-2), the published expert counts at narrow width (32 experts top-8 and
64 top-6, d 64), and a router skewed onto one expert so that the capacity
drops pairs.  Each runs in the capacity case (2 x 24 tokens) and the
dropless one (48 x 1 tokens, decode).  Tolerances, and why:

- Routing.  With the router on a coarse power-of-two grid (x on a 2^-6
  grid, rw on 2^-4, |products summed| < 2^24 units) every fp32 sum is
  exact, so both packages' logits are bitwise equal.  The chosen experts,
  their slot positions and the drops must then be EQUAL, also on a planted
  exact tie (two equal router columns: the lower expert wins in both).
- Gates.  softmax differs only in `exp`, which XLA and PyTorch round
  differently on the CPU (an ulp apart on some arguments); with the
  reference's exps the port's formula gives the same bits.  A gate may so
  differ by a few ulps: at most 4.
- Output.  With the reference's gates put in place of the port's, the
  output is bitwise equal (the expert products are integer, and the
  combine adds each token's terms from 0.0 in ascending expert order, the
  order of the reference's scatter-add).  With the port's own gates it is
  within 2^-22 of max |y|.
- A random router (N(0, 0.02^2), as the init draws it) over 4096 tokens:
  its fp32 logits are sums in another order, so a token whose k-th and
  (k+1)-th logits are an ulp apart may pick another expert.  At most 0.5%
  of the tokens may hold another expert set (the count is printed).
- Gradients (jax.grad of <y, ct>).  wg, wu and wd: bitwise (qeinsum's
  bound in tests/test_torch_train.py: their error passes Q_E2, which the
  gates' ulps do not move here).  x and the router: through softmax's
  backward, the router product's and the gate's row dot, fp32 sums in
  another order: within 2^-18 of the largest magnitude (the qrmsnorm
  gradient bound of tests/test_torch_train.py).
- Serving: the engine's greedy tokens EQUAL the reference engine's, from
  the reference's weights, on monolithic and chunked prefill, with the
  fused and the unfused decode route.  Both configs' reduced() forms are
  one model (only the names differ), so each case's tokens are computed
  once and held for both names.

Training is tests/test_torch_moe_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.models import build_model as jbuild
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.optim import init_momentum as jinit_momentum
from repro.serving import make_engine as jmake_engine
from repro.serving import naive_serve as jnaive_serve
from repro_torch.configs import ARCHS, ArchConfig, get
from repro_torch.convert import momentum_from_jax, params_from_jax
from repro_torch.core import preset
from repro_torch.models import LMTransformer, build_model
from repro_torch.models import moe as M
from repro_torch.optim import flatten
from repro_torch.serving import Engine, make_engine, naive_serve

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

MOE = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# configs and layouts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MOE)
def test_configs_match_reference(name):
    """Every field of the port's ArchConfig, and dh, d_inner and
    vocab_padded, equal the reference's, in full and reduced() form."""
    assert name in ARCHS
    fields = [f.name for f in dataclasses.fields(ArchConfig)]
    for cfg, jcfg in ((get(name), jget(name)),
                      (get(name).reduced(), jget(name).reduced())):
        for f in fields + ["dh", "d_inner", "vocab_padded"]:
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
    assert get(name).reduced().moe_experts == 4
    assert get(name).reduced().moe_topk == 2


# published widths: (layers, d_model, heads, kv heads, head dim, d_ff,
# experts, vocab padded to 512)
WIDTHS = {"granite-moe-1b-a400m": (24, 1024, 16, 8, 64, 512, 32, 49664),
          "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 128, 1408, 64, 163840)}


@pytest.mark.parametrize("name", MOE)
def test_full_width_layouts(name):
    """The published layouts on the meta device (shapes only): the
    reference's `moe` subtree in place of w_gate / w_up / w_down, and the
    parameter count (granite-moe at full depth, ~1.39 G; moonshot at 2 of
    48 layers, as chip_smoke.py runs it, ~1.81 G)."""
    nl, d, h, kv, dh, f, e, vp = WIDTHS[name]
    depth = nl if name.startswith("granite") else 2
    model = build_model(get(name).replace(n_layers=depth), preset("full8"),
                        device="meta")
    assert isinstance(model, LMTransformer)
    shapes = {k: tuple(p.shape) for k, p in model.layers.items()}
    assert shapes == {"ln1": (depth, d), "wq": (depth, d, h * dh),
                      "wk": (depth, d, kv * dh), "wv": (depth, d, kv * dh),
                      "wo": (depth, h * dh, d), "ln2": (depth, d)}
    assert {k: tuple(p.shape) for k, p in model.moe.items()} == {
        "router": (depth, d, e), "wg": (depth, e, d, f),
        "wu": (depth, e, d, f), "wd": (depth, e, f, d)}
    per_layer = 2 * d + 2 * d * h * dh + 2 * d * kv * dh + d * e \
        + 3 * e * d * f
    assert model.n_params() == depth * per_layer + 2 * vp * d + d
    want = {"granite-moe-1b-a400m": 1.39e9, "moonshot-v1-16b-a3b": 1.81e9}
    assert abs(model.n_params() / want[name] - 1) < 0.01
    leaves = flatten(model.params())
    labels = flatten(model.labels())
    assert len(leaves) == len(labels) == 13
    assert sorted(model.params()["layers"]["moe"]) == ["router", "wd", "wg",
                                                       "wu"]


@pytest.mark.parametrize("name", MOE)
def test_params_from_jax_carries_the_moe_subtree(name):
    """The reference's init, carried by params_from_jax, loads into the
    port's model leaf for leaf in JAX flatten order (the `moe` subtree
    among them), with the same labels; momentum_from_jax carries the
    accumulator tree alike."""
    jcfg = jpreset("full8", "native")
    jm = jbuild(jget(name).reduced(), jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get(name).reduced(), preset("full8"), device="cpu")
    carried = params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(carried["layers"]["moe"]) == ["router", "wd", "wg", "wu"]
    tm.load_params(carried)
    leaves = jax.tree.leaves(params)
    assert len(flatten(tm.params())) == len(leaves) == 13
    for got, want in zip(flatten(tm.params()), leaves):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(params))
    jopt = jinit_momentum(params)
    acc = jax.tree.map(lambda a: np.asarray(a) + 1.0, jopt.acc)
    topt = momentum_from_jax(acc, step=3)
    assert topt.step == 3
    for got, want in zip(flatten(topt.acc), jax.tree.leaves(acc)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_uses_the_reference_fan_ins():
    """init draws the experts by winit with fan-in d (wg, wu) and f (wd),
    not E: their spread is 1/sqrt(fan-in), and the router's 0.02."""
    model = build_model(get("granite-moe-1b-a400m").replace(n_layers=1),
                        preset("full8"), device="cpu").init(0)
    d, f = model.a.d_model, model.a.d_ff
    for k, fan in (("wg", d), ("wu", d), ("wd", f)):
        std = float(model.moe[k].detach().std())
        assert abs(std * np.sqrt(fan) - 1) < 0.02, (k, std)
    assert abs(float(model.moe["router"].detach().std()) / 0.02 - 1) < 0.02


# --------------------------------------------------------------------------
# moe_ffn against the reference
# --------------------------------------------------------------------------

SETTINGS = {"reduced": ("granite-moe-1b-a400m", None, None),
            "granite32": ("granite-moe-1b-a400m", 32, 8),
            "moonshot64": ("moonshot-v1-16b-a3b", 64, 6),
            "skewed": ("granite-moe-1b-a400m", 32, 8)}


def _configs(setting):
    name, e, k = SETTINGS[setting]
    a, ja = get(name).reduced(), jget(name).reduced()
    if e:
        a = a.replace(moe_experts=e, moe_topk=k)
        ja = ja.replace(moe_experts=e, moe_topk=k)
    return a, ja


def _grid_w(r, shape, fan):
    """A weight on the k_WU grid, as winit draws it."""
    w = np.round(r.standard_normal(shape) / np.sqrt(fan) * 2 ** 23) / 2 ** 23
    return np.clip(w, -0.99, 0.99).astype(np.float32)


def _inputs(setting, dropless, seed=0):
    """(port config, reference config, expert weights, x): the router on a
    2^-4 grid with columns 1 and 3 equal (a planted tie in every token),
    x on a 2^-6 grid; "skewed" adds 4 to expert 0's logit of every token."""
    a, ja = _configs(setting)
    r = np.random.default_rng(seed + len(setting))
    d, f, e = a.d_model, a.d_ff, a.moe_experts
    rw = (r.integers(-8, 9, (d, e)) / 16).astype(np.float32)
    rw[:, 3] = rw[:, 1]
    p = {"router": rw, "wg": _grid_w(r, (e, d, f), d),
         "wu": _grid_w(r, (e, d, f), d), "wd": _grid_w(r, (e, f, d), f)}
    shape = (48, 1, d) if dropless else (2, 24, d)
    x = (r.integers(-127, 128, shape) / 64).astype(np.float32)
    if setting == "skewed":
        x[..., 0] = 1.0
        rw[0, 0] = 4.0
    return a, ja, p, x


def _ref_routing(ja, x2, rw, cap):
    """The reference's routing (repro/models/moe.py _moe_local's lines, in
    JAX): logits, top-k values and experts, slot positions."""
    logits = jnp.asarray(x2) @ jnp.asarray(rw)
    vals, idx = lax.top_k(logits, ja.moe_topk)
    e_flat = idx.reshape(-1)
    oh = jax.nn.one_hot(e_flat, ja.moe_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, e_flat[:, None],
                              axis=1)[:, 0]
    return (np.asarray(logits), np.asarray(vals), np.asarray(idx),
            np.asarray(pos).reshape(idx.shape))


def _ulps(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


def _reference_gates(monkeypatch):
    """Put the reference's softmax (jax.nn.softmax) in place of the port's
    gates, keeping the port's backward."""
    def gates(vals):
        sm = torch.softmax(vals, dim=-1)
        ref = _t(jax.nn.softmax(jnp.asarray(vals.detach().numpy()),
                                axis=-1))
        return ref + (sm - sm.detach())
    monkeypatch.setattr(M, "softmax_gates", gates)


CASES = [(s, dl) for s in SETTINGS for dl in (False, True)]


@pytest.mark.parametrize("setting,dropless", CASES)
def test_routing_equal_on_a_grid_router(setting, dropless):
    """Bitwise logits, then equal experts, slots, drops and tie order;
    gates within 4 ulp."""
    a, ja, p, x = _inputs(setting, dropless)
    x2 = x.reshape(-1, a.d_model)
    t = x2.shape[0]
    cap = M.capacity(a, t, dropless)
    logits, vals, idx, pos = _ref_routing(ja, x2, p["router"], cap)
    tl = _t(x2) @ _t(p["router"])
    np.testing.assert_array_equal(tl.numpy(), logits)
    tv, ti = M.top_k(tl, a.moe_topk)
    np.testing.assert_array_equal(ti.numpy(), idx)
    np.testing.assert_array_equal(tv.numpy(), vals)
    gates = M.softmax_gates(tv)
    jg = np.asarray(jax.nn.softmax(jnp.asarray(vals), axis=-1))
    assert _ulps(gates.numpy(), jg) <= 4
    r = M.route(ti, gates, a.moe_experts, cap)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    drops = int((pos >= cap).sum())
    assert int((r["slot"] == a.moe_experts * cap).sum()) == drops
    if dropless:
        assert cap == t * a.moe_topk and drops == 0
    else:
        assert cap == max(1, int(np.ceil(t * a.moe_topk / a.moe_experts
                                         * a.capacity_factor)))
    if setting == "skewed" and not dropless:
        assert drops > 0
    # the planted tie: experts 1 and 3 have equal logits in every token;
    # where only one of them is chosen, it is expert 1 in both packages
    assert (logits[:, 1] == logits[:, 3]).all()
    one = np.isin(idx, [1, 3]).sum(axis=1) == 1
    assert one.any()
    assert (np.isin(idx[one], [1]).any(axis=1)).all()
    # the inverse map: each kept pair's slot holds its token and its gate
    tk = np.repeat(np.arange(t), a.moe_topk).reshape(t, a.moe_topk)
    kept = r["slot"].numpy() < a.moe_experts * cap
    np.testing.assert_array_equal(r["tid"].numpy()[r["slot"].numpy()[kept]],
                                  tk[kept])
    np.testing.assert_array_equal(r["gbuf"].numpy()[r["slot"].numpy()[kept]],
                                  gates.numpy()[kept])
    print(f"{setting} dropless={dropless}: T {t}, cap {cap}, drops {drops} "
          f"of {t * a.moe_topk}, gate ulps "
          f"{_ulps(gates.numpy(), jg)}, boundary ties {int(one.sum())}")


@pytest.mark.parametrize("setting,dropless", CASES)
def test_moe_ffn_equals_reference(setting, dropless, exact_pow2,
                                  monkeypatch):
    """The output within 2^-22 of max |y| on the port's gates, and bitwise
    with the reference's gates in their place."""
    a, ja, p, x = _inputs(setting, dropless)
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    want = np.asarray(jax.jit(lambda x, p: jmoe_ffn(jcfg, ja, x, p))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    tp = {k: _t(v) for k, v in p.items()}
    got = M.moe_ffn(cfg, a, _t(x), tp).numpy()
    assert got.shape == want.shape == x.shape
    err = float(np.abs(got - want).max())
    print(f"{setting} dropless={dropless}: max |y - ref| {err:.3e} of max "
          f"|y| {float(np.abs(want).max()):.3e}")
    assert err <= 2.0 ** -22 * float(np.abs(want).max())
    _reference_gates(monkeypatch)
    np.testing.assert_array_equal(M.moe_ffn(cfg, a, _t(x), tp).numpy(), want)


@pytest.mark.parametrize("setting", ["reduced", "granite32", "moonshot64"])
def test_random_router_expert_sets(setting):
    """An init-like router over 4096 tokens: at most 0.5% of the tokens
    choose another expert set than the reference's."""
    a, ja = _configs(setting)
    r = np.random.default_rng(7)
    rw = (r.standard_normal((a.d_model, a.moe_experts)) * 0.02).astype(
        np.float32)
    x2 = r.standard_normal((4096, a.d_model)).astype(np.float32)
    _, _, idx, _ = _ref_routing(ja, x2, rw, 1)
    _, ti = M.top_k(_t(x2) @ _t(rw), a.moe_topk)
    differ = int((np.sort(ti.numpy(), 1) != np.sort(idx, 1)).any(1).sum())
    print(f"{setting}: tokens with another expert set {differ} of 4096")
    assert differ <= 0.005 * 4096


@pytest.mark.parametrize("setting,dropless", CASES)
def test_moe_ffn_grads(setting, dropless, exact_pow2):
    """jax.grad of <moe_ffn(x), ct> against the port's autograd: the expert
    weights bitwise, x and the router within 2^-18 of the largest
    magnitude."""
    a, ja, p, x = _inputs(setting, dropless)
    jcfg, cfg = jpreset("full8", "native"), preset("full8")
    ct = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)

    def jf(x, p):
        return jnp.sum(jmoe_ffn(jcfg, ja, x, p) * ct)

    jgx, jgp = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    (M.moe_ffn(cfg, a, tx, tp) * _t(ct)).sum().backward()
    for k in ("wg", "wu", "wd"):
        np.testing.assert_array_equal(tp[k].grad.numpy(), np.asarray(jgp[k]))
    for k, got, want in (("x", tx.grad, jgx), ("router", tp["router"].grad,
                                               jgp["router"])):
        want = np.asarray(want)
        rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        print(f"{setting} dropless={dropless}: grad {k} rel {rel:.3e} "
              f"(bound 2^-18 = {2.0 ** -18:.3e})")
        assert rel <= 2.0 ** -18


def test_expert_parallel_refuses():
    a, _, p, x = _inputs("reduced", False)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        M.moe_ffn(preset("full8"), a, _t(x), {k: _t(v) for k, v in p.items()},
                  tp_size=2)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

KW = dict(max_lanes=2, page_size=8, max_ctx=32)
PROMPT_LENS = (13, 21, 6)   # a ragged tail, more pages than one, a reuse
NEW = 4


_SERVED: dict = {}


def _served(name, mode, fuse):
    """(the reference engine's greedy tokens, the port's from the same
    weights, the port's completed count) for 3 prompts on 2 lanes (a lane
    is reused), once per reduced model (both names give one model)."""
    key = (dataclasses.replace(get(name).reduced(), name="", source=""),
           mode, fuse)
    if key not in _SERVED:
        jeng = jmake_engine(name, mode="native", reduced=True, seed=0,
                            prefill_mode=mode, fuse_kernels=fuse, **KW)
        r = np.random.default_rng(21)
        prompts = [r.integers(0, 128, n).astype(np.int32)
                   for n in PROMPT_LENS]
        rids = [jeng.submit(p, NEW) for p in prompts]
        out = jeng.drain()
        want = [out[i] for i in rids]
        tm = build_model(get(name).reduced(), preset("full8").replace(
            fuse_kernels=fuse), device="cpu")
        tm.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                    jeng.params)))
        eng = Engine(tm, prefill_mode=mode, **KW)
        rids = [eng.submit(p, NEW) for p in prompts]
        out = eng.drain()
        _SERVED[key] = (want, [out[i] for i in rids],
                        eng.metrics()["completed"])
    return _SERVED[key]


def test_reduced_configs_are_one_model():
    """granite-moe-1b-a400m and moonshot-v1-16b-a3b differ in reduced()
    form only by name and source, in both packages."""
    a, b = (get(n).reduced() for n in MOE)
    assert a.replace(name="", source="") == b.replace(name="", source="")
    ja, jb = (jget(n).reduced() for n in MOE)
    assert ja.replace(name="", source="") == jb.replace(name="", source="")


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
@pytest.mark.parametrize("fuse", [True, False])
def test_engine_tokens_equal_reference(name, mode, fuse, exact_pow2):
    """Greedy tokens of the reduced engine equal the reference engine's,
    from the reference's weights, in both prefill modes and both decode
    routes (3 prompts on 2 lanes: a lane is reused)."""
    want, got, completed = _served(name, mode, fuse)
    assert got == want
    assert completed == len(PROMPT_LENS)


def test_make_engine_and_naive_serve(exact_pow2):
    """make_engine builds the MoE engine and serves; naive_serve (prefill
    on a dense cache, then serve_step, one request at a time) gives the
    reference's naive_serve tokens from the same weights."""
    eng = make_engine("granite-moe-1b-a400m", device="cpu", **KW)
    r = np.random.default_rng(3)
    traffic = [{"prompt": r.integers(0, 128, n).astype(np.int32),
                "max_new": NEW} for n in PROMPT_LENS]
    rids = [eng.submit(t["prompt"], NEW) for t in traffic]
    out = eng.drain()
    assert all(len(out[i]) == NEW for i in rids)
    jm = jbuild(jget("granite-moe-1b-a400m").reduced(),
                jpreset("full8", "native"))
    params = jm.init(jax.random.PRNGKey(0))
    want, _ = jnaive_serve(jm, params, traffic)
    tm = build_model(get("granite-moe-1b-a400m").reduced(), preset("full8"),
                     device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    toks, met = naive_serve(tm, traffic)
    assert toks == [list(map(int, t)) for t in want]
    assert met["generated_tokens"] == NEW * len(PROMPT_LENS)
