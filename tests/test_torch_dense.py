"""The four dense LMs the reference registers beside granite-3-8b
(granite-34b, phi4-mini-3.8b, minitron-4b and chameleon-34b, family
"vlm") in the port, against the reference package, on the CPU.

Their configs equal the reference's field by field, in full and reduced()
form.  At full width the layouts are checked on the meta device (shapes
only).  Reduced, they go through the same LMTransformer as granite-3-8b:
the reference's weights (`params_from_jax`) give the reference engine's
greedy tokens, equal, on the default monolithic prefill (and granite-34b
on chunked prefill too).  One reduced granite-34b step (MQA: 4 query
heads on 1 KV head) beside the reference's `make_train_step` stays within
the LM slice's step-1 bounds of tests/test_torch_train.py: the loss
within 2e-3 relative, at most 0.1% of the hidden weights' k_WU-grid codes
differing, by at most 26 codes (one CQ step times the learning rate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import init_momentum as jinit_momentum
from repro.serving import make_engine as jmake_engine
from repro_torch.configs import ARCHS, ArchConfig, get
from repro_torch.convert import momentum_from_jax, params_from_jax
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.launch import train as ttrain
from repro_torch.models import LMTransformer, build_model
from repro_torch.optim import flatten
from repro_torch.serving import Engine

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

DENSE = ("granite-34b", "phi4-mini-3.8b", "minitron-4b", "chameleon-34b")
# published widths: (d_model, heads, kv heads, d_ff, vocab padded to 512)
WIDTHS = {"granite-34b": (6144, 48, 1, 24576, 49152),
          "phi4-mini-3.8b": (3072, 24, 8, 8192, 200192),
          "minitron-4b": (3072, 24, 8, 9216, 256000),
          "chameleon-34b": (8192, 64, 8, 22016, 65536)}


@pytest.mark.parametrize("name", DENSE)
def test_configs_match_reference(name):
    """Every field of the port's ArchConfig, and dh, d_inner and
    vocab_padded, equal the reference's, in full and reduced() form."""
    assert name in ARCHS
    fields = [f.name for f in dataclasses.fields(ArchConfig)]
    for cfg, jcfg in ((get(name), jget(name)),
                      (get(name).reduced(), jget(name).reduced())):
        for f in fields + ["dh", "d_inner", "vocab_padded"]:
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)


@pytest.mark.parametrize("name", DENSE)
def test_full_width_layouts_at_cut_depth(name):
    """chip_smoke.py's dense models: every published width, 2 layers, on
    the meta device (shapes only, no storage)."""
    d, h, kv, f, vp = WIDTHS[name]
    model = build_model(get(name).replace(n_layers=2), preset("full8"),
                        device="meta")
    assert isinstance(model, LMTransformer)
    shapes = {k: tuple(p.shape) for k, p in model.layers.items()}
    assert shapes == {"ln1": (2, d), "wq": (2, d, h * 128),
                      "wk": (2, d, kv * 128), "wv": (2, d, kv * 128),
                      "wo": (2, h * 128, d), "ln2": (2, d),
                      "w_gate": (2, d, f), "w_up": (2, d, f),
                      "w_down": (2, f, d)}
    assert tuple(model.embed.shape) == (vp, d)
    assert tuple(model.lm_head.shape) == (d, vp)
    per_layer = 2 * d + 2 * d * h * 128 + 2 * d * kv * 128 + 3 * d * f
    assert model.n_params() == 2 * per_layer + 2 * vp * d + d


@pytest.mark.parametrize("family", ["hybrid", "encdec"])
def test_lm_transformer_refuses_other_families(family):
    """LMTransformer builds the lm, vlm and moe families only; build_model
    gives the hybrid its Zamba2 (tests/test_torch_hybrid.py) and the
    enc-dec its EncDec (tests/test_torch_encdec.py), and the config
    registry refuses only unknown names."""
    acfg = get("granite-34b").reduced().replace(family=family)
    with pytest.raises(NotImplementedError, match="does not build"):
        LMTransformer(acfg, preset("full8"), device="meta")
    with pytest.raises(KeyError, match="unknown arch"):
        get("granite-35b")


@pytest.mark.parametrize("name", DENSE)
def test_params_from_jax_carries_each(name):
    """The reference's init, carried by params_from_jax, loads into the
    port's model leaf for leaf, in JAX flatten order."""
    jm = jbuild(jget(name).reduced(), jpreset("full8", "native"))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get(name).reduced(), preset("full8"), device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    leaves = jax.tree.leaves(params)
    assert len(flatten(tm.params())) == len(leaves)
    for got, want in zip(flatten(tm.params()), leaves):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert flatten(tm.labels()) == jax.tree.leaves(jm.labels(params))


KW = dict(max_lanes=2, page_size=8, max_ctx=32)
PROMPT_LENS = (13, 21)    # a ragged tail and more pages than one lane's
NEW = 4


@pytest.mark.parametrize("name,mode", [(n, "monolithic") for n in DENSE]
                         + [("granite-34b", "chunked")])
def test_reduced_engine_tokens_equal_reference(name, mode, exact_pow2):
    """Greedy tokens of the reduced engine equal the reference engine's,
    from the reference's weights: each config on the default monolithic
    prefill, and granite-34b's single KV head also through chunked
    prefill's paged attention."""
    jeng = jmake_engine(name, mode="native", reduced=True, seed=0,
                        prefill_mode=mode, **KW)
    r = np.random.default_rng(12)
    prompts = [r.integers(0, 128, n).astype(np.int32) for n in PROMPT_LENS]
    rids = [jeng.submit(p, NEW) for p in prompts]
    out = jeng.drain()
    want = [out[i] for i in rids]
    tm = build_model(get(name).reduced(), preset("full8"), device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    eng = Engine(tm, prefill_mode=mode, **KW)
    rids = [eng.submit(p, NEW) for p in prompts]
    out = eng.drain()
    assert [out[i] for i in rids] == want
    assert eng.metrics()["completed"] == len(PROMPT_LENS)


HIDDEN = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def test_granite_34b_step_within_bounds(exact_pow2):
    """One reduced granite-34b step (n_kv 1) of both packages' make_train_step
    from the same weights: within the LM slice's step-1 bounds."""
    acfg = jget("granite-34b").reduced()
    assert acfg.n_kv == 1
    jcfg = jpreset("full8", "native")
    jm = jbuild(acfg, jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
    cfg = preset("full8")
    tm = build_model(get("granite-34b").reduced(), cfg, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    batch = TokenTask(acfg.vocab, 32, 4).batch(0)
    params, jopt, met = jstep(params, jopt, jax.tree.map(jnp.asarray, batch),
                              jnp.int32(0))
    loss = float(ttrain.make_train_step(tm, cfg, lr=0.05)(topt, batch, 0)[
        "loss"])
    rel = abs(loss - float(met["loss"])) / float(met["loss"])

    def codes(get_w):
        return np.concatenate([np.asarray(get_w(k), np.float64).ravel()
                               * 2 ** 23 for k in HIDDEN])

    d = np.abs(codes(lambda k: params["layers"][k])
               - codes(lambda k: tm.layers[k].detach().numpy()))
    print(f"granite-34b step 1: loss rel {rel:.3e}, codes differing "
          f"{np.mean(d > 0):.5f}, max distance {d.max():.0f}")
    assert rel <= 2e-3
    assert np.mean(d > 0) <= 1e-3 and d.max() <= 26
