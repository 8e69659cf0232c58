"""The port's sim and fp32 modes in the models and the serving engine.

Same reference weights (carried by convert.py) through `repro`'s engine
and `repro_torch`'s (device="cpu", plain versions).  Tolerances:

  Greedy tokens of the sim and fp32 engines equal the reference engine's
     in the same mode: the dense LM and Mamba1, on monolithic and chunked
     prefill, 2 prompts on 2 lanes.
  The routes: a sim or fp32 training step and a served request call none
     of K1 (qmatmul), K3 (dgrad / wgrad), K4 (ubn_norm), K5
     (flash_attention) or K6 (paged_attention); sim steps call K2
     (quantize) for Q_A and Q_W, an fp32 step calls none, every mode's
     serving calls K2 for the int8 KV writes and a paged decode gathers
     its pages (K7; fp32 Mamba1 has no int8 state, so no K2); the SSM's
     scan is K9 / K9b in every mode.  Counted by spies on `ops`.
  fused_decode_active: False off native mode.
  The radix cache and defrag in sim mode: the tokens of the run without.
  sim against native in the port: the reduced LM's loss within 5e-4
     relative and a prefill's logits within 2^-10 of the largest (the
     norms' statistics and the attention's sums run in another order in
     the unfused bodies than in K4 and K5; measured 1.1e-4 on the port's
     init, where the reference's own sim / native gap on its init is
     3.5e-5).
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving import make_engine as jmake_engine
from repro_torch.configs import get
from repro_torch.convert import params_from_jax, ssm_params_from_jax
from repro_torch.core import preset
from repro_torch.data import ImageTask, TokenTask
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import init_momentum
from repro_torch.serving import Engine, make_engine
from repro_torch.serving.engine import fused_decode_active

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

KW = dict(max_lanes=2, page_size=8, max_ctx=40)
PROMPT_LENS = (13, 21)
NEW = 5


def _cfg(mode):
    return preset("full8", mode)


def _serve(engine, prompts, new=NEW):
    rids = [engine.submit(p, new) for p in prompts]
    out = engine.drain()
    return [out[r] for r in rids]


def _prompts(seed=12, lens=PROMPT_LENS):
    r = np.random.default_rng(seed)
    return [r.integers(0, 128, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("prefill", ["monolithic", "chunked"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "falcon-mamba-7b"])
@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_engine_tokens_equal_reference(mode, arch, prefill, exact_pow2):
    jeng = jmake_engine(arch, mode=mode, reduced=True, seed=0,
                        prefill_mode=prefill, **KW)
    prompts = _prompts()
    want = _serve(jeng, prompts)
    tm = build_model(get(arch).reduced(), _cfg(mode), device="cpu")
    conv = ssm_params_from_jax if arch == "falcon-mamba-7b" \
        else params_from_jax
    tm.load_params(conv(jax.tree.map(np.asarray, jeng.params)))
    assert _serve(Engine(tm, prefill_mode=prefill, **KW), prompts) == want


# --------------------------------------------------------------------------
# the routes each mode takes
# --------------------------------------------------------------------------

KERNELS = ("qmatmul", "quantize", "dgrad", "wgrad", "ubn_norm",
           "flash_attention", "paged_attention", "page_gather",
           "selective_scan", "selective_scan_bwd")
NATIVE_ONLY = ("qmatmul", "dgrad", "wgrad", "ubn_norm", "flash_attention",
               "paged_attention")


@pytest.fixture
def calls(monkeypatch):
    """Spies on every kernel's wrapper in `ops`: the dict counts calls."""
    counts = dict.fromkeys(KERNELS, 0)

    def spy(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in KERNELS:
        monkeypatch.setattr(ops, name, spy(name, getattr(ops, name)))
    return counts


def _train_step(arch, mode):
    acfg = get(arch).reduced()
    tm = build_model(acfg, _cfg(mode), device="cpu").init(0)
    task = ImageTask(acfg.img_size, acfg.num_classes, 4) \
        if acfg.family == "resnet" else TokenTask(acfg.vocab, 16, 2)
    step = ttrain.make_train_step(tm, _cfg(mode), lr=0.05)
    met = step(init_momentum(tm.params()), task.batch(0), 0)
    assert np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b", "resnet50"])
@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_modes_route_off_the_native_kernels(mode, arch, calls):
    _train_step(arch, mode)
    train = dict(calls)
    assert not any(train[k] for k in NATIVE_ONLY), train
    assert (train["quantize"] > 0) == (mode == "sim"), train
    ssm = arch == "falcon-mamba-7b"
    assert (train["selective_scan"] > 0) == ssm
    assert (train["selective_scan_bwd"] > 0) == ssm
    if arch == "resnet50":
        return
    for prefill in ("monolithic", "chunked"):
        calls.update(dict.fromkeys(KERNELS, 0))
        eng = make_engine(arch, mode=mode, reduced=True, device="cpu",
                          prefill_mode=prefill, **KW)
        toks = _serve(eng, _prompts(lens=(13, 9)))
        assert all(len(t) == NEW for t in toks)
        assert not any(calls[k] for k in NATIVE_ONLY), calls
        assert (calls["quantize"] > 0) == (mode == "sim" or not ssm)
        assert (calls["page_gather"] > 0) == (not ssm)
        assert (calls["selective_scan"] > 0) == ssm


@pytest.mark.parametrize("mode", ["fp32", "sim", "native"])
def test_fused_decode_active_only_in_native(mode, calls):
    """The route fused_decode_active names is the one a decode step takes:
    K6 in native (with fuse_kernels), gather-then-attend (K7) otherwise."""
    eng = make_engine("granite-3-8b", mode=mode, reduced=True, device="cpu",
                      **KW)
    assert fused_decode_active(eng) == (mode == "native")
    _serve(eng, _prompts(lens=(9,)), new=3)
    assert (calls["paged_attention"] > 0) == (mode == "native")
    assert (calls["page_gather"] > 0) == (mode != "native")


def test_sim_radix_cache_and_defrag_keep_the_tokens():
    """sim serving through the radix cache (hits > 0) and with a defrag
    between steps gives the tokens of the plain chunked run."""
    shared = np.arange(1, 17, dtype=np.int32)
    prompts = [shared, np.concatenate([shared, np.int32([3, 1, 4])]),
               np.concatenate([shared[:8], np.int32([9, 9])])]
    kw = dict(max_lanes=1, page_size=4, max_ctx=32, prefill_mode="chunked",
              prefill_chunk=2)
    base = make_engine("granite-3-8b", mode="sim", device="cpu", **kw)
    radix = Engine(base.model, radix_cache=True, **kw)
    want = [_serve(base, [p])[0] for p in prompts]
    assert [_serve(radix, [p])[0] for p in prompts] == want
    assert radix.metrics()["prefix_hit_rate"] > 0

    kw = dict(max_lanes=2, page_size=4, max_ctx=40)
    prompts = _prompts(lens=(8, 13, 21))
    outs = []
    for with_defrag in (True, False):
        eng = Engine(base.model, **kw)
        rids = [eng.submit(p, n) for p, n in zip(prompts[:2], (2, 12))]
        for _ in range(3):
            eng.step()
        if with_defrag:
            assert eng.defrag() > 0
        rids.append(eng.submit(prompts[2], 6))
        out = eng.drain()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]


def test_sim_against_native_in_the_port():
    """The same weights in sim and native: the reduced LM's loss within 5e-4
    relative, a prefill's logits within 2^-10 of their largest magnitude."""
    models = {m: build_model(get("granite-3-8b").reduced(), _cfg(m),
                             device="cpu").init(0) for m in ("sim", "native")}
    models["sim"].load_state_dict(models["native"].state_dict())
    batch = TokenTask(models["sim"].a.vocab, 32, 2).batch(0)
    with torch.no_grad():
        losses = {m: float(t.loss(batch)[0]) for m, t in models.items()}
    assert abs(losses["sim"] - losses["native"]) <= 5e-4 * losses["native"]
    tokens = np.stack(_prompts(lens=(16, 16)))
    logits = {m: t.prefill(tokens, 32)[1] for m, t in models.items()}
    d = (logits["sim"] - logits["native"]).abs().max()
    assert d <= 2.0 ** -10 * logits["native"].abs().max()
