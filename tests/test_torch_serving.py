"""The port's serving engine (repro_torch.serving) against the reference's.

Weights come from `repro`'s `LMTransformer.init` at granite-3-8b.reduced()
sizes and are carried across with `params_from_jax`; both engines run
chunked prefill with page size 8, full8 in native mode, greedy.  Tolerance:
the generated tokens are EQUAL (the per-step logits agree within the model
bound of test_torch_layers.py, and greedy argmax decides on them).
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving import make_engine as jmake_engine
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.core import preset
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Engine, make_engine

from torch_parity import exact_pow2, one_torch_thread  # noqa: F401

KW = dict(max_lanes=2, page_size=8, max_ctx=32, prefill_chunk=2)
PROMPT_LENS = (8, 13, 21)
NEW = 4


def _prompts(vocab):
    r = np.random.default_rng(11)
    return [r.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _port_engine(jengine, **kw):
    tm = build_model(get("granite-3-8b").reduced(), preset("full8"),
                     device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jengine.params)))
    return Engine(tm, **kw)


def _serve(engine, prompts, new=NEW):
    rids = [engine.submit(p, new) for p in prompts]
    out = engine.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("n_pages,new,max_ctx", [(None, NEW, 32),
                                                 (6, 10, 40)],
                         ids=["None-4-32", "6-10-40"])
def test_engine_tokens_equal_reference(n_pages, new, max_ctx, exact_pow2):
    """Chunked prefill (full pages, then the ragged tail through the B=1
    decode step) and continuous-batching decode give the reference's
    tokens.  With 6 pages and 10 new tokens the pool runs short and the
    engine preempts (recompute), on the same schedule as the reference's.
    (Monolithic prefill, the default, is test_torch_engine.py's.)"""
    kw = dict(KW, n_pages=n_pages, max_ctx=max_ctx, prefill_mode="chunked")
    jeng = jmake_engine("granite-3-8b", mode="native", reduced=True, seed=0,
                        **kw)
    prompts = _prompts(jeng.model.a.vocab)
    want = _serve(jeng, prompts, new)
    eng = _port_engine(jeng, **kw)
    got = _serve(eng, prompts, new)
    assert got == want
    m, jm = eng.metrics(), jeng.metrics()
    assert m["preemptions"] == jm["preemptions"]
    assert (m["preemptions"] > 0) == (n_pages is not None)
    assert m["completed"] == len(PROMPT_LENS)
    assert m["generated_tokens"] == new * len(PROMPT_LENS)
    assert m["pool"]["in_use"] == 0 and m["live_lanes"] == 0


def test_make_engine_serves_on_cpu():
    eng = make_engine("granite-3-8b", reduced=True, device="cpu", seed=3,
                      prefill_mode="chunked", **KW)
    a = eng.model.a
    assert (a.d_model, a.n_heads, a.n_kv, a.dh) == (64, 4, 2, 16)
    toks = _serve(eng, _prompts(a.vocab))
    assert all(len(t) == NEW and all(0 <= x < a.vocab for x in t)
               for t in toks)
    m = eng.metrics()
    assert m["decode_steps"] > 0 and m["prefill_tokens"] == sum(PROMPT_LENS)


def test_full_width_layouts_at_cut_depth():
    """chip_smoke.py's model: every width of granite-3-8b, depth cut (built
    on the meta device here: shapes only, no storage)."""
    acfg = get("granite-3-8b").replace(n_layers=1)
    model = build_model(acfg, preset("full8"), device="meta")
    assert tuple(model.layers["w_gate"].shape) == (1, 4096, 12800)
    assert tuple(model.lm_head.shape) == (4096, 49664)


def test_tp_serving_raises():
    with pytest.raises(NotImplementedError, match="item 5"):
        make_engine("granite-3-8b", device="cpu", tp=2)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("granite-3-8b", reduced=True)
    assert resolve_device("cpu").type == "cpu"
