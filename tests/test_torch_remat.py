"""Per-layer remat (`ArchConfig.remat`, `models/layers.py maybe_remat`) on
the CPU: with remat "full" each layer's activations are dropped after the
forward and recomputed in the backward, and the numbers do not move.

For the dense LM (granite-3-8b), the MoE (granite-moe-1b-a400m), the SSM
(falcon-mamba-7b), the hybrid (zamba2-7b, also at 3 layers with a shared
block after every 2, so the tail layer runs) and the enc-dec
(seamless-m4t-large-v2), each at its reduced() config from one seed: the
loss, every parameter's gradient and one full8 make_train_step's weights
and Momentum accumulator with remat "full" equal those with "none" bit for
bit, and "full" keeps fewer activation bytes for the backward than "none"
(counted by a saved-tensors hook around the loss).  The ArchConfig fields,
remat among them, equal the reference's for every registered config.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro_torch.configs import ARCHS, ArchConfig, get
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import flatten, init_momentum

S, B = 32, 2                 # tokens (frames for the enc-dec) a sequence


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (test_torch_resnet.py): the reduced models'
    small ops run no faster on more, and the suite's workers share the
    host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CASES = {
    "granite-3-8b": ("granite-3-8b", {}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
    "falcon-mamba-7b": ("falcon-mamba-7b", {}),
    "zamba2-7b": ("zamba2-7b", {}),
    "zamba2-7b-tail": ("zamba2-7b", {"n_layers": 3, "attn_every": 2}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
}


@pytest.mark.parametrize("name", ARCHS)
def test_arch_fields_match_reference(name):
    """Every ArchConfig field (remat included, "full" by default) and the
    derived widths equal the reference's, in full and reduced() form."""
    assert ArchConfig(name="x", family="lm").remat == "full"
    fields = [f.name for f in dataclasses.fields(ArchConfig)]
    assert "remat" in fields
    for cfg, jcfg in ((get(name), jget(name)),
                      (get(name).reduced(), jget(name).reduced())):
        for f in fields + ["dh", "d_inner", "vocab_padded"]:
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)


def _model(case: str, remat: str):
    name, over = CASES[case]
    acfg = get(name).reduced().replace(remat=remat, **over)
    return build_model(acfg, preset("full8"), device="cpu").init(0)


def _batch(a, step: int) -> dict:
    if a.family != "encdec":
        return TokenTask(a.vocab, S, B).batch(step)
    batch = TokenTask(a.vocab, S // a.tgt_ratio, B).batch(step)
    batch["frames"] = np.random.default_rng(100 + step).standard_normal(
        (B, S, a.d_model)).astype(np.float32)
    return batch


def _loss_and_grads(model, batch):
    """The loss, each parameter's gradient, and the bytes of the tensors
    autograd keeps for the backward outside any checkpoint."""
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    model.zero_grad(set_to_none=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(batch)
    loss.backward()
    grads = [p.grad.clone() for p in flatten(model.params())]
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, kept[0]


@pytest.mark.parametrize("case", CASES)
def test_remat_full_equals_none(case):
    """Loss, gradients, then one step's weights and accumulator: remat
    "full" against "none", bit for bit."""
    full, none = _model(case, "full"), _model(case, "none")
    assert full.a.remat == "full" and none.a.remat == "none"
    for p, q in zip(flatten(full.params()), flatten(none.params())):
        assert torch.equal(p, q)
    batch = _batch(full.a, 0)
    lf, gf, kf = _loss_and_grads(full, batch)
    ln, gn, kn = _loss_and_grads(none, batch)
    assert torch.equal(lf, ln), (case, float(lf), float(ln))
    assert len(gf) == len(gn)
    for i, (x, y) in enumerate(zip(gf, gn)):
        assert torch.equal(x, y), (case, "gradient", i)
    assert kf < kn, (case, kf, kn)

    after = []
    for model in (full, none):
        opt = init_momentum(model.params())
        met = make_train_step(model, model.q, lr=0.05)(opt, batch, 0)
        assert np.isfinite(float(met["loss"]))
        after.append(([p.detach().clone() for p in flatten(model.params())],
                      [t.clone() for t in flatten(opt.acc)]))
    (pf, af), (pn, an) = after
    assert all(torch.equal(x, y) for x, y in zip(pf, pn)), case
    assert all(torch.equal(x, y) for x, y in zip(af, an)), case


def test_serving_paths_do_not_checkpoint():
    """Under no_grad (every serving entry point) maybe_remat calls the
    function once, with grad it runs again in the backward, and remat
    "none" never runs it again."""
    from repro_torch.models import layers as L
    calls = []
    a = get("granite-3-8b").reduced()
    body = L.maybe_remat(a, lambda x: calls.append(1) or x * x)
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        body(x)
    assert len(calls) == 1
    y = body(x)
    y.sum().backward()
    assert len(calls) == 3                    # forward, then the recompute
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    plain = L.maybe_remat(a.replace(remat="none"),
                          lambda x: calls.append(1) or x * x)
    plain(x).sum().backward()
    assert len(calls) == 4                    # no recompute
