"""The port's MoE training (granite-moe-1b-a400m, moonshot-v1-16b-a3b)
against the reference package's make_train_step, on the CPU.

Both configs' reduced() forms are one model (2 layers, d 64, 4 heads on 2
KV heads of 16, FFN 96, 4 experts top-2, vocab 128; only the names differ:
tests/test_torch_moe.py::test_reduced_configs_are_one_model), so each
preset's trajectories are computed once and held for both names.

Tolerances: 5 full8 and e2_16 steps from the same weights on TokenTask
batches of 4 x 32.  The loss within 2e-3 relative at every step; the
hidden and expert weights' k_WU codes after steps 1 and 5 within the LM
slice's bounds (tests/test_torch_train.py) or the reference's own spread
under a one-ulp change of the error at its backbone output, plus the LM's
step-1 bound, whichever is larger (the test's docstring gives the
readings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import init_momentum as jinit_momentum
from repro_torch.configs import get
from repro_torch.convert import momentum_from_jax, params_from_jax
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model

from torch_parity import exact_pow2  # noqa: F401

MOE = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
HIDDEN = ("wq", "wk", "wv", "wo")
EXPERTS = ("wg", "wu", "wd")
# The LM slice's bounds (tests/test_torch_train.py): after step 1 at most
# 0.1% of the codes differ, by at most 26 (one CQ step times lr); after
# step 5 the preset's share and distance.  SLACK is also what the port may
# add to the reference's own spread.
SLACK = (1e-3, 26)
BOUNDS = {"full8": (0.95, 8192), "e2_16": (0.01, 1024)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (test_torch_resnet.py): the MoE's many small
    ops, run again by the layers' recompute, gain nothing from more, and
    the suite's workers share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _codes(layers) -> np.ndarray:
    def c(w):
        w = w.detach().numpy() if torch.is_tensor(w) else np.asarray(w)
        return w.astype(np.float64).ravel() * 2 ** 23
    return np.concatenate([c(layers[k]) for k in HIDDEN]
                          + [c(layers["moe"][k]) for k in EXPERTS])


def _one_ulp(jm) -> None:
    """Move the error that reaches jm's backbone output one ulp up in 4 of
    every 7 elements (by flat index); the forward is unchanged.  The port's
    error there differs from the reference's by that much: the head's fp32
    contraction and the final norm's sums run in another order (as in
    tests/test_torch_ssm_train.py)."""
    logits = jm._logits

    @jax.custom_vjp
    def ulp(x):
        return x

    def bwd(_, g):
        i = jnp.arange(g.size, dtype=jnp.uint32).reshape(g.shape)
        return (jnp.where(i * jnp.uint32(40503) % 7 < 4,
                          jnp.nextafter(g, jnp.inf), g),)

    ulp.defvjp(lambda x: (x, None), bwd)
    jm._logits = lambda params, x: logits(params, ulp(x))


def _ref_trajectory(name, qname, batches, ulp=False):
    """The reference's make_train_step from PRNGKey(0) over `batches`:
    (initial params, initial optimizer state, per step (loss, codes))."""
    acfg = jget(name).reduced()
    jcfg = jpreset(qname, "native")
    jm = jbuild(acfg, jcfg)
    if ulp:
        _one_ulp(jm)
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    init = (params, jopt)
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
    out = []
    for s, batch in enumerate(batches):
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        out.append((float(met["loss"]), _codes(params["layers"])))
    return init, out


def _gap(a, b) -> tuple[float, float, float]:
    """(loss's relative gap, share of codes that differ, largest distance)
    of two steps' (loss, codes)."""
    d = np.abs(a[1] - b[1])
    return abs(a[0] - b[0]) / b[0], float(np.mean(d > 0)), float(d.max())


def _within_lm(gaps, qname) -> bool:
    return all(gaps[s][1] <= lm[0] and gaps[s][2] <= lm[1]
               for s, lm in ((0, SLACK), (4, BOUNDS[qname])))


_RUNS: dict = {}


def _trajectories(name, qname):
    """(the port's gaps to the reference after each of 5 steps, the
    reference's own gaps under `_one_ulp`, or None where the port stays
    within the LM's bounds), once per reduced model and preset."""
    key = (dataclasses.replace(jget(name).reduced(), name="", source=""),
           qname)
    if key in _RUNS:
        return _RUNS[key]
    task = TokenTask(jget(name).reduced().vocab, 32, 4)
    batches = [task.batch(s) for s in range(5)]
    (params, jopt), ref = _ref_trajectory(name, qname, batches)
    cfg = preset(qname)
    tm = build_model(get(name).reduced(), cfg, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    tstep = ttrain.make_train_step(tm, cfg, lr=0.05)
    gaps = []
    for s, batch in enumerate(batches):
        loss = float(tstep(topt, batch, s)["loss"])
        gaps.append(_gap((loss, _codes(tm.params()["layers"])), ref[s]))
    assert topt.step == 5
    own = None
    if not _within_lm(gaps, qname):
        _, mine = _ref_trajectory(name, qname, batches, ulp=True)
        own = [_gap(o, r) for o, r in zip(mine, ref)]
    _RUNS[key] = (gaps, own)
    return gaps, own


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("qname", ["full8", "e2_16"])
def test_train_steps_within_bounds(name, qname, exact_pow2):
    """make_train_step of both packages from the same weights over 5
    TokenTask batches of 4 x 32: per step the loss's relative gap (within
    2e-3), the share of the hidden and expert weights' k_WU-grid codes
    that differ and their largest distance.  After steps 1 and 5 the port
    stays within the LM slice's bounds, or lands no farther from the
    reference than the reference lands from itself when the error at its
    backbone output moves one ulp (`_one_ulp`), plus SLACK: the larger of
    the two.

    Measured on the CPU: the codes are equal after steps 1 to 3 in both
    presets, and step 4's loss is equal; an ulp then tips one CQ
    comparison (0.6% of the codes, 26 apart, in full8; 2.2%, 78, in
    e2_16), and after step 5 full8 differs in 46.9% of the codes, 728
    apart (within the LM's 95%, 8192), e2_16 in 57.8%, 884 apart, beyond
    the LM's 1% but within the reference's own spread (92.2%, 4160 after
    step 5; full8's is 0).  A moved expert weight moves the router's
    choices of the next step, and every expert's gradient with them, so
    an MoE spreads farther than the dense LM from the same tip."""
    gaps, own = _trajectories(name, qname)
    for s, (rel, share, dist) in enumerate(gaps):
        print(f"{name} {qname} step {s + 1}: loss rel {rel:.3e} (bound "
              f"2e-3), codes differing {share:.5f}, max distance "
              f"{dist:.0f}; the reference against itself "
              f"{'not run' if own is None else own[s]}")
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    for s, lm in ((0, SLACK), (4, BOUNDS[qname])):
        _, share, dist = (0.0, 0.0, 0.0) if own is None else own[s]
        assert gaps[s][1] <= max(lm[0], share + SLACK[0]), (s + 1, gaps[s])
        assert gaps[s][2] <= max(lm[1], dist, SLACK[1]), (s + 1, gaps[s])


def test_train_cli_runs_moe(capsys):
    ttrain.main(["--arch", "moonshot-v1-16b-a3b", "--reduced", "--steps",
                 "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "moonshot-v1-16b-a3b-smoke" in out and "step     1 loss" in out
