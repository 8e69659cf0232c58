"""The port's enc-dec (seamless-m4t-large-v2) training against the
reference package's make_train_step, on the CPU, at the reduced config (2
encoder + 2 decoder layers, d 64, 4 heads on 2 KV heads of 16, FFN 96,
vocab 128), from the reference's init carried by `encdec_params_from_jax`
and `momentum_from_jax`.  A batch is 2 sequences of 64 frames (N(0, 1)
from a seed) and 16 TokenTask ("arith") target tokens.  Serving and the
forward are tests/test_torch_encdec.py.

Bounds (the LM slice's, tests/test_torch_train.py), and the readings:

- full8 native, 3 steps: the loss within 2e-3 relative at every step;
  after step 1 at most 0.1% of the hidden weights' k_WU-grid codes
  differ, by at most 26 codes (one CQ step times lr = 26 * 2^-9), after
  steps 2 and 3 full8's 5-step bound (95%, 8192 codes).  Measured: the
  codes equal after steps 1 and 2, the losses an ulp apart; at step 3 a
  gradient's last bits tip CQ comparisons (8.3% of the codes, 130 apart).
- one sim step: the same step-1 bound (measured: codes equal).
- one fp32 step: the masters are off every grid, so every hidden weight
  within 4 codes (2^-21) of the reference's (measured 0.25: the ulps of
  fp32 products summed in another order).
- n_micro=2 against the unsplit batch, in the port: the loss within 2e-3
  (measured 8.3e-5) and the hidden codes within full8's 5-step bound
  (measured 62.5% apart, by at most 624): each microbatch takes its own
  amax grids, so the gradients differ, and with them CQ's ranges and
  stochastic comparisons.
- (params, MomentumState) saved through `repro_torch.checkpoint` after a
  step restore bitwise into a fresh model and state (and into the
  reference's tree through its own manager), and the next step from the
  restored state equals the unbroken run's bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get as jget
from repro.core import preset as jpreset
from repro.launch.train import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.optim import init_momentum as jinit_momentum
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.convert import encdec_params_from_jax, momentum_from_jax
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import flatten, init_momentum

from torch_parity import exact_pow2_patched

NAME = "seamless-m4t-large-v2"
S, B = 64, 2                         # frames a sequence, sequences a batch
STEP1 = (1e-3, 26)                   # share of codes apart, largest gap


@pytest.fixture(autouse=True, scope="module")
def _module_setup():
    """One intra-op thread (test_torch_resnet.py) and the reference's pow2
    helpers made exact (torch_parity.exact_pow2) for the whole module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with exact_pow2_patched():
        yield
    torch.set_num_threads(prev)


@functools.cache
def _init():
    """The reference's init (full8's k_WU grid, jitted) and optimizer
    state."""
    jm = jbuild(jget(NAME).reduced(), jpreset("full8", "native"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return params, jinit_momentum(params)


def _batch(step: int) -> dict:
    batch = TokenTask(128, S // 4, B).batch(step)
    batch["frames"] = np.random.default_rng(100 + step).standard_normal(
        (B, S, 64)).astype(np.float32)
    return batch


def _port(mode="native"):
    """The port's EncDec and optimizer state from the reference's init."""
    params, jopt = _init()
    tm = build_model(get(NAME).reduced(), preset("full8", mode),
                     device="cpu")
    tm.load_params(encdec_params_from_jax(jax.tree.map(np.asarray, params)))
    return tm, momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))


def _hidden(tm) -> list[int]:
    return [i for i, lab in enumerate(flatten(tm.labels())) if lab == "w"]


def _gap(tm, met, tmet, params) -> tuple[float, float, float]:
    """(the loss's relative gap, the share of hidden codes (2^-23) apart,
    the largest distance in codes) after one step of both packages."""
    rel = abs(float(tmet["loss"]) - float(met["loss"])) / float(met["loss"])
    want, got = jax.tree.leaves(params), flatten(tm.params())
    d = np.concatenate([np.abs(np.asarray(want[i], np.float64)
                               - got[i].detach().numpy()).ravel() * 2 ** 23
                        for i in _hidden(tm)])
    return rel, float(np.mean(d > 0)), float(d.max())


def _steps(mode, steps, n_micro=1):
    """Both packages' make_train_step in `mode` over `steps` batches:
    per step (loss rel, share apart, largest distance)."""
    params, jopt = _init()
    jm = jbuild(jget(NAME).reduced(), jpreset("full8", mode))
    jstep = jax.jit(jmake_step(jm, jm.q, jm.labels(params), lr=0.05,
                               n_micro=n_micro))
    tm, topt = _port(mode)
    tstep = ttrain.make_train_step(tm, tm.q, lr=0.05, n_micro=n_micro)
    gaps = []
    for s in range(steps):
        batch = _batch(s)
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        gaps.append(_gap(tm, met, tstep(topt, batch, s), params))
        print(f"{mode} n_micro {n_micro} step {s + 1}: loss rel "
              f"{gaps[-1][0]:.3e}, codes apart {gaps[-1][1]:.5f}, max "
              f"{gaps[-1][2]}")
    assert topt.step == steps
    return gaps


def test_train_steps_within_bounds():
    """3 full8 native steps: step 1 within the LM's step-1 bound, steps 2
    and 3 within full8's 5-step bound (at most 95% of the codes apart, by
    at most 8192)."""
    gaps = _steps("native", 3)
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    assert gaps[0][1] <= STEP1[0] and gaps[0][2] <= STEP1[1], gaps
    assert all(share <= 0.95 and dist <= 8192 for _, share, dist in gaps)


@pytest.mark.parametrize("mode", ["sim", "fp32"])
def test_sim_and_fp32_step(mode):
    """One sim step within the step-1 bound; one fp32 step with every
    hidden weight within 4 codes (2^-21) of the reference's."""
    ((rel, share, dist),) = _steps(mode, 1)
    assert rel <= 2e-3
    if mode == "sim":
        assert share <= STEP1[0] and dist <= STEP1[1]
    else:
        assert dist <= 4


def test_n_micro_2_against_the_unsplit_batch():
    """n_micro=2 (one sequence a microbatch) from the same weights as the
    unsplit step: its loss, the mean of the two microbatches', within 2e-3
    of the unsplit batch's, and the hidden codes after the step within
    full8's 5-step bound of the unsplit step's (at most 95% apart, by at
    most 8192): each microbatch takes its own amax grids, so the gradients
    differ, and with them CQ's ranges and stochastic comparisons."""
    out = []
    for n_micro in (2, 1):
        tm, topt = _port()
        loss = float(ttrain.make_train_step(tm, tm.q, lr=0.05,
                                            n_micro=n_micro)(
            topt, _batch(0), 0)["loss"])
        out.append((loss, np.concatenate([
            flatten(tm.params())[i].detach().numpy().ravel()
            for i in _hidden(tm)]).astype(np.float64) * 2 ** 23))
    (split, cs), (whole, cw) = out
    d = np.abs(cs - cw)
    print(f"n_micro 2 loss {split:.6f}, unsplit {whole:.6f}; codes apart "
          f"{np.mean(d > 0):.5f}, max {d.max()}")
    assert abs(split - whole) <= 2e-3 * whole
    assert np.mean(d > 0) <= 0.95 and d.max() <= 8192


def test_checkpoint_restores_and_resumes(tmp_path):
    """(params, MomentumState) after one step, saved through the port's
    CheckpointManager: restored into a fresh model and state, every leaf
    and the step equal; the reference's manager restores the same values
    into its tree; the next step equals the unbroken run's."""
    tm, topt = _port()
    step = ttrain.make_train_step(tm, tm.q, lr=0.05)
    step(topt, _batch(0), 0)
    cm = CheckpointManager(str(tmp_path))
    try:
        cm.save(1, (tm.params(), topt))
    finally:
        cm.wait()
    fresh, fopt = _port()
    fopt = init_momentum(fresh.params())
    _, at, _ = CheckpointManager(str(tmp_path)).restore((fresh.params(),
                                                         fopt))
    assert at == 1 and fopt.step == topt.step == 1
    for a, b in zip(flatten((tm.params(), topt.acc)),
                    flatten((fresh.params(), fopt.acc))):
        assert torch.equal(a, b)
    params, jopt = _init()
    (jp, jo), jat, _ = JManager(str(tmp_path)).restore((params, jopt))
    assert jat == 1
    for a, b in zip(flatten((tm.params(), topt.acc)),
                    jax.tree.leaves((jp, jo.acc))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    step(topt, _batch(1), 1)
    ttrain.make_train_step(fresh, fresh.q, lr=0.05)(fopt, _batch(1), 1)
    for a, b in zip(flatten((tm.params(), topt.acc)),
                    flatten((fresh.params(), fopt.acc))):
        assert torch.equal(a, b)
