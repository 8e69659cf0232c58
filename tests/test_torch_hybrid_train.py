"""The port's hybrid zamba2-7b training against the reference package's
make_train_step, on the CPU, at zamba2-7b.reduced() with 3 layers and a
shared block after every 2 (so the shared block's gradient sums over its
application and a Mamba2 tail follows) and scan_chunk 8 (a 24-token
sequence runs 3 SSD chunks), from the reference's init carried by
`hybrid_params_from_jax` and `momentum_from_jax`.  A batch is 2
TokenTask ("arith") sequences of 24 tokens.  The forward and serving are
tests/test_torch_hybrid.py and tests/test_torch_hybrid_serve.py.

Bounds (the LM slice's, tests/test_torch_train.py), and the readings:

- full8 native, 3 steps: the loss within 2e-3 relative at every step;
  after step 1 at most 0.1% of the hidden weights' k_WU-grid codes
  differ, by at most 26 codes (one CQ step times lr = 26 * 2^-9), after
  steps 2 and 3 full8's 5-step bound (95%, 8192 codes).  The gradients
  part where the Mamba2 block's fp32 sums do (tests/test_torch_mamba2.py:
  the norm gains', the conv's and x's within 2^-18 of their largest), and
  a last-bit difference can tip a CQ comparison.  Measured: every code
  equal after each of the 3 steps, the losses 1e-7 apart (an ulp).
- one sim step: the same step-1 bound.
- one fp32 step: the masters are off every grid, so every hidden weight
  within 4 codes (2^-21) of the reference's (the ulps of fp32 products
  summed in another order).
- The CLI trains the reduced hybrid on the CPU, and a --resume continues
  bit for bit.

`-s` prints each step's gaps.
"""
import functools

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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.convert import hybrid_params_from_jax, momentum_from_jax
from repro_torch.core import preset
from repro_torch.data import TokenTask
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import flatten

from torch_parity import exact_pow2_patched

NAME = "zamba2-7b"
CUT = dict(n_layers=3, attn_every=2, scan_chunk=8)
S, B = 24, 2
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
    jm = jbuild(jget(NAME).reduced().replace(**CUT),
                jpreset("full8", "native"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return params, jinit_momentum(params)


def _batch(step: int) -> dict:
    return TokenTask(128, S, B).batch(step)


def _port(mode="native"):
    """The port's Zamba2 and optimizer state from the reference's init."""
    params, jopt = _init()
    tm = build_model(get(NAME).reduced().replace(**CUT),
                     preset("full8", mode), device="cpu")
    tm.load_params(hybrid_params_from_jax(jax.tree.map(np.asarray, params)))
    return tm, momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))


def _gap(tm, met, tmet, params) -> tuple[float, float, float]:
    """(the loss's relative gap, the share of hidden codes (2^-23) apart,
    the largest distance in codes) after one step of both packages."""
    rel = abs(float(tmet["loss"]) - float(met["loss"])) / float(met["loss"])
    want, got = jax.tree.leaves(params), flatten(tm.params())
    hidden = [i for i, lab in enumerate(flatten(tm.labels())) if lab == "w"]
    d = np.concatenate([np.abs(np.asarray(want[i], np.float64)
                               - got[i].detach().numpy()).ravel() * 2 ** 23
                        for i in hidden])
    return rel, float(np.mean(d > 0)), float(d.max())


def _steps(mode, steps):
    """Both packages' make_train_step in `mode` over `steps` batches:
    per step (loss rel, share apart, largest distance)."""
    params, jopt = _init()
    jm = jbuild(jget(NAME).reduced().replace(**CUT), jpreset("full8", mode))
    jstep = jax.jit(jmake_step(jm, jm.q, jm.labels(params), lr=0.05))
    tm, topt = _port(mode)
    tstep = ttrain.make_train_step(tm, tm.q, lr=0.05)
    gaps = []
    for s in range(steps):
        batch = _batch(s)
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        gaps.append(_gap(tm, met, tstep(topt, batch, s), params))
        print(f"{mode} step {s + 1}: loss rel {gaps[-1][0]:.3e}, codes "
              f"apart {gaps[-1][1]:.5f}, max {gaps[-1][2]}")
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


def test_hybrid_train_cli_and_resume(capsys, tmp_path):
    """The CLI trains zamba2-7b (reduced) on the CPU; 2 steps, a checkpoint,
    then --resume to 3 steps: the step-3 checkpoint equals the unbroken
    3-step run's bit for bit, the shared block's leaves included."""
    argv = ["--arch", NAME, "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--save-every", "1"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttrain.main(argv + ["--steps", "3", "--ckpt-dir", a])
    out = capsys.readouterr().out
    assert f"[train] {NAME}-smoke full8/native on cpu" in out
    assert "step     2 loss" in out
    ttrain.main(argv + ["--steps", "2", "--ckpt-dir", b])
    assert "resumed" not in capsys.readouterr().out
    ttrain.main(argv + ["--steps", "3", "--ckpt-dir", b, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     1 loss" not in out
    assert CheckpointManager(a).all_steps()[-1] == 3
    with np.load(f"{a}/step-0000000003/arrays.npz") as x, \
            np.load(f"{b}/step-0000000003/arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        assert any("shared" in k for k in x.files)
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k
