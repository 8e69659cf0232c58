"""Training in the port's sim and fp32 modes against the JAX reference.

3 steps of both packages' make_train_step from the reference's init
(carried by convert.py), on identical batches, for each family the port
trains: the dense LM (granite-3-8b), the MoE LM (granite-moe-1b-a400m),
Mamba1 (falcon-mamba-7b) and the ResNet (resnet50), each reduced().
Bounds:

  sim: the loss of every step within 2e-3 relative; after step 1 the
     hidden weights' k_WU-grid codes equal on all but 0.1%, at most 26
     codes apart (one CQ step times lr = 26 * 2^-9); after step 3 within
     full8's 5-step bound of the native slice tests (at most 95% of the
     codes differ, by at most 8192 codes, 2^14 for the ResNet).  Measured:
     equal codes on the LMs, 2e-5 of the codes one CQ step apart on
     Mamba1 from step 1.
  fp32: the masters are off every grid, so the bound is on their values:
     the loss of every step within 2e-3 relative and every hidden weight
     within 2^-21 of the reference's after each step (measured 2^-24:
     the ulps of the fp32 products and reductions).
"""
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
from repro_torch.convert import (momentum_from_jax, params_from_jax,
                                 resnet_params_from_jax, ssm_params_from_jax)
from repro_torch.core import preset
from repro_torch.data import ImageTask, TokenTask
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import flatten

from torch_parity import exact_pow2  # noqa: F401

ARCHS = ("granite-3-8b", "granite-moe-1b-a400m", "falcon-mamba-7b",
         "resnet50")
CONVERT = {"ssm": ssm_params_from_jax, "resnet": resnet_params_from_jax}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in test_torch_resnet.py: the reduced models
    run many tiny ops, whose thread pools wait on the other workers'."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trajectory(arch, mode, steps=3):
    """Both packages' make_train_step in `mode` from the reference's init:
    per step the loss's relative gap and the hidden weights' largest
    distance in k_WU-grid codes (2^-23) and the share that differ."""
    acfg = jget(arch).reduced()
    jcfg, cfg = jpreset("full8", mode), preset("full8", mode)
    jm = jbuild(acfg, jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    jopt = jinit_momentum(params)
    jstep = jax.jit(jmake_step(jm, jcfg, jm.labels(params), lr=0.05))
    tm = build_model(get(arch).reduced(), cfg, device="cpu")
    tm.load_params(CONVERT.get(acfg.family, params_from_jax)(
        jax.tree.map(np.asarray, params)))
    topt = momentum_from_jax(jax.tree.map(np.asarray, jopt.acc))
    tstep = ttrain.make_train_step(tm, cfg, lr=0.05)
    task = ImageTask(acfg.img_size, acfg.num_classes, 8) \
        if acfg.family == "resnet" else TokenTask(acfg.vocab, 32, 4)
    hidden = [i for i, lab in enumerate(flatten(tm.labels())) if lab == "w"]
    gaps = []
    for s in range(steps):
        batch = task.batch(s)
        params, jopt, met = jstep(params, jopt,
                                  jax.tree.map(jnp.asarray, batch),
                                  jnp.int32(s))
        tmet = tstep(topt, batch, s)
        assert set(tmet) == set(met)
        rel = abs(float(tmet["loss"]) - float(met["loss"])) \
            / float(met["loss"])
        want, got = jax.tree.leaves(params), flatten(tm.params())
        d = np.concatenate([
            np.abs(np.asarray(want[i], np.float64)
                   - got[i].detach().numpy()).ravel() * 2 ** 23
            for i in hidden])
        gaps.append((rel, float(np.mean(d > 0)), float(d.max())))
        print(f"{arch} {mode} step {s + 1}: loss rel {rel:.3e}, codes "
              f"differing {gaps[-1][1]:.5f}, max distance {gaps[-1][2]}")
    assert topt.step == steps
    return gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_sim_training_within_bounds(arch, exact_pow2):
    gaps = _trajectory(arch, "sim")
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    assert gaps[0][1] <= 1e-3 and gaps[0][2] <= 26, gaps[0]
    dist = 2 ** 14 if arch == "resnet50" else 8192
    assert gaps[-1][1] <= 0.95 and gaps[-1][2] <= dist, gaps[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_training_within_bounds(arch, exact_pow2):
    gaps = _trajectory(arch, "fp32")
    assert all(rel <= 2e-3 for rel, _, _ in gaps), gaps
    assert all(dist <= 4 for _, _, dist in gaps), gaps
