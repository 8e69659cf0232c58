"""Quantized Momentum optimizer + fixed-point updates (paper Eq. 19-24).

Port of `repro.optim.momentum`.  Per training step i and leaf:
    g_q    = CQ(g_W)            (weights, Eq. 5/18: stochastic rounding)
           = Q(g, 15)           (gamma/beta, Eq. 18)
    Acc_i  = Mom * Acc_{i-1,q} + g_q          (Eq. 20)
    Acc_iq = Q(Acc_i, k_Acc)
    dW     = lr * Acc_i                        (Eq. 23, lr on the k_lr grid)
    W     <- clip(Q(W - dW, k_WU), +-(1 - 2^-(k_WU-1)))

Leaves are classified by a labels tree of strings ("w", "gamma", "beta",
"exempt"), and visited in `jax.tree.flatten`'s order (dict keys sorted,
list items in order, depth first), leaf i drawing its CQ noise from `fold_in(key, i)`: the
reference's order and keys, so the stochastic-rounding bits are a pure
function of (seed, step, leaf index) in both packages (core/prng.py).

The port updates parameters and accumulators IN PLACE (`copy_`): the
reference returns new trees, which at full width would hold a second copy
of 4.8 GB of parameters and 4.8 GB of accumulator during the step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import prng
from repro_torch.core import qfuncs as qf
from repro_torch.core.qconfig import QConfig
from repro_torch.core.qtensor import get_quantizer

Tensor = torch.Tensor


@dataclass
class MomentumState:
    acc: dict          # tree like params
    step: int = 0


def flatten(tree) -> list:
    """Leaves of nested dicts and lists in jax.tree.flatten's order: dict
    keys sorted, list items in order, depth first (the ResNet's "stages"
    is a list of lists of block dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


def unflatten(tree, leaves: list):
    """A tree shaped like `tree` holding `leaves` in `flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree):
    """`fn` on every leaf of nested dicts and lists, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_momentum(params: dict) -> MomentumState:
    return MomentumState(acc=tree_map(lambda p: torch.zeros_like(
        p, requires_grad=False), params))


def fixed_point_lr(lr: float, cfg: QConfig) -> float:
    """Learning rate on the k_lr-bit grid (e.g. 0.05 -> 26*2^-9); as given
    in fp32 mode."""
    if not cfg.quantize:
        return lr
    s = 2.0 ** (cfg.k_lr - 1)
    return max(round(lr * s), 1.0) / s


def dr_bits_schedule(step: int, boundaries=(), base_bits: int = 8) -> int:
    """dr = 2^(k-1) shrinks one bit at each step boundary (paper §III-C:
    k 8 -> 7 ...); `base_bits` is cfg.k_gw."""
    bits = base_bits
    for b in boundaries:
        if step >= b:
            bits -= 1
    return max(bits, 2)


def parse_boundaries(spec: str) -> tuple[int, ...]:
    """--dr-boundaries CLI format: '200,400' -> (200, 400), '' -> ()."""
    return tuple(int(s) for s in str(spec).split(",") if s.strip())


def _grad_quantizer(cfg: QConfig, dr_bits: int):
    """cfg.g through the registry; the per-step dr width and the
    stochastic_g knob are injected where the quantizer declares those
    fields and the spec did not pin them."""
    params = dict(cfg.g.params)
    fields = {f.name for f in dataclasses.fields(
        type(get_quantizer(cfg.g.kind, cfg.g.k, cfg.g.params)))}
    if "dr_bits" in fields:
        params.setdefault("dr_bits", dr_bits)
    if "stochastic" in fields:
        params.setdefault("stochastic", cfg.stochastic_g)
    return get_quantizer(cfg.g.kind, cfg.g.k, tuple(sorted(params.items())))


def _mom_coeff(cfg: QConfig, mom: float) -> float:
    if not cfg.quantize:
        return mom
    s = 2.0 ** (cfg.k_mom - 1)
    return round(mom * s) / s          # e.g. 0.75 = 3 * 2^-2 (3-bit)


def _plain_path(cfg: QConfig, lab) -> bool:
    """Vanilla-momentum leaves: every leaf in fp32 mode, exempt leaves, or
    Table II runs with both the G and U quantizers off."""
    return (not cfg.quantize or lab == "exempt"
            or not (cfg.quant_g or cfg.quant_u))


def quantize_grad_leaf(cfg: QConfig, g: Tensor, lab, key,
                       dr_bits: int | None = None) -> Tensor:
    """Per-leaf gradient quantization (Eq. 18): CQ for "w" leaves (the
    amax and the noise span the whole stacked leaf), direct 15-bit for
    gamma/beta, identity for plain-path leaves."""
    if _plain_path(cfg, lab) or not cfg.quant_g:
        return g
    if dr_bits is None:
        dr_bits = cfg.k_gw
    if lab == "w":
        return _grad_quantizer(cfg, dr_bits)(g, key=key)
    if lab in ("gamma", "beta"):
        k = cfg.k_ggamma if lab == "gamma" else cfg.k_gbeta
        return get_quantizer("direct", k)(g)
    raise ValueError(f"unknown label {lab!r}")


def apply_leaf_update(cfg: QConfig, p: Tensor, gq: Tensor, a: Tensor, lab,
                      lr: float, mom: float = 0.75) -> None:
    """Elementwise Momentum + fixed-point update (Eq. 19-24) given the
    quantized gradient `gq`, IN PLACE on p and a."""
    if _plain_path(cfg, lab) or not cfg.quant_u:
        acc = mom * a + gq
        p.copy_(p - lr * acc)
        a.copy_(acc)
        return
    momq = _mom_coeff(cfg, mom)
    acc_full = momq * qf.q_direct(a, cfg.k_acc) + gq      # Eq. 20
    a.copy_(qf.q_direct(acc_full, cfg.k_acc))
    q = qf.q_direct(p - lr * acc_full, cfg.k_wu)           # Eq. 23, k_WU grid
    lim = 1.0 - 2.0 ** (1 - cfg.k_wu)
    # + 0.0: the grid's zero is +0.0, as an integer code's is (a weight
    # rounded to zero from below would keep the sign bit, which the ZeRO-1
    # step's int32 gather of the codes cannot carry); values unchanged
    p.copy_(torch.clamp(q, -lim, lim).add_(0.0))


@torch.no_grad()
def momentum_update(cfg: QConfig, params: dict, grads: dict,
                    state: MomentumState, labels: dict, key, lr: float,
                    mom: float = 0.75, dr_bits: int | None = None) -> None:
    """One optimizer step, IN PLACE on params and state.acc.

    `key` is a threefry key (core/prng.py); `lr` must already be on the
    k_lr grid (fixed_point_lr); `dr_bits` is the CQ range width for this
    step (None takes cfg.k_gw, the schedule base)."""
    leaves = zip(flatten(params), flatten(grads), flatten(state.acc),
                 flatten(labels))
    for i, (p, g, a, lab) in enumerate(leaves):
        gq = quantize_grad_leaf(cfg, g, lab, prng.fold_in(key, i), dr_bits)
        apply_leaf_update(cfg, p, gq, a, lab, lr, mom)
    state.step += 1
