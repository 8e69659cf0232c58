"""Mixture-of-Experts FFN (capacity dispatch), single device.

Port of `repro.models.moe` without its expert-parallel branches (ROADMAP
Queue 1 item 5).  Per token group x (T, d), in the reference's order:

  * the router `x @ rw` in fp32 (exempt from quantization, like the
    embedding and the head);
  * the top-k experts of each token, the lower expert first where logits
    tie (`lax.top_k`'s rule: a stable descending sort, not torch.topk), and
    softmax gates over their logits;
  * capacity cap = ceil(T * k / E * capacity_factor), or T * k when
    `dropless` (decode: a lane batch's padding must not displace live
    tokens).  A (token, choice) pair takes slot `pos` of its expert, its
    rank among that expert's choices in token-major order (the reference's
    cumsum over the T * k choices); pairs with pos >= cap are dropped;
  * the inverse map (E, cap) -> token fills the capacity buffer; empty
    slots read token 0 masked to zero;
  * three batched integer contractions (`ecd,edf->ecf` twice, then
    `ecf,efd->ecd`, K1 through qeinsum) with the SwiGLU activations;
  * the combine: each token sums its kept contributions (expert output
    times gate) from 0.0 in ascending expert order, the order the
    reference's scatter-add visits them.

The dispatch and the combine are autograd Functions whose backwards are
each other's ordered gathers: no result depends on the order of atomics,
and no `index_add_` or `scatter_add_` runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import qact, qt_carrier, qweight
from repro_torch.core.qconfig import QConfig
from repro_torch.core.qdense import qeinsum

from . import layers as L

Tensor = torch.Tensor


def moe_shapes(acfg, n_layers: int) -> dict:
    """The stacked (L, ...) shapes of the reference's per-layer tree."""
    e, d, f = acfg.moe_experts, acfg.d_model, acfg.d_ff
    return {"router": (n_layers, d, e), "wg": (n_layers, e, d, f),
            "wu": (n_layers, e, d, f), "wd": (n_layers, e, f, d)}


@torch.no_grad()
def init_moe_params_(cfg: QConfig, p: dict, gen: torch.Generator) -> None:
    """In place on the stacked tree `p`: the router N(0, 0.02^2), the
    experts by winit with the reference's fan-ins (d for wg and wu, f for
    wd), drawn from `gen` (the same distributions, not the same bits)."""
    p["router"].normal_(generator=gen).mul_(0.02)
    for k in ("wg", "wu", "wd"):
        w = p[k]
        for i in range(w.shape[0]):
            L.winit_(cfg, w[i], w.shape[2], gen)


def moe_labels() -> dict:
    return {"router": "exempt", "wg": "w", "wu": "w", "wd": "w"}


def capacity(acfg, t: int, dropless: bool) -> int:
    k = acfg.moe_topk
    if dropless:
        return t * k
    return max(1, int(math.ceil(t * k / acfg.moe_experts
                                * acfg.capacity_factor)))


def top_k(logits: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest logits of each row and their experts, the lower
    expert first among equal logits (lax.top_k's order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax_gates(vals: Tensor) -> Tensor:
    """The gates of a token's top-k logits (exempt fp32)."""
    return torch.softmax(vals, dim=-1)


def router(x: Tensor, rw: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The exempt fp32 router of x (T, d): each token's top-k experts and
    their softmax gates, (T, k) each."""
    vals, idx = top_k(x @ rw, k)
    return idx, softmax_gates(vals)


@torch.no_grad()
def route(idx: Tensor, gates: Tensor, n_experts: int, cap: int) -> dict:
    """Slots of the (T, k) choices `idx`: "pos" each pair's rank in its
    expert (token-major), "slot" its flat index e * cap + pos in the
    (E * cap) buffer or E * cap where dropped, "order" each token's
    choices by ascending expert, and the inverse map "tid" / "gbuf" (E *
    cap,): the token that fills each slot (0 where empty) and its gate (0
    where empty)."""
    t, k = idx.shape
    e_flat = idx.reshape(-1)
    # a pair's rank among its expert's pairs in token-major order (the
    # reference's one-hot cumsum): a stable sort groups the pairs by
    # expert, and the rank is a pair's place there less its group's first
    order = torch.sort(e_flat, stable=True).indices
    grouped = e_flat[order]
    pos = torch.empty_like(e_flat)
    pos[order] = torch.arange(e_flat.numel(), device=idx.device) \
        - torch.searchsorted(grouped, grouped)
    n = n_experts * cap
    slot = torch.where(pos < cap, e_flat * cap + pos, n)
    # every kept pair has a slot of its own; the dropped ones all write
    # the spare entry n, which is cut off
    tid = torch.zeros(n + 1, dtype=torch.long, device=idx.device)
    tid[slot] = torch.arange(t, device=idx.device).repeat_interleave(k)
    gbuf = torch.zeros(n + 1, dtype=gates.dtype, device=idx.device)
    gbuf[slot] = gates.reshape(-1)
    return {"pos": pos.reshape(t, k), "slot": slot.reshape(t, k),
            "order": idx.argsort(dim=-1), "tid": tid[:n], "gbuf": gbuf[:n]}


def _ordered_sum(rows: Tensor, slot: Tensor, order: Tensor,
                 scale: Tensor | None = None) -> Tensor:
    """out[t] = sum over j of rows[slot[t, order[t, j]]] (times
    scale[t, order[t, j]]), added from 0.0 in j order; `rows` carries a
    zero row at the dropped pairs' index."""
    terms = rows[slot.gather(1, order)]                     # (T, k, d)
    if scale is not None:
        terms = terms * scale.gather(1, order)[..., None]
    out = torch.zeros_like(terms[:, 0])
    for j in range(slot.shape[1]):
        out = out + terms[:, j]
    return out


def _pad_row(x: Tensor) -> Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


class _Dispatch(torch.autograd.Function):
    """xbuf[s] = x[tid[s]] * mask[s]; backward: each token's gradient is
    the sum of its slots' in ascending expert order."""

    @staticmethod
    def forward(ctx, x, tid, mask, slot, order):
        ctx.save_for_backward(mask, slot, order)
        return x[tid] * mask[:, None]

    @staticmethod
    def backward(ctx, g):
        mask, slot, order = ctx.saved_tensors
        return (_ordered_sum(_pad_row(g * mask[:, None]), slot, order),
                None, None, None, None)


class _Combine(torch.autograd.Function):
    """y[t] = sum of ybuf[slot] * gate over t's kept choices in ascending
    expert order, from 0.0; backward: d ybuf[s] = dy[tid[s]] * gbuf[s] (a
    gather), d gate[t, j] = dy[t] . ybuf[slot[t, j]] (a row dot)."""

    @staticmethod
    def forward(ctx, ybuf, gates, slot, order, tid, gbuf):
        yp = _pad_row(ybuf)
        ctx.save_for_backward(yp, slot, tid, gbuf)
        return _ordered_sum(yp, slot, order, gates)

    @staticmethod
    def backward(ctx, g):
        yp, slot, tid, gbuf = ctx.saved_tensors
        dy = g[tid] * gbuf[:, None] if ctx.needs_input_grad[0] else None
        dg = (g[:, None] * yp[slot]).sum(-1) if ctx.needs_input_grad[1] \
            else None
        return dy, dg, None, None, None, None


def moe_local(cfg: QConfig, acfg, x: Tensor, rw: Tensor, wg: Tensor,
              wu: Tensor, wd: Tensor, dropless: bool = False) -> Tensor:
    """The reference's `_moe_local` on one device: x (T, d) fp32 -> (T, d)."""
    t, d = x.shape
    e, k = acfg.moe_experts, acfg.moe_topk
    cap = capacity(acfg, t, dropless)
    idx, gates = router(x, rw, k)
    r = route(idx, gates, e, cap)
    xbuf = _Dispatch.apply(x, r["tid"], r["gbuf"] != 0, r["slot"],
                           r["order"]).reshape(e, cap, d)
    # quantized expert matmuls (SwiGLU), batched over the experts
    gate = qact(cfg, acfg.act,
                qeinsum(cfg, "ecd,edf->ecf", "default", True, xbuf,
                        qweight(cfg, wg)))
    up = qact(cfg, "none",
              qeinsum(cfg, "ecd,edf->ecf", "default", True, xbuf,
                      qweight(cfg, wu)))
    h = qact(cfg, "none", gate * up)
    ybuf = qeinsum(cfg, "ecf,efd->ecd", "default", True, h, qweight(cfg, wd))
    return _Combine.apply(ybuf.reshape(e * cap, d), gates, r["slot"],
                          r["order"], r["tid"], r["gbuf"])


def moe_ffn(cfg: QConfig, acfg, x, p: dict, tp_size: int = 1) -> Tensor:
    """x: (B, S, D) on the activation grid (Tensor or QTensor, taken as its
    fp32 carrier) -> (B, S, D).  Decode (S == 1) is dropless."""
    if tp_size > 1:
        raise NotImplementedError(
            "expert-parallel MoE (tp_size > 1) is not ported yet: ROADMAP "
            "Queue 1 item 5")
    x = qt_carrier(x)
    b, s, d = x.shape
    y = moe_local(cfg, acfg, x.reshape(b * s, d), p["router"], p["wg"],
                  p["wu"], p["wd"], dropless=s == 1)
    return y.reshape(b, s, d)
