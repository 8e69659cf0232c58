"""Hybrid LM (zamba2-7b): a Mamba2 backbone and ONE shared attention + MLP
block applied after every `attn_every` Mamba2 layers.

Port of `repro.models.hybrid.Zamba2`.  Layer layout for L layers, ae =
attn_every, G = L // ae groups:

    [ae mamba2] shared [ae mamba2] shared ... [L - G ae mamba2 (the tail)]

Every application of the shared block uses the same parameters (the
training gradient is the sum over its applications, which autograd
accumulates), and each application has its own KV: G KV layers in a
cache or in the page pool.  The block is the LM's pre-norm attention and
SwiGLU sublayers (`transformer.attn_sublayer` / `ffn_sublayer`): in train
mode and monolithic prefill its attention runs on the flash kernel (K5;
head_dim 112 at full width), in the engine's chunked prefill on a paged
prefill page, in the engine's decode on the fused paged kernel (K6), or
on K7 + decode attention with `fuse_kernels=False`, and in `serve_step`
against a dense int8 cache (batched K1).

Serving splits a lane's state across both of the engine's stores: the
Mamba2 state (the conv window and the SSD state of every layer) in dense
per-lane slots, the shared block's KV in pool pages (one logical page
spans all G applications).  `prefill_page` returns the dense state after
its page: the page-boundary snapshot the radix cache keeps per node, since
it is a pure function of the token prefix (so a prefix hit restores it
bit for bit).

Weights keep the reference's tree and layouts: `layers` (stacked (L, ...)
Mamba2 leaves: ln, in_proj, conv_w, conv_b, bc_proj, dt_proj, dt_bias,
A_log, D_skip, ssm_norm, out_proj), `shared` (ln1, wq, wk, wv, wo, ln2,
w_gate, w_up, w_down), `embed` (Vp, d), `final_norm` (d,), `lm_head`
(d, Vp); the embedding and lm_head are exempt from quantization.  The
parameters require grad; the serving entry points run under no_grad.
Tensor parallelism (tp_size > 1) is not ported (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qrmsnorm
from repro_torch.core.qconfig import QConfig
from repro_torch.device import resolve_device

from . import layers as L
from . import ssm as S
from .transformer import attn_sublayer, ffn_sublayer

Tensor = torch.Tensor

SHARED_LABELS = {"ln1": "gamma", "wq": "w", "wk": "w", "wv": "w", "wo": "w",
                 "ln2": "gamma", "w_gate": "w", "w_up": "w", "w_down": "w"}


class Zamba2(nn.Module):
    def __init__(self, acfg: ArchConfig, qcfg: QConfig, device="cuda",
                 tp_size: int = 1):
        super().__init__()
        if acfg.family != "hybrid" or acfg.ssm_kind != "mamba2":
            raise NotImplementedError(
                f"Zamba2 builds the Mamba2 hybrid (got family "
                f"{acfg.family!r}, {acfg.ssm_kind or 'no ssm_kind'})")
        if tp_size != 1:
            raise NotImplementedError(
                "tensor-parallel Zamba2 is not ported yet: ROADMAP Queue 1 "
                "item 5")
        qcfg.validate()
        self.a, self.q = acfg, qcfg
        self.device = resolve_device(device)
        a = acfg
        self.n_groups = a.n_layers // a.attn_every
        self.tail = a.n_layers - self.n_groups * a.attn_every
        d, dh, h, kv, f = a.d_model, a.dh, a.n_heads, a.n_kv, a.d_ff

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=self.device))

        self.layers = nn.ParameterDict({
            k: param((a.n_layers,) + s)
            for k, s in S.mamba2_shapes(a).items()})
        self.shared = nn.ParameterDict({
            k: param(s) for k, s in (
                ("ln1", (d,)), ("wq", (d, h * dh)), ("wk", (d, kv * dh)),
                ("wv", (d, kv * dh)), ("wo", (h * dh, d)), ("ln2", (d,)),
                ("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))})
        self.embed = param((a.vocab_padded, d))
        self.final_norm = param((d,))
        self.lm_head = param((d, a.vocab_padded))

    # ---------------- params ----------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Zamba2":
        """Random weights from a torch.Generator by the reference's init
        formulas (`mamba2_init` per layer, winit for the shared block's
        weights, ones for the norm gains, N(0, 0.02^2) for the exempt
        embedding and head).  Same distributions as the reference's
        `init`, not the same bits."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for p in self._layer_views():
            S.mamba2_init_(self.q, self.a, p, gen)
        for k, p in self.shared.items():
            if SHARED_LABELS[k] == "gamma":
                p.fill_(1.0)
            else:
                L.winit_(self.q, p, p.shape[0], gen)
        self.embed.normal_(generator=gen).mul_(0.02)
        self.lm_head.normal_(generator=gen).mul_(0.02)
        self.final_norm.fill_(1.0)
        return self

    @torch.no_grad()
    def load_params(self, params: dict) -> "Zamba2":
        """Copy a {"embed", "layers": {...}, "shared": {...},
        "final_norm", "lm_head"} tree of tensors or arrays in the reference
        layout into this module."""
        for k, p in self.layers.items():
            p.copy_(torch.as_tensor(params["layers"][k]))
        for k, p in self.shared.items():
            p.copy_(torch.as_tensor(params["shared"][k]))
        for k in ("embed", "final_norm", "lm_head"):
            getattr(self, k).copy_(torch.as_tensor(params[k]))
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params(self) -> dict:
        """The parameter tree in the reference's layout (live tensors)."""
        return {"embed": self.embed, "final_norm": self.final_norm,
                "layers": dict(self.layers), "lm_head": self.lm_head,
                "shared": dict(self.shared)}

    def labels(self) -> dict:
        return {"embed": "exempt", "layers": S.mamba2_labels(),
                "shared": dict(SHARED_LABELS), "final_norm": "gamma",
                "lm_head": "exempt"}

    # ---------------- forward ----------------

    def _layer_views(self) -> list[dict]:
        """Per-layer views of the stacked Mamba2 parameters, made by ONE
        unbind per tensor, so the backward assembles each stacked gradient
        once."""
        per = {k: p.unbind(0) for k, p in self.layers.items()}
        return [{k: v[i] for k, v in per.items()}
                for i in range(self.a.n_layers)]

    def _backbone(self, x: Tensor, pos, mode: str, cache: dict | None,
                  emit: list | None = None):
        """Every Mamba2 layer and every application of the shared block in
        the reference's order.  mode "train" (zero Mamba2 state; `emit`
        receives each application's (k, v) int8 payloads), "chunk" (one
        page of one lane) or "decode" (one token a lane); `cache` holds
        the stacked Mamba2 state "m_conv" (L, B, K-1, d_inner) and "m_h"
        (L, B, heads, N, headdim) in "chunk" / "decode" mode, and the
        shared block's KV: the pool's (G, P, page, KV, dh) "k_pages" /
        "v_pages" with "table" (and "pos0" in chunk mode), or a dense
        (G, B, T, KV, dh) "k" / "v".  Returns (x, the new Mamba2 state
        {"m_conv", "m_h"} stacked (L, ...))."""
        a, q = self.a, self.q
        if mode == "train":
            return self._train_backbone(x, pos, emit)
        stacks = ("k", "v") if cache and "k" in cache \
            else ("k_pages", "v_pages")
        convs, hs = [], []
        for i, p in enumerate(self._layer_views()):
            st = None if mode == "train" else {"conv": cache["m_conv"][i],
                                               "h": cache["m_h"][i]}
            x, ns = S.mamba2_block(q, a, p, x, mode, st)
            convs.append(ns["conv"])
            hs.append(ns["h"])
            g, last = divmod(i + 1, a.attn_every)
            if last:            # not the end of a group (or a tail layer)
                continue
            kv = None if mode == "train" else dict(
                cache, k_scale=cache["k_scale"][g - 1],
                v_scale=cache["v_scale"][g - 1],
                **{k: cache[k][g - 1] for k in stacks})
            x = attn_sublayer(a, q, self.shared, x, pos, mode, kv, emit)
            x = ffn_sublayer(a, q, self.shared, x)
        return x, {"m_conv": torch.stack(convs), "m_h": torch.stack(hs)}

    def _train_backbone(self, x: Tensor, pos, emit: list | None):
        """`_backbone` in train mode, nested as the reference's remat is:
        each Mamba2 layer checkpointed, each group of `attn_every` layers
        with the shared block after it checkpointed again, and each tail
        layer (remat "full"; plain calls with remat "none")."""
        a, q = self.a, self.q
        views = self._layer_views()
        mbody = L.maybe_remat(a, lambda h, p: S.mamba2_block(
            q, a, p, h, "train"))

        def group(h, ps):
            sts = []
            for p in ps:
                h, st = mbody(h, p)
                sts.append(st)
            h = attn_sublayer(a, q, self.shared, h, pos, "train", None, emit)
            return ffn_sublayer(a, q, self.shared, h), sts

        gbody = L.maybe_remat(a, group)
        ae, sts = a.attn_every, []
        n_groups = a.n_layers // ae
        for g in range(n_groups):
            x, gs = gbody(x, views[g * ae:(g + 1) * ae])
            sts += gs
        for p in views[n_groups * ae:]:
            x, st = mbody(x, p)
            sts.append(st)
        return x, {"m_conv": torch.stack([s["conv"] for s in sts]),
                   "m_h": torch.stack([s["h"] for s in sts])}

    def _logits(self, x: Tensor) -> Tensor:
        h = qrmsnorm(self.q, x, self.final_norm)
        logits = torch.matmul(h, self.lm_head)          # exempt last layer
        if self.a.vocab_padded != self.a.vocab:
            pad = torch.arange(self.a.vocab_padded,
                               device=logits.device) >= self.a.vocab
            logits = torch.where(pad, torch.full_like(logits, L.NEG_INF),
                                 logits)
        return logits

    def _embed(self, tokens) -> Tensor:
        return self.embed[torch.as_tensor(tokens, device=self.device).long()]

    # ---------------- training ----------------

    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """Mean next-token cross entropy of {"tokens", "labels"} (B, S):
        logsumexp minus the label's logit over fp32 logits.  Returns
        (loss, {"loss"}), as the reference's loss does."""
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x = self._embed(batch["tokens"])              # exempt first layer
        pos = torch.arange(x.shape[1], device=self.device)
        x, _ = self._backbone(x, pos, "train", None)
        logits = self._logits(x)
        lse = torch.logsumexp(logits, dim=-1)
        loss = torch.mean(lse - L.target_logit(logits, labels))
        return loss, {"loss": loss.detach()}

    # ---------------- serving: monolithic prefill, dense-cache decode ----

    def init_cache(self, b: int, t: int) -> dict:
        """Zero Mamba2 state for every layer and a dense int8 KV cache of t
        positions for every application of the shared block."""
        a = self.a
        st = S.mamba2_state_init(a, b, self.device)
        cache = L.kv_cache_init(self.n_groups, b, t, a.n_kv, a.dh,
                                self.device)
        cache["m_conv"] = st["conv"].repeat(a.n_layers, 1, 1, 1)
        cache["m_h"] = st["h"].repeat(a.n_layers, 1, 1, 1, 1)
        return cache

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int) -> tuple[dict, Tensor]:
        """Monolithic prefill: the (B, S) prompt through the train-mode
        backbone (the shared attention on the flash kernel K5), each
        application emitting its int8 KV.  Returns (a dense cache of
        `cache_len` positions holding the KV and every layer's Mamba2
        state, "pos" S; the last token's logits (B, Vp))."""
        x = self._embed(tokens)
        b, s = x.shape[:2]
        emit: list = []
        x, st = self._backbone(x, torch.arange(s, device=self.device),
                               "train", None, emit)
        cache = self.init_cache(b, cache_len)
        for g, (k8, v8) in enumerate(emit):
            cache["k"][g, :, :s], cache["v"][g, :, :s] = k8, v8
        cache.update(st)
        cache["pos"].fill_(s)
        return cache, self._logits(x[:, -1:])[:, 0]

    @torch.no_grad()
    def serve_step(self, cache: dict, tokens) -> tuple[dict, Tensor]:
        """One decode token per sequence against a dense cache (the KV
        written IN PLACE at cache["pos"]).  Returns (the cache with the new
        Mamba2 state and pos + 1, logits (B, Vp))."""
        x = self._embed(tokens)[:, None, :]
        x, st = self._backbone(x, cache["pos"], "decode", cache)
        return dict(cache, **st, pos=cache["pos"] + 1), self._logits(x)[:, 0]

    # ---------------- serving decode-state slot API ----------------

    def decode_state_spec(self) -> dict:
        a = self.a
        return {"kv_layers": self.n_groups, "n_kv": a.n_kv, "dh": a.dh,
                "dense_axes": {"m_conv": 1, "m_h": 1, "pos": 0}}

    def init_slots(self, n_lanes: int) -> dict:
        a = self.a
        st = S.mamba2_state_init(a, n_lanes, self.device)
        return {"m_conv": st["conv"].repeat(a.n_layers, 1, 1, 1),
                "m_h": st["h"].repeat(a.n_layers, 1, 1, 1, 1),
                "pos": torch.zeros((n_lanes,), dtype=torch.int32,
                                   device=self.device)}

    def slot_from_cache(self, cache: dict, b: int = 0):
        """Sequence `b` of a prefill cache -> (dense slot values, (k, v)
        payloads (G, T, KV, dh) int8 for the engine's pages)."""
        return ({"m_conv": cache["m_conv"][:, b], "m_h": cache["m_h"][:, b],
                 "pos": cache["pos"][b]},
                (cache["k"][:, b], cache["v"][:, b]))

    @torch.no_grad()
    def paged_decode_step(self, slots: dict, pool_view: dict,
                          tokens: Tensor) -> tuple[Tensor, dict]:
        """One decode step over all lanes: the Mamba2 states advance in the
        dense slots (dead lanes' too, as in the reference), the shared
        block's KV is written into and read from the pool's pages IN PLACE.
        Returns (logits (B, Vp), new slots); positions are the engine's,
        so "pos" passes through."""
        x = self.embed[tokens.long()][:, None, :]
        x, st = self._backbone(x, slots["pos"], "decode",
                               dict(pool_view, **slots))
        return self._logits(x)[:, 0], dict(st, pos=slots["pos"])

    @torch.no_grad()
    def prefill_page(self, dense: dict, pool_view: dict, tokens: Tensor,
                     pos0: int) -> tuple[Tensor, dict]:
        """Chunked prefill: ONE page (page,) of one lane's prompt from
        position pos0.  The Mamba2 states advance through the page in
        "chunk" mode from `dense` (B = 1), the shared block's KV page lands
        in the pool IN PLACE.  Returns (the last token's logits (1, Vp),
        the dense state after the page: the radix cache's snapshot)."""
        page = pool_view["k_pages"].shape[2]
        x = self.embed[tokens.long()][None]
        pos = pos0 + torch.arange(page, device=x.device)
        x, st = self._backbone(x, pos, "chunk",
                               dict(pool_view, pos0=pos0, **dense))
        return self._logits(x[:, -1:])[:, 0], dict(st, pos=dense["pos"])
