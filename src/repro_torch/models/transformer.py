"""Decoder-only LM (granite-3-8b, granite-34b, phi4-mini-3.8b, minitron-4b,
chameleon-34b's early-fusion VLM on token ids, and the MoE LMs
granite-moe-1b-a400m and moonshot-v1-16b-a3b): training loss and paged
serving.

Port of `repro.models.transformer.LMTransformer`: `train` mode (the loss
of the training step: chunked causal attention, through the flash kernel
in native mode, backward by autograd) and the serving modes: monolithic `prefill` (train
mode over the whole prompt, emitting the int8 KV into a dense cache),
`chunk` (chunked prefill, one lane, one page of tokens) and `decode` (one
token per lane, against the paged pool or a dense cache), driven through
the decode-state slot API the engine uses (`paged_decode_step`,
`prefill_page`, `slot_from_cache`) or directly (`prefill`, `serve_step`).

Weights keep the reference's layouts: stacked per-layer tensors (L, ...)
in `layers` (ln1, wq, wk, wv, wo, ln2, w_gate, w_up, w_down; an MoE LM
has `moe` {router (L, d, E), wg, wu (L, E, d, f), wd (L, E, f, d)} in
place of the last three, models/moe.py), `embed` (Vp, d), `final_norm`
(d,), `lm_head` (d, Vp).  The embedding and lm_head are exempt from
quantization (the paper's first/last layer rule); every
hidden matmul, norm and activation goes through the WAGEUBN ops.  The
parameters require grad; the serving entry points run under no_grad.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qact, qdense
from repro_torch.core.qconfig import QConfig
from repro_torch.device import resolve_device

from . import layers as L
from . import moe as MOE

Tensor = torch.Tensor

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
              "w_down")


def attn_sublayer(a: ArchConfig, q: QConfig, p: dict, x: Tensor, pos, mode,
                  cache, emit=None) -> Tensor:
    """One pre-norm attention sublayer, x + wo(attention(x)), with the
    parameters `p` (ln1, wq, wk, wv, wo): the LM's layers and the hybrid's
    shared block.  In train mode, `emit` (a list) receives the layer's (k,
    v) int8 payloads on the cache grid (2^-7), the monolithic prefill's KV.
    Otherwise `cache` holds a dense cache's (B, T, KV, dh) "k"/"v" (decode
    at per-lane positions) or the pool's (P, page, KV, dh) "k_pages" /
    "v_pages" and "table" ("chunk": one lane, one page of positions from
    "pos0"; "decode": one token a lane), written IN PLACE."""
    b, s, _ = x.shape
    h = qact(q, "none", L.norm(q, a.norm, x, p["ln1"]))
    qh = qdense(q, h, p["wq"]).reshape(b, s, a.n_heads, a.dh)
    kh = qdense(q, h, p["wk"]).reshape(b, s, a.n_kv, a.dh)
    vh = qdense(q, h, p["wv"]).reshape(b, s, a.n_kv, a.dh)
    if mode == "train":
        qh, kh = L.rope(qh, pos, a.rope_theta), L.rope(kh, pos, a.rope_theta)
        qh, kh, vh = (qact(q, "none", t) for t in (qh, kh, vh))
        o = L.chunked_attention(q, qh, kh, vh, causal=True, q_pos=pos,
                                k_pos=pos, q_chunk=a.q_chunk,
                                kv_chunk=a.kv_chunk)
        if emit is not None:
            emit.append((L.kv_quantize(kh, 2.0 ** -7),
                         L.kv_quantize(vh, 2.0 ** -7)))
        o = o.reshape(b, s, a.n_heads * a.dh)
        return x + qdense(q, o, p["wo"])
    ks, vs = cache["k_scale"], cache["v_scale"]
    if "k" in cache:    # decode against a dense cache (B, T, KV, dh)
        rp = pos.reshape(b, 1)
        qh, kh = L.rope(qh, rp, a.rope_theta), L.rope(kh, rp, a.rope_theta)
        qh, kh, vh = (qact(q, "none", t) for t in (qh, kh, vh))
        lanes, at = torch.arange(b, device=x.device), pos.long()
        cache["k"][lanes, at] = L.kv_quantize(kh[:, 0], ks)
        cache["v"][lanes, at] = L.kv_quantize(vh[:, 0], vs)
        o = L.decode_attention(q, qh, L.kv_qtensor(cache["k"], ks),
                               L.kv_qtensor(cache["v"], vs), q_pos=pos,
                               t_valid=pos.max() + 1)
        o = o.reshape(b, s, a.n_heads * a.dh)
        return x + qdense(q, o, p["wo"])
    kp, vp, table = cache["k_pages"], cache["v_pages"], cache["table"]
    if mode == "chunk":
        # chunked prefill: ONE lane, s == page_size tokens filling one
        # pool page; every amax spans this page alone
        qh, kh = L.rope(qh, pos, a.rope_theta), L.rope(kh, pos, a.rope_theta)
        qh, kh, vh = (qact(q, "none", t) for t in (qh, kh, vh))
        # an index past the table clamps, as the reference's gather does
        blk = min(cache["pos0"] // kp.shape[1], table.shape[1] - 1)
        pid = table[0, blk]
        L.page_write(kp, pid, L.kv_quantize(kh[0], ks))
        L.page_write(vp, pid, L.kv_quantize(vh[0], vs))
        o = L.paged_prefill_attention(q, qh, kp, vp, table, ks, vs,
                                      q_pos=pos)
    else:       # decode: s == 1, pos (B,)
        rp = pos.reshape(b, 1)
        qh, kh = L.rope(qh, rp, a.rope_theta), L.rope(kh, rp, a.rope_theta)
        qh, kh, vh = (qact(q, "none", t) for t in (qh, kh, vh))
        L.page_scatter_token(kp, table, pos, L.kv_quantize(kh[:, 0], ks))
        L.page_scatter_token(vp, table, pos, L.kv_quantize(vh[:, 0], vs))
        o = L.paged_decode_attention(q, qh, kp, vp, table, ks, vs,
                                     q_pos=pos, t_valid=pos.max() + 1)
    o = o.reshape(b, s, a.n_heads * a.dh)
    return x + qdense(q, o, p["wo"])


def ffn_sublayer(a: ArchConfig, q: QConfig, p: dict, x: Tensor) -> Tensor:
    """One pre-norm feed-forward sublayer, x + FFN(x): SwiGLU with (ln2,
    w_gate, w_up, w_down), or an MoE LM's experts (p["moe"])."""
    h = qact(q, "none", L.norm(q, a.norm, x, p["ln2"]))
    if a.moe_experts:       # decode (one token a lane) is dropless
        return x + MOE.moe_ffn(q, a, h, p["moe"])
    return x + L.swiglu(q, h, p["w_gate"], p["w_up"], p["w_down"], a.act)


class LMTransformer(nn.Module):
    def __init__(self, acfg: ArchConfig, qcfg: QConfig, device="cuda"):
        super().__init__()
        if acfg.family not in ("lm", "vlm", "moe"):
            raise NotImplementedError(
                f"LMTransformer does not build family {acfg.family!r} "
                "(build_model gives 'ssm' SSMLM, 'hybrid' Zamba2, 'encdec' "
                "EncDec and 'resnet' ResNet)")
        qcfg.validate()
        self.a, self.q = acfg, qcfg
        self.device = resolve_device(device)
        a = acfg
        d, dh, h, kv, f = a.d_model, a.dh, a.n_heads, a.n_kv, a.d_ff
        nl, vp = a.n_layers, a.vocab_padded
        shapes = {"ln1": (nl, d), "wq": (nl, d, h * dh),
                  "wk": (nl, d, kv * dh), "wv": (nl, d, kv * dh),
                  "wo": (nl, h * dh, d), "ln2": (nl, d)}
        if not a.moe_experts:
            shapes.update(w_gate=(nl, d, f), w_up=(nl, d, f),
                          w_down=(nl, f, d))

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=self.device))

        self.layers = nn.ParameterDict({k: param(s) for k, s in shapes.items()})
        # the experts' stacked tree ("moe" in the layers of the reference's)
        self.moe = nn.ParameterDict(
            {k: param(s) for k, s in MOE.moe_shapes(a, nl).items()}) \
            if a.moe_experts else None
        self.embed = param((vp, d))
        self.final_norm = param((d,))
        self.lm_head = param((d, vp))

    # ---------------- params ----------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "LMTransformer":
        """Random weights from a torch.Generator by the reference's init
        formulas (winit for hidden weights, N(0, 0.02^2) for the exempt
        embedding, head and router, ones for the norm gains).  Same
        distributions as the reference's `init`, not the same bits."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for k, p in self.layers.items():
            if k in ("ln1", "ln2"):
                p.fill_(1.0)
                continue
            for i in range(p.shape[0]):      # (L, fan_in, fan_out), in place
                L.winit_(self.q, p[i], p.shape[1], gen)
        if self.moe is not None:
            MOE.init_moe_params_(self.q, self.moe, gen)
        self.embed.normal_(generator=gen).mul_(0.02)
        self.lm_head.normal_(generator=gen).mul_(0.02)
        self.final_norm.fill_(1.0)
        return self

    @torch.no_grad()
    def load_params(self, params: dict) -> "LMTransformer":
        """Copy a {"embed", "layers": {...}, "final_norm", "lm_head"} tree of
        tensors or arrays in the reference layout into this module."""
        for k, p in self.layers.items():
            p.copy_(torch.as_tensor(params["layers"][k]))
        for k, p in (self.moe or {}).items():
            p.copy_(torch.as_tensor(params["layers"]["moe"][k]))
        for k in ("embed", "final_norm", "lm_head"):
            getattr(self, k).copy_(torch.as_tensor(params[k]))
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---------------- forward ----------------

    def _layer(self, i: int) -> dict:
        p = {k: w[i] for k, w in self.layers.items()}
        if self.moe is not None:
            p["moe"] = {k: w[i] for k, w in self.moe.items()}
        return p

    def _layer_views(self) -> list[dict]:
        """Per-layer views of the stacked parameters, made by ONE unbind
        per tensor, so the backward assembles each stacked gradient once."""
        per = {k: p.unbind(0) for k, p in self.layers.items()}
        moe = {k: p.unbind(0) for k, p in (self.moe or {}).items()}
        views = []
        for i in range(self.a.n_layers):
            v = {k: w[i] for k, w in per.items()}
            if moe:
                v["moe"] = {k: w[i] for k, w in moe.items()}
            views.append(v)
        return views

    def _backbone(self, x, pos, mode, view):
        """Every layer against `view`: the paged pool's or a dense cache's
        (L, ...) stacks, sliced per layer."""
        stacks = ("k", "v") if "k" in view else ("k_pages", "v_pages")
        for i in range(self.a.n_layers):
            cache = dict(view, k_scale=view["k_scale"][i],
                         v_scale=view["v_scale"][i],
                         **{k: view[k][i] for k in stacks})
            p = self._layer(i)
            x = attn_sublayer(self.a, self.q, p, x, pos, mode, cache)
            x = ffn_sublayer(self.a, self.q, p, x)
        return x

    def _logits(self, x):
        h = L.norm(self.q, self.a.norm, x, self.final_norm)
        logits = torch.matmul(h, self.lm_head)          # exempt last layer
        if self.a.vocab_padded != self.a.vocab:
            pad = torch.arange(self.a.vocab_padded,
                               device=logits.device) >= self.a.vocab
            logits = torch.where(pad, torch.full_like(logits, L.NEG_INF),
                                 logits)
        return logits

    # ---------------- training ----------------

    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """Mean next-token cross entropy of {"tokens", "labels"} (B, S):
        logsumexp minus the label's logit over fp32 logits.  Returns
        (loss, {"loss"}), as the reference's loss does."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x = self.embed[tokens]                        # exempt first layer
        pos = torch.arange(tokens.shape[1], device=self.device)

        def body(h, p):
            h = attn_sublayer(self.a, self.q, p, h, pos, "train", None)
            return ffn_sublayer(self.a, self.q, p, h)
        body = L.maybe_remat(self.a, body)
        for p in self._layer_views():
            x = body(x, p)
        logits = self._logits(x)
        lse = torch.logsumexp(logits, dim=-1)
        loss = torch.mean(lse - L.target_logit(logits, labels))
        return loss, {"loss": loss.detach()}

    def params(self) -> dict:
        """The parameter tree in the reference's layout (live tensors)."""
        layers = dict(self.layers)
        if self.moe is not None:
            layers["moe"] = dict(self.moe)
        return {"embed": self.embed, "final_norm": self.final_norm,
                "layers": layers, "lm_head": self.lm_head}

    def labels(self) -> dict:
        """Optimizer label per leaf: "w" (CQ), "gamma" (15-bit), "exempt"
        (first/last layer, vanilla momentum)."""
        layer = {k: ("gamma" if k in ("ln1", "ln2") else "w")
                 for k in self.layers}
        if self.moe is not None:
            layer["moe"] = MOE.moe_labels()
        return {"embed": "exempt", "final_norm": "gamma", "layers": layer,
                "lm_head": "exempt"}

    # ---------------- serving: monolithic prefill, dense-cache decode ----

    def init_cache(self, b: int, t: int) -> dict:
        a = self.a
        return L.kv_cache_init(a.n_layers, b, t, a.n_kv, a.dh, self.device)

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int) -> tuple[dict, Tensor]:
        """Monolithic prefill: the (B, S) prompt through the train-mode
        layers (chunked causal attention, the flash kernel K5), each layer
        emitting its int8 KV.  Returns (a dense cache of `cache_len`
        positions holding them, "pos" S; the last token's logits (B, Vp))."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        x = self.embed[tokens]
        pos = torch.arange(s, device=self.device)
        cache = self.init_cache(b, cache_len)
        for i in range(self.a.n_layers):
            p, emit = self._layer(i), []
            x = attn_sublayer(self.a, self.q, p, x, pos, "train", None, emit)
            cache["k"][i, :, :s], cache["v"][i, :, :s] = emit[0]
            x = ffn_sublayer(self.a, self.q, p, x)
        cache["pos"].fill_(s)
        return cache, self._logits(x[:, -1:])[:, 0]

    @torch.no_grad()
    def serve_step(self, cache: dict, tokens) -> tuple[dict, Tensor]:
        """One decode token per sequence against a dense cache (written IN
        PLACE at cache["pos"]).  Returns (the cache with pos + 1, logits
        (B, Vp))."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = self.embed[tokens][:, None, :]
        x = self._backbone(x, cache["pos"], "decode", cache)
        return dict(cache, pos=cache["pos"] + 1), self._logits(x)[:, 0]

    # ---------------- serving decode-state slot API ----------------

    def decode_state_spec(self):
        a = self.a
        return {"kv_layers": a.n_layers, "n_kv": a.n_kv, "dh": a.dh,
                "dense_axes": {"pos": 0}}

    def init_slots(self, n_lanes: int) -> dict:
        return {"pos": torch.zeros((n_lanes,), dtype=torch.int32,
                                   device=self.device)}

    def slot_from_cache(self, cache: dict, b: int = 0):
        """Sequence `b` of a prefill cache -> (dense slot values, (k, v)
        payloads (L, T, KV, dh) int8 for the engine's pages)."""
        return ({"pos": cache["pos"][b]},
                (cache["k"][:, b], cache["v"][:, b]))

    @torch.no_grad()
    def paged_decode_step(self, slots: dict, pool_view: dict,
                          tokens: Tensor) -> tuple[Tensor, dict]:
        """One decode step over all lanes against the paged pool.

        slots: {"pos": (B,)}, each lane's position (the engine's); pool_view:
        {"k_pages"/"v_pages": (L, P, page, KV, dh) int8, "k_scale"/"v_scale":
        (L,), "table": (B, NB)}; tokens: (B,).  Writes each lane's new KV
        into its page slot IN PLACE.  Returns (logits (B, Vp), slots), the
        reference's slot API (this family's dense state is its positions,
        which the engine advances)."""
        x = self.embed[tokens.long()][:, None, :]
        x = self._backbone(x, slots["pos"], "decode", pool_view)
        return self._logits(x)[:, 0], slots

    @torch.no_grad()
    def prefill_page(self, dense: dict, pool_view: dict, tokens: Tensor,
                     pos0: int) -> tuple[Tensor, dict]:
        """Chunked prefill: run ONE page of one lane's prompt.

        dense: the lane's mid-prefill state ({"pos"}, passed through);
        tokens: (page,); pos0: the page's first position (a multiple of
        page_size); pool_view as in `paged_decode_step` with a (1, NB)
        table.  Writes the page's KV into the pool IN PLACE and attends to
        every earlier position through the table.  Returns (the last
        token's logits (1, Vp), dense)."""
        page = pool_view["k_pages"].shape[2]
        x = self.embed[tokens.long()][None]
        pos = pos0 + torch.arange(page, device=x.device)
        x = self._backbone(x, pos, "chunk", dict(pool_view, pos0=pos0))
        return self._logits(x[:, -1:])[:, 0], dense
