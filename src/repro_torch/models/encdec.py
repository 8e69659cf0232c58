"""Encoder-decoder backbone (seamless-m4t-large-v2): training loss and
dense-cache serving.

Port of `repro.models.encdec.EncDec`.  The modality frontend is a stub, as
in the reference: the encoder takes precomputed frame embeddings (B, S,
d_model), the exempt first layer.  The encoder is the conformer's
transformer backbone (non-causal self-attention and MLP blocks, no
positions, no final norm); each decoder layer adds cross-attention over
the encoder memory.  Every norm is a quantized LayerNorm (the UBN kernel,
K4, kind "layer", in native mode), the MLP is gelu's two-matrix `mlp`,
and training attention (the encoder's, the decoder's causal
self-attention and its cross-attention, 1024 queries over 4096 frames at
train_4k) goes through `chunked_attention` (the flash kernel K5 forward
in native mode).

Serving follows the reference's two entry points: `prefill(frames,
t_self)` encodes the source and writes each decoder layer's cross K/V
into an int8 cache at the fixed step 2^-7 (saturating requantize), and
`serve_step(cache, tokens)` decodes one token per sequence against that
cache and the self-attention cache, which it writes IN PLACE at "pos"
(with layer 0's scale, as the reference does).  Both decode attentions
are `decode_attention` over the int8 cache (batched K1 products); the
paged engine does not run this family, nor does the reference's.

Weights keep the reference's tree: `enc` and `dec` of stacked (L, ...)
leaves (ln_g, ln_b, wq, wk, wv, wo; the decoder's cross-attention the
same keys prefixed "x_"; mlp_ln_g, mlp_ln_b, w_up, w_down), `embed` (Vp,
d), `final_ln_g`, `final_ln_b` (d,) and `lm_head` (d, Vp).  The embedding
and lm_head are exempt from quantization.  The parameters require grad;
the serving entry points run under no_grad.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qact, qdense, qlayernorm
from repro_torch.core.qconfig import QConfig
from repro_torch.device import resolve_device

from . import layers as L

Tensor = torch.Tensor

ATTN_KEYS = ("ln_g", "ln_b", "wq", "wk", "wv", "wo")
MLP_KEYS = ("mlp_ln_g", "mlp_ln_b", "w_up", "w_down")
ENC_KEYS = ATTN_KEYS + MLP_KEYS
DEC_KEYS = ATTN_KEYS + tuple("x_" + k for k in ATTN_KEYS) + MLP_KEYS
_NORM_LABELS = {"ln_g": "gamma", "mlp_ln_g": "gamma", "ln_b": "beta",
                "mlp_ln_b": "beta"}


def _label(key: str) -> str:
    """The optimizer's label of a stacked leaf (the cross keys' too)."""
    return _NORM_LABELS.get(key.removeprefix("x_"), "w")


class EncDec(nn.Module):
    def __init__(self, acfg: ArchConfig, qcfg: QConfig, device="cuda",
                 tp_size: int = 1):
        super().__init__()
        if tp_size != 1:
            raise ValueError(
                f"{type(self).__name__} supports DP-only sharding "
                f"(manual TP shards attention heads / FFN / experts; "
                f"got tp_size={tp_size})")
        if acfg.family != "encdec":
            raise ValueError(f"EncDec builds family 'encdec', not "
                             f"{acfg.family!r}")
        qcfg.validate()
        self.a, self.q = acfg, qcfg
        self.device = resolve_device(device)
        a = acfg
        d, dh, h, kv, f = a.d_model, a.dh, a.n_heads, a.n_kv, a.d_ff

        def shape(key: str, nl: int) -> tuple:
            return {"ln_g": (nl, d), "ln_b": (nl, d), "wq": (nl, d, h * dh),
                    "wk": (nl, d, kv * dh), "wv": (nl, d, kv * dh),
                    "wo": (nl, h * dh, d), "mlp_ln_g": (nl, d),
                    "mlp_ln_b": (nl, d), "w_up": (nl, d, f),
                    "w_down": (nl, f, d)}[key.removeprefix("x_")]

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=self.device))

        self.enc = nn.ParameterDict(
            {k: param(shape(k, a.enc_layers)) for k in ENC_KEYS})
        self.dec = nn.ParameterDict(
            {k: param(shape(k, a.dec_layers)) for k in DEC_KEYS})
        self.embed = param((a.vocab_padded, d))
        self.final_ln_g = param((d,))
        self.final_ln_b = param((d,))
        self.lm_head = param((d, a.vocab_padded))

    # ---------------- params ----------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "EncDec":
        """Random weights from a torch.Generator by the reference's init
        formulas (winit for the hidden weights, N(0, 0.02^2) for the exempt
        embedding and head, ones and zeros for the LayerNorm gains and
        biases).  Same distributions as the reference's `init`, not the
        same bits."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for stack in (self.enc, self.dec):
            for k, p in stack.items():
                lab = _label(k)
                if lab != "w":
                    p.fill_(1.0 if lab == "gamma" else 0.0)
                    continue
                for i in range(p.shape[0]):  # (L, fan_in, fan_out), in place
                    L.winit_(self.q, p[i], p.shape[1], gen)
        self.embed.normal_(generator=gen).mul_(0.02)
        self.lm_head.normal_(generator=gen).mul_(0.02)
        self.final_ln_g.fill_(1.0)
        self.final_ln_b.fill_(0.0)
        return self

    @torch.no_grad()
    def load_params(self, params: dict) -> "EncDec":
        """Copy a tree of tensors or arrays in the reference's layout
        ({"enc", "dec", "embed", "final_ln_g", "final_ln_b", "lm_head"})
        into this module."""
        for name in ("enc", "dec"):
            for k, p in getattr(self, name).items():
                p.copy_(torch.as_tensor(params[name][k]))
        for k in ("embed", "final_ln_g", "final_ln_b", "lm_head"):
            getattr(self, k).copy_(torch.as_tensor(params[k]))
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params(self) -> dict:
        """The parameter tree in the reference's layout (live tensors)."""
        return {"enc": dict(self.enc), "dec": dict(self.dec),
                "embed": self.embed, "final_ln_g": self.final_ln_g,
                "final_ln_b": self.final_ln_b, "lm_head": self.lm_head}

    def labels(self) -> dict:
        """Optimizer label per leaf: "w" (CQ), "gamma" and "beta" (15-bit),
        "exempt" (first/last layer, vanilla momentum)."""
        return {"enc": {k: _label(k) for k in self.enc},
                "dec": {k: _label(k) for k in self.dec},
                "embed": "exempt", "final_ln_g": "gamma",
                "final_ln_b": "beta", "lm_head": "exempt"}

    # ---------------- forward ----------------

    @staticmethod
    def _views(stack: nn.ParameterDict) -> list[dict]:
        """Per-layer views of the stacked parameters, made by ONE unbind
        per tensor, so the backward assembles each stacked gradient once."""
        per = {k: p.unbind(0) for k, p in stack.items()}
        n = len(next(iter(per.values())))
        return [{k: w[i] for k, w in per.items()} for i in range(n)]

    def _attn(self, p, x, kv_src, *, causal: bool, q_pos, k_pos,
              cache=None, prefix=""):
        """One attention sublayer: self-attention when kv_src is None,
        cross-attention over kv_src otherwise.  `cache` holds precomputed
        cross K/V ("kf", "vf": int8 QTensors) or the self-attention's
        dense int8 cache ("k", "v" (B, T, KV, dh), "k_scale", "v_scale"),
        written IN PLACE at q_pos."""
        a, q = self.a, self.q
        b, s, _ = x.shape
        h = qact(q, "none", qlayernorm(q, x, p[prefix + "ln_g"],
                                       p[prefix + "ln_b"]))
        qh = qdense(q, h, p[prefix + "wq"]).reshape(b, s, a.n_heads, a.dh)
        if cache is not None and "kf" in cache:     # precomputed cross K/V
            kh, vh = cache["kf"], cache["vf"]
        else:
            src = kv_src if kv_src is not None else h
            t = src.shape[1]
            kh = qdense(q, src, p[prefix + "wk"]).reshape(b, t, a.n_kv, a.dh)
            vh = qdense(q, src, p[prefix + "wv"]).reshape(b, t, a.n_kv, a.dh)
            kh, vh = qact(q, "none", kh), qact(q, "none", vh)
        qh = qact(q, "none", qh)
        if cache is not None and "k" in cache:      # decode self-attention
            ks, vs = cache["k_scale"], cache["v_scale"]
            lanes, at = torch.arange(b, device=x.device), q_pos.long()
            cache["k"][lanes, at] = L.kv_quantize(kh[:, 0], ks)
            cache["v"][lanes, at] = L.kv_quantize(vh[:, 0], vs)
            o = L.decode_attention(q, qh, L.kv_qtensor(cache["k"], ks),
                                   L.kv_qtensor(cache["v"], vs), q_pos=q_pos,
                                   t_valid=q_pos.max() + 1)
        elif s == 1:                                 # decode cross-attention
            t = kh.shape[1]
            o = L.decode_attention(
                q, qh, kh, vh, q_pos=torch.full((1,), t - 1, device=x.device),
                t_valid=t)
        else:
            o = L.chunked_attention(q, qh, kh, vh, causal=causal, q_pos=q_pos,
                                    k_pos=k_pos, q_chunk=a.q_chunk,
                                    kv_chunk=a.kv_chunk)
        return x + qdense(q, o.reshape(b, s, a.n_heads * a.dh),
                          p[prefix + "wo"])

    def _mlp_block(self, p, x):
        q = self.q
        h = qact(q, "none", qlayernorm(q, x, p["mlp_ln_g"], p["mlp_ln_b"]))
        return x + L.mlp(q, h, p["w_up"], p["w_down"], self.a.act)

    def encode(self, frames) -> Tensor:
        """(B, S, d) frame embeddings -> the encoder's output (B, S, d):
        non-causal self-attention and MLP blocks, no positions, no final
        norm."""
        x = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        pos = torch.arange(x.shape[1], device=self.device)

        def body(h, p):
            h = self._attn(p, h, None, causal=False, q_pos=pos, k_pos=pos)
            return self._mlp_block(p, h)
        body = L.maybe_remat(self.a, body)
        for p in self._views(self.enc):
            x = body(x, p)
        return x

    def _decode_train(self, enc_out: Tensor, tokens: Tensor) -> Tensor:
        y = self.embed[tokens]                        # exempt first layer
        tpos = torch.arange(tokens.shape[1], device=self.device)
        spos = torch.arange(enc_out.shape[1], device=self.device)
        enc_q = qact(self.q, "none", enc_out)

        def body(h, p):
            h = self._attn(p, h, None, causal=True, q_pos=tpos, k_pos=tpos)
            h = self._attn(p, h, enc_q, causal=False, q_pos=tpos, k_pos=spos,
                           prefix="x_")
            return self._mlp_block(p, h)
        body = L.maybe_remat(self.a, body)
        for p in self._views(self.dec):
            y = body(y, p)
        return y

    def _logits(self, x) -> Tensor:
        h = qlayernorm(self.q, x, self.final_ln_g, self.final_ln_b)
        logits = torch.matmul(h, self.lm_head)          # exempt last layer
        if self.a.vocab_padded != self.a.vocab:
            pad = torch.arange(self.a.vocab_padded,
                               device=logits.device) >= self.a.vocab
            logits = torch.where(pad, torch.full_like(logits, L.NEG_INF),
                                 logits)
        return logits

    # ---------------- training ----------------

    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """Mean cross entropy of {"frames" (B, S, d), "tokens", "labels"
        (B, S // tgt_ratio)}: logsumexp minus the label's logit over fp32
        logits.  Returns (loss, {"loss"}), as the reference's loss does."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        enc_out = self.encode(batch["frames"])
        logits = self._logits(self._decode_train(enc_out, tokens))
        lse = torch.logsumexp(logits, dim=-1)
        loss = torch.mean(lse - L.target_logit(logits, labels))
        return loss, {"loss": loss.detach()}

    # ---------------- serving ----------------

    def init_cache(self, b: int, t_self: int, t_src: int) -> dict:
        """The reference's cache: self-attention "k8"/"v8" (L, B, t_self,
        KV, dh) and cross "xk"/"xv" (L, B, t_src, KV, dh) int8, their
        (L,) scales at 2^-7, and "pos" (B,)."""
        a = self.a
        i8 = dict(dtype=torch.int8, device=self.device)
        self_kv = (a.dec_layers, b, t_self, a.n_kv, a.dh)
        cross_kv = (a.dec_layers, b, t_src, a.n_kv, a.dh)

        def scale():
            return torch.full((a.dec_layers,), 2.0 ** -7, device=self.device)

        return {"k8": torch.zeros(self_kv, **i8),
                "v8": torch.zeros(self_kv, **i8),
                "k_scale": scale(), "v_scale": scale(),
                "xk": torch.zeros(cross_kv, **i8),
                "xv": torch.zeros(cross_kv, **i8), "x_scale": scale(),
                "pos": torch.zeros((b,), dtype=torch.int32,
                                   device=self.device)}

    @torch.no_grad()
    def prefill(self, frames, t_self: int) -> dict:
        """Encode the (B, S, d) source, then write each decoder layer's
        cross K/V, requantized to the cache's 2^-7 step, into a fresh cache
        of `t_self` self-attention positions.  Returns the cache."""
        q, a = self.q, self.a
        enc_out = self.encode(frames)
        enc_q = qact(q, "none", enc_out)
        b, t_src, _ = enc_out.shape
        cache = self.init_cache(b, t_self, t_src)
        for i, p in enumerate(self._views(self.dec)):
            for w, key in (("x_wk", "xk"), ("x_wv", "xv")):
                kv = qdense(q, enc_q, p[w]).reshape(b, t_src, a.n_kv, a.dh)
                cache[key][i] = L.kv_quantize(qact(q, "none", kv), 2.0 ** -7)
        return cache

    @torch.no_grad()
    def serve_step(self, cache: dict, tokens) -> tuple[dict, Tensor]:
        """One decode token per sequence: self-attention against the dense
        cache (written IN PLACE at cache["pos"]), cross-attention against
        the int8 cross K/V.  Returns (the cache with pos + 1, logits
        (B, Vp))."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        y = self.embed[tokens][:, None, :]
        pos = cache["pos"]
        self_scales = {"k_scale": cache["k_scale"][0],
                       "v_scale": cache["v_scale"][0]}
        for i, p in enumerate(self._views(self.dec)):
            y = self._attn(p, y, None, causal=True, q_pos=pos, k_pos=pos,
                           cache=dict(self_scales, k=cache["k8"][i],
                                      v=cache["v8"][i]))
            # cross K/V stay int8 QTensors end to end (no dequantize pass)
            cross = {"kf": L.kv_qtensor(cache["xk"][i], cache["x_scale"][0]),
                     "vf": L.kv_qtensor(cache["xv"][i], cache["x_scale"][0])}
            y = self._attn(p, y, None, causal=False, q_pos=pos, k_pos=None,
                           cache=cross, prefix="x_")
            y = self._mlp_block(p, y)
        return dict(cache, pos=pos + 1), self._logits(y)[:, 0]
