"""Pure-SSM LM (falcon-mamba-7b): stacked Mamba1 blocks, O(1) decode state.

Port of `repro.models.ssm_lm.SSMLM`: the training loss (`loss`, the
backbone in train mode, differentiated by autograd: the scan's gradient is
K9b), the parallel prefill (`prefill`, train mode from zero state), the
per-token step (`serve_step`) and the decode-state slot API the engine
drives (`decode_state_spec`, `init_slots`, `slot_from_cache`,
`paged_decode_step`, `prefill_page`).  There is no paged KV: the whole
recurrent state (conv window and scan state per layer) sits in dense
per-lane slots, and every method returns new state rather than updating
it in place, as the reference's does.

Weights keep the reference's layouts: stacked per-layer tensors (L, ...)
in `layers` (ln, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log,
D_skip, out_proj), `embed` (Vp, d), `final_norm` (d,), `lm_head` (d, Vp).
The embedding and lm_head are exempt from quantization (an fp32 gather and
an fp32 matmul, TF32 off).  The parameters require grad; the serving
entry points run under no_grad.
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

Tensor = torch.Tensor


class SSMLM(nn.Module):
    def __init__(self, acfg: ArchConfig, qcfg: QConfig, device="cuda"):
        super().__init__()
        if acfg.family != "ssm" or acfg.ssm_kind != "mamba1":
            raise NotImplementedError(
                f"SSMLM runs Mamba1 family 'ssm' configs, as the reference's "
                f"does (got family {acfg.family!r}, "
                f"{acfg.ssm_kind or 'no ssm_kind'}); Mamba2 runs inside the "
                "hybrid family, whose model is Zamba2")
        qcfg.validate()
        self.a, self.q = acfg, qcfg
        self.device = resolve_device(device)
        a = acfg

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=self.device))

        self.layers = nn.ParameterDict({
            k: param((a.n_layers,) + s)
            for k, s in S.layer_shapes(a).items()})
        self.embed = param((a.vocab_padded, a.d_model))
        self.final_norm = param((a.d_model,))
        self.lm_head = param((a.d_model, a.vocab_padded))

    # ---------------- params ----------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "SSMLM":
        """Random weights from a torch.Generator by the reference's init
        formulas (`mamba1_init` per layer, N(0, 0.02^2) for the exempt
        embedding and head, ones for the final norm).  Same distributions
        as the reference's `init`, not the same bits."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for p in self._layer_views():
            S.mamba1_init_(self.q, self.a, p, gen)
        self.embed.normal_(generator=gen).mul_(0.02)
        self.lm_head.normal_(generator=gen).mul_(0.02)
        self.final_norm.fill_(1.0)
        return self

    @torch.no_grad()
    def load_params(self, params: dict) -> "SSMLM":
        """Copy a {"embed", "layers": {...}, "final_norm", "lm_head"} tree of
        tensors or arrays in the reference layout into this module."""
        for k in S.LAYER_KEYS:
            self.layers[k].copy_(torch.as_tensor(params["layers"][k]))
        for k in ("embed", "final_norm", "lm_head"):
            getattr(self, k).copy_(torch.as_tensor(params[k]))
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params(self) -> dict:
        """The parameter tree in the reference's layout (live tensors)."""
        return {"embed": self.embed, "final_norm": self.final_norm,
                "layers": dict(self.layers), "lm_head": self.lm_head}

    def labels(self) -> dict:
        return {"embed": "exempt", "layers": S.mamba1_labels(),
                "final_norm": "gamma", "lm_head": "exempt"}

    # ---------------- training ----------------

    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """Mean next-token cross entropy of {"tokens", "labels"} (B, S):
        the embedding, every layer in train mode, the logits, then
        logsumexp minus the label's logit.  Returns (loss, {"loss"}), as
        the reference's loss does."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x = self.embed[tokens]                        # exempt first layer
        x, _ = self._backbone(x, "train", None)
        logits = self._logits(x)
        lse = torch.logsumexp(logits, dim=-1)
        loss = torch.mean(lse - L.target_logit(logits, labels))
        return loss, {"loss": loss.detach()}

    # ---------------- forward ----------------

    def _layer(self, i: int) -> dict:
        return self._layer_views()[i]

    def _layer_views(self) -> list[dict]:
        """Per-layer views of the stacked parameters, made by ONE unbind
        per tensor, so the backward assembles each stacked gradient once."""
        per = {k: p.unbind(0) for k, p in self.layers.items()}
        return [{k: v[i] for k, v in per.items()}
                for i in range(self.a.n_layers)]

    def _backbone(self, x: Tensor, mode: str, state: dict | None):
        """Every layer in `mode`; returns (x, {"conv", "h"} stacked (L, ...)).
        `state` holds the stacked per-layer states ("chunk" / "decode")."""
        convs, hs = [], []
        block = S.mamba1_block
        if mode == "train":         # each layer checkpointed (remat "full")
            block = L.maybe_remat(self.a, block)
        for i, p in enumerate(self._layer_views()):
            st = (None if state is None
                  else {"conv": state["conv"][i], "h": state["h"][i]})
            x, ns = block(self.q, self.a, p, x, mode, st)
            convs.append(ns["conv"])
            hs.append(ns["h"])
        return x, {"conv": torch.stack(convs), "h": torch.stack(hs)}

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

    @torch.no_grad()
    def prefill(self, tokens) -> tuple[dict, Tensor]:
        """Parallel prefill of (B, S) tokens from zero state (every scan one
        launch over the whole sequence).  Returns (state {"conv", "h",
        "pos"}, last-token logits (B, Vp))."""
        x = self._embed(tokens)
        bsz, s = x.shape[:2]
        x, st = self._backbone(x, "train", None)
        st["pos"] = torch.full((bsz,), s, dtype=torch.int32,
                               device=self.device)
        return st, self._logits(x[:, -1:])[:, 0]

    def init_state(self, bsz: int) -> dict:
        a = self.a
        st = S.mamba1_state_init(a, bsz, self.device)
        return {"conv": st["conv"].repeat(a.n_layers, 1, 1, 1),
                "h": st["h"].repeat(a.n_layers, 1, 1, 1),
                "pos": torch.zeros((bsz,), dtype=torch.int32,
                                   device=self.device)}

    @torch.no_grad()
    def serve_step(self, state: dict, tokens) -> tuple[dict, Tensor]:
        """One token per lane: tokens (B,) -> (new state, logits (B, Vp))."""
        x = self._embed(tokens)[:, None, :]
        x, st = self._backbone(x, "decode", state)
        st["pos"] = state["pos"] + 1
        return st, self._logits(x)[:, 0]

    # ---------------- serving decode-state slot API ----------------

    def decode_state_spec(self) -> dict:
        return {"kv_layers": 0, "n_kv": 0, "dh": 0,
                "dense_axes": {"conv": 1, "h": 1, "pos": 0}}

    def init_slots(self, n_lanes: int) -> dict:
        return self.init_state(n_lanes)

    def slot_from_cache(self, state: dict, b: int = 0):
        """Sequence `b` of a prefill state -> (dense slot values, None: no
        paged KV), the reference's pair."""
        return ({"conv": state["conv"][:, b], "h": state["h"][:, b],
                 "pos": state["pos"][b]}, None)

    def paged_decode_step(self, slots: dict, pool_view,
                          tokens) -> tuple[Tensor, dict]:
        """One decode step over all lanes (every lane's slot advances, dead
        ones too, as in the reference); `pool_view` is None (no paged KV).
        Returns (logits (B, Vp), new slots); positions are the engine's, so
        "pos" passes through."""
        st, logits = self.serve_step(slots, tokens)
        st["pos"] = slots["pos"]
        return logits, st

    @torch.no_grad()
    def prefill_page(self, dense: dict, pool_view, tokens,
                     pos0: int) -> tuple[Tensor, dict]:
        """Chunked prefill: one page (page,) of one lane's prompt advances
        the per-layer states of `dense` (B = 1); `pool_view` is None and
        `pos0` unused (the recurrence carries the position).  Returns
        (last-token logits (1, Vp), new dense state)."""
        x = self._embed(tokens)[None]
        x, st = self._backbone(x, "chunk", dense)
        st["pos"] = dense["pos"]
        return self._logits(x[:, -1:])[:, 0], st
