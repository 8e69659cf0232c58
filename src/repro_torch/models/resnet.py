"""The paper's ResNet18/34/50 with WAGEUBN quantized conv, BN and ReLU.

Port of `repro.models.resnet.ResNet`.  The first convolution (the stem,
with its BN) and the final fully connected layer are exempt from
quantization (paper §IV-A).  Every hidden convolution goes through qconv
(Q_W weights, Q_E2 errors), every BN through qbatchnorm (Eq. 12, the K4
"batch" kernel forward in native mode, the unfused body in sim and
fp32), every ReLU through qact (Q_A forward, Q_E1 backward).

Parameters keep the reference's tree and layouts, so both packages hold
the same element at the same flat index (CQ draws its threefry bits by
flat index): {"stem": (7, 7, 3, 64) HWIO, "bn_stem": {"gamma", "beta"},
"stages": [[block, ...], ...], "fc": (features, classes), "fc_b"}, each
block {"conv1", "bn1", "conv2", "bn2", ("conv3", "bn3",) ("proj",
"bn_proj")} with HWIO convolution weights.  Activations are NHWC; the
convolutions permute to NCHW views (channels_last) only at the cuDNN call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import batchnorm, qact, qbatchnorm, qconv, qweight
from repro_torch.core.qconfig import QConfig
from repro_torch.core.qdense import conv_valid, pad_same
from repro_torch.core.qtensor import qt_carrier
from repro_torch.device import resolve_device
from repro_torch.optim import flatten

from . import layers as L

Tensor = torch.Tensor

WIDTHS = (64, 128, 256, 512)


def max_pool_same(x: Tensor) -> Tensor:
    """The reference's 3x3 stride-2 "SAME" max pool of an NHWC tensor:
    -inf padding, then max_pool2d, whose gradient goes to the first maximum
    of each window as XLA's select_and_scatter sends it."""
    xp = pad_same(x, 3, 3, 2, value=-math.inf)
    return F.max_pool2d(xp.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


class ResNet(nn.Module):
    def __init__(self, acfg: ArchConfig, qcfg: QConfig, device="cuda"):
        super().__init__()
        if acfg.family != "resnet":
            raise ValueError(f"ResNet takes family 'resnet', not "
                             f"{acfg.family!r}")
        qcfg.validate()
        self.a, self.q = acfg, qcfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the convolutions and the fc run on grid values in full fp32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.bottleneck = acfg.block == "bottleneck"
        self.widths = WIDTHS[:len(acfg.stage_sizes)]
        mult = 4 if self.bottleneck else 1
        self._tree = {
            "stem": self._param("stem", (7, 7, 3, 64)),
            "bn_stem": self._bn("bn_stem", 64),
            "stages": [],
            "fc": self._param("fc", (self.widths[-1] * mult,
                                     acfg.num_classes)),
            "fc_b": self._param("fc_b", (acfg.num_classes,)),
        }
        cin = 64
        for si, n in enumerate(acfg.stage_sizes):
            cout = self.widths[si] * mult
            blocks = []
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(self._block_params(f"s{si}_b{bi}", cin, cout,
                                                 stride))
                cin = cout
            self._tree["stages"].append(blocks)

    # ---------------- params ----------------

    def _param(self, name: str, shape) -> nn.Parameter:
        p = nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                     device=self.device))
        self.register_parameter(name, p)
        return p

    def _bn(self, name: str, c: int) -> dict:
        return {"gamma": self._param(f"{name}_gamma", (c,)),
                "beta": self._param(f"{name}_beta", (c,))}

    def _block_params(self, pre: str, cin: int, cout: int,
                      stride: int) -> dict:
        def conv(name, k, ci, co):
            return self._param(f"{pre}_{name}", (k, k, ci, co))
        if self.bottleneck:
            mid = cout // 4
            p = {"conv1": conv("conv1", 1, cin, mid),
                 "bn1": self._bn(f"{pre}_bn1", mid),
                 "conv2": conv("conv2", 3, mid, mid),
                 "bn2": self._bn(f"{pre}_bn2", mid),
                 "conv3": conv("conv3", 1, mid, cout),
                 "bn3": self._bn(f"{pre}_bn3", cout)}
        else:
            p = {"conv1": conv("conv1", 3, cin, cout),
                 "bn1": self._bn(f"{pre}_bn1", cout),
                 "conv2": conv("conv2", 3, cout, cout),
                 "bn2": self._bn(f"{pre}_bn2", cout)}
        if stride != 1 or cin != cout:
            p["proj"] = conv("proj", 1, cin, cout)
            p["bn_proj"] = self._bn(f"{pre}_bn_proj", cout)
        return p

    @torch.no_grad()
    def init(self, seed: int = 0) -> "ResNet":
        """Random weights from a torch.Generator by the reference's
        formulas: winit (fan_in kh*kw*cin, k_WU grid) for hidden
        convolutions, N(0, 0.05^2) for the stem, N(0, 0.01^2) for fc, zeros
        for fc_b, ones and zeros for every BN's gamma and beta.  The same
        distributions as the reference's `init`, not the same bits."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t = self._tree
        t["stem"].normal_(generator=gen).mul_(0.05)
        t["fc"].normal_(generator=gen).mul_(0.01)
        t["fc_b"].zero_()
        for bn in [t["bn_stem"]] + [v for blocks in t["stages"]
                                    for b in blocks for k, v in b.items()
                                    if k.startswith("bn")]:
            bn["gamma"].fill_(1.0)
            bn["beta"].zero_()
        for blocks in t["stages"]:
            for b in blocks:
                for k, w in b.items():
                    if not k.startswith("bn"):
                        kh, kw, cin, _ = w.shape
                        L.winit_(self.q, w, kh * kw * cin, gen)
        return self

    @torch.no_grad()
    def load_params(self, params: dict) -> "ResNet":
        """Copy a tree of tensors or arrays in the reference layout (the
        tree `params()` returns) into this module."""
        mine, theirs = flatten(self._tree), flatten(params)
        if len(mine) != len(theirs):
            raise ValueError(f"{len(theirs)} leaves for {len(mine)} "
                             "parameters")
        for p, v in zip(mine, theirs):
            v = torch.as_tensor(v)
            if v.shape != p.shape:
                raise ValueError(f"leaf of shape {tuple(v.shape)} for a "
                                 f"parameter of shape {tuple(p.shape)}")
            p.copy_(v)
        return self

    def params(self) -> dict:
        """The parameter tree in the reference's layout (live tensors)."""
        return self._tree

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def labels(self) -> dict:
        """Optimizer label per leaf: "w" (CQ) for hidden convolutions,
        "gamma"/"beta" (15-bit) for every BN, "exempt" (vanilla momentum)
        for the stem convolution and fc."""
        def bn():
            return {"gamma": "gamma", "beta": "beta"}
        return {"stem": "exempt", "bn_stem": bn(), "fc": "exempt",
                "fc_b": "exempt",
                "stages": [[{k: bn() if k.startswith("bn") else "w"
                             for k in b} for b in blocks]
                           for blocks in self._tree["stages"]]}

    # ---------------- forward ----------------

    def _cbn(self, p: dict, x, conv: str, bn: str, stride: int) -> Tensor:
        q = self.q
        y = qconv(q, x, qweight(q, p[conv]), stride)
        return qbatchnorm(q, y, p[bn]["gamma"], p[bn]["beta"])

    def _block(self, p: dict, x, stride: int):
        q = self.q
        if self.bottleneck:
            h = qact(q, "relu", self._cbn(p, x, "conv1", "bn1", 1))
            h = qact(q, "relu", self._cbn(p, h, "conv2", "bn2", stride))
            h = self._cbn(p, h, "conv3", "bn3", 1)
        else:
            h = qact(q, "relu", self._cbn(p, x, "conv1", "bn1", stride))
            h = self._cbn(p, h, "conv2", "bn2", 1)
        idn = (self._cbn(p, x, "proj", "bn_proj", stride) if "proj" in p
               else qt_carrier(x))
        return qact(q, "relu", h + idn)

    def forward(self, images) -> Tensor:
        """images (N, H, W, 3) f32 -> logits (N, classes) f32."""
        t = self._tree
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        # exempt stem: fp32 convolution + BN + relu, no quantizers
        x = conv_valid(pad_same(x, 7, 7, 2), t["stem"], 2)
        x = batchnorm(x, t["bn_stem"]["gamma"], t["bn_stem"]["beta"])
        x = max_pool_same(torch.relu(x))
        x = qact(self.q, "none", x)
        for si, blocks in enumerate(t["stages"]):
            for bi, bp in enumerate(blocks):
                x = self._block(bp, x, 2 if (si > 0 and bi == 0) else 1)
        x = torch.mean(qt_carrier(x), dim=(1, 2))
        return torch.matmul(x, t["fc"]) + t["fc_b"]      # exempt last layer

    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """Mean cross entropy of {"images", "labels"}: (loss, {"loss",
        "acc"}), accuracy the share of argmax hits."""
        logits = self.forward(batch["images"])
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        lse = torch.logsumexp(logits, dim=-1)
        loss = torch.mean(lse - L.target_logit(logits, labels))
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return loss, {"loss": loss.detach(), "acc": acc}
