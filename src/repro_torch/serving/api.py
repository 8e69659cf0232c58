"""Serving API surface: engine construction in one call.

    from repro_torch.serving import make_engine

    engine = make_engine("granite-3-8b", reduced=False, n_layers=4,
                         max_lanes=4, page_size=16, max_ctx=512)
    rid = engine.submit(prompt_ids, max_new=16)
    tokens = engine.drain()[rid]

Port of `repro.serving.api.make_engine` (native mode, full8; the kernels
are always the fused ones).  The engine runs on the card unless `device="cpu"` is passed.
"""
from __future__ import annotations

from repro_torch.configs import get
from repro_torch.core import preset
from repro_torch.models import build_model

from .engine import Engine


def make_engine(arch: str, *, mode: str = "native", preset_name: str = "full8",
                reduced: bool = True, seed: int = 0, device="cuda",
                n_layers: int | None = None, tp: int = 1,
                **engine_kw) -> Engine:
    """Build (arch config, model with random weights, Engine) in one call.

    `reduced` takes the tiny CPU-test config; `n_layers` cuts the depth and
    keeps every width.  Weights come from `seed` by the reference's init
    formulas (same distributions, not the same bits as `repro`'s).  The
    engine's model is `engine.model`."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel serving is not ported yet: ROADMAP Queue 1 "
            "item 5")
    acfg = get(arch)
    if reduced:
        acfg = acfg.reduced()
    if n_layers is not None:
        acfg = acfg.replace(n_layers=n_layers)
    model = build_model(acfg, preset(preset_name, mode),
                        device=device).init(seed)
    return Engine(model, **engine_kw)
