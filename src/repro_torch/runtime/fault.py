"""Step watchdog: flags straggler steps by a deadline policy.

A minimal copy of `repro.runtime.fault.StepWatchdog` (the port imports
nothing of the reference package).  The serving engine times every fused
decode step through it; flagged steps surface in the engine's metrics as
`straggler_steps`.
"""
from __future__ import annotations

import logging

log = logging.getLogger("repro_torch.runtime")


class StepWatchdog:
    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 window: int = 256):
        self.factor = factor
        self.warmup = warmup
        self.window = window
        self.times: list[float] = []
        self.flags: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """True if this step took more than `factor` times the median of
        the previous steps in a rolling window of `window` steps."""
        self.times.append(dt)
        if len(self.times) > self.window:
            del self.times[: len(self.times) - self.window]
        if len(self.times) <= self.warmup:
            return False
        hist = sorted(self.times[:-1])
        median = hist[len(hist) // 2]
        if dt > self.factor * median:
            self.flags.append(step)
            log.warning("straggler: step %d took %.3fs (median %.3fs)",
                        step, dt, median)
            return True
        return False
