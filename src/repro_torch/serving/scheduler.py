"""Request lifecycle + continuous-batching scheduler policy.

The port's own copy of `repro.serving.scheduler` (the port imports nothing
of the reference package); the policy is unchanged.

State machine (DESIGN.md §7):

    QUEUED -> PREFILL -> DECODE -> DONE
                ^          |
                +-- preempt (recompute): pages freed, generated tokens fold
                    into the prompt, request requeues at the FRONT

Pure control plane: no tensors here.  The scheduler decides *which* requests
run; the engine owns the device arrays and executes the decisions.

Policies:
  * admission — FIFO with BOUNDED SKIP: a request is admitted when a lane
    is free and the pool (free pages + radix-evictable pages, minus the
    prefix pages a cache hit would cover) can fund its prompt pages plus
    the first decode page.  Up to `max_skip` queued requests that don't
    fit may be jumped by smaller ones behind them — killing the
    head-of-line blocking a single huge prompt used to impose — but every
    jump increments the skipped request's counter, and once a request has
    been skipped `starvation_limit` times nothing passes it until it
    admits (the progress guarantee: pool >= one max-ctx request, so the
    head always eventually fits).
  * inflight batching — admissions happen every step, so fresh prefills
    join the running decode batch immediately.
  * preemption — on pool exhaustion the longest-context live request is
    victim (it frees the most pages and is closest to done per page spent).
    Recompute-style: its generated tokens are folded into the prompt and it
    re-prefills later, reproducing the exact decode state.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class RequestState(Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # int32 (S,) — grows on recompute preempt
    max_new: int                    # total generation target
    arrival: float
    state: RequestState = RequestState.QUEUED
    generated: list = field(default_factory=list)
    lane: int = -1
    page_ids: list = field(default_factory=list)
    ttft: float | None = None       # first-token latency (first admission)
    queue_s: float | None = None    # TTFT split: submit -> first admission
    prefill_s: float | None = None  # TTFT split: admission -> first token
    finish: float | None = None
    preemptions: int = 0
    skipped: int = 0                # admissions that jumped this request
    n_folded: int = 0               # generated tokens recompute folded into
                                    # the prompt (don't double count)
    # chunked-prefill progress (engine-owned, reset on preemption)
    pf_pos: int = 0                 # prompt tokens already prefilled
    n_shared: int = 0               # prefix pages served by the radix cache
    page_snaps: list = field(default_factory=list)  # dense state after each
                                    # full prompt page (radix, recurrent
                                    # families)

    @property
    def ctx_len(self) -> int:
        return len(self.prompt) + len(self.generated) - self.n_folded

    @property
    def pos(self) -> int:
        """Next KV write position.  After prefill over S tokens with one
        sampled token, decode writes that token's KV at position S == the
        context length minus one; each later step advances by one."""
        return self.ctx_len - 1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


class Scheduler:
    """Queue + lifecycle bookkeeping; policies as documented above."""

    def __init__(self, pool=None, max_skip: int = 4,
                 starvation_limit: int = 8):
        self.pool = pool
        self.cache = None               # RadixCache (engine wires it up)
        self.max_skip = max_skip
        self.starvation_limit = starvation_limit
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self._ids = itertools.count()
        self.admitted = 0
        self.preemptions = 0
        self.skips = 0                  # total queue jumps

    def submit(self, prompt: np.ndarray, max_new: int,
               arrival: float) -> Request:
        req = Request(next(self._ids), np.asarray(prompt, np.int32),
                      int(max_new), arrival)
        self.requests[req.rid] = req
        self.queue.append(req)
        return req

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def pages_needed(self, req: Request) -> int:
        """Prompt pages + the first decode page, minus the prefix pages a
        radix-cache hit would serve (shared pages cost only a ref)."""
        nb = len(req.prompt) // self.pool.page_size + 1
        if self.cache is not None:
            nb -= self.cache.match_pages(req.prompt)
        return nb

    def admissible(self, req: Request, free_lanes: int,
                   committed_pages: int = 0) -> bool:
        """`committed_pages` reserves pages already promised to earlier
        admissions in the same wave (they allocate after this check).
        Radix-evictable pages count as free: the engine evicts
        least-recently-used cache subtrees on allocation pressure."""
        if free_lanes <= 0:
            return False
        if self.pool is None:
            return True
        free = self.pool.free_count - committed_pages
        if self.cache is not None:
            # matched-prefix pages may themselves be tree-only (evictable)
            # right now, but committing to the hit refs them — don't count
            # the same page as both "served by the cache" and "reclaimable"
            free += max(0, self.cache.evictable()
                        - self.cache.match_pages(req.prompt))
        return free >= self.pages_needed(req)

    def admit(self, free_lanes: int) -> list[Request]:
        """Pop admissible requests for this step's prefill wave.

        Bounded-skip FIFO: scans past up to `max_skip` queued requests
        that don't currently fit, admitting later ones that do.  Every
        request jumped this way gets `.skipped += 1`; a request skipped
        `starvation_limit` times becomes a hard barrier no one passes.
        `max_skip=0` is strict FIFO (the pre-skip policy).
        """
        out: list[Request] = []
        committed, passed = 0, []
        idx = 0
        while idx < len(self.queue) and len(out) < free_lanes:
            req = self.queue[idx]
            if self.admissible(req, free_lanes - len(out), committed):
                del self.queue[idx]
                req.state = RequestState.PREFILL
                if self.pool is not None:
                    committed += self.pages_needed(req)
                out.append(req)
                self.admitted += 1
                for r in passed:
                    r.skipped += 1
                    self.skips += 1
            elif (len(passed) >= self.max_skip
                  or req.skipped >= self.starvation_limit):
                break
            else:
                passed.append(req)
                idx += 1
        return out

    def pick_victim(self, live: list[Request]) -> Request:
        """Longest context frees the most pages."""
        return max(live, key=lambda r: (r.ctx_len, r.rid))

    def preempt(self, req: Request) -> None:
        """Recompute preemption: fold generated into the prompt, requeue at
        the front so the victim reclaims capacity as soon as it exists."""
        req.prompt = np.concatenate(
            [req.prompt,
             np.asarray(req.generated[req.n_folded:], np.int32)])
        req.n_folded = len(req.generated)
        req.state = RequestState.QUEUED
        req.lane = -1
        req.page_ids = []
        req.pf_pos = 0
        req.n_shared = 0
        req.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(req)

    def finish(self, req: Request, now: float) -> None:
        req.state = RequestState.DONE
        req.finish = now
