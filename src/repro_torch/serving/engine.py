"""Continuous-batching int8 serving engine with chunked prefill.

Port of `repro.serving.engine.Engine` for the chunked-prefill, greedy
path.  Attention KV lives as int8 pages in a `PagePool`; recurrent SSM
state lives in dense per-lane slots (no pool), as in the reference, which
branches on `decode_state_spec()["kv_layers"] > 0` alone.  One decode
step runs all `max_lanes` lanes (dead lanes ride along: their table rows
point at the trash page and their positions stay 0; a dense family's dead
and mid-prefill lanes advance their slots' stale state, which release
never resets, exactly as the reference's do).

Control plane (host, numpy): `Scheduler` admission/preemption, per-lane
page tables, request bookkeeping.  Data plane (device): the model's paged
steps, whose ops are the hand-written kernels on a CUDA device.

Per-step flow (Engine.step):
  1. admit queued requests into free lanes (pages for the prompt plus the
     first decode page are allocated now; prefill streams later, for a
     dense family from a zero mid-prefill state of its own)
  2. run up to `prefill_budget` prompt tokens of prefill work: full pages
     `prefill_chunk` at a time through `prefill_page`, then the ragged tail
     token by token through the B=1 decode step; a finished dense prefill
     moves its state into the lane's slot
  3. paged only: allocate decode pages at page boundaries; preempt the
     longest-context request when the pool is exhausted (recompute
     preemption)
  4. one decode step over all DECODE lanes; append the greedy tokens
  5. retire finished requests, unref their pages

The reference compiles its chunk step for a fixed `prefill_chunk` pages and
masks the pages past the prompt onto the trash page; for a paged family
the port runs those masked pages too, because their trash-page writes are
what dead lanes read in decode, and dead lanes' outputs enter the
batch-global activation scales (the same tokens as the reference depend on
it).  For a dense family the reference discards a masked page's state and
logits, and the port skips it.  Likewise the engine's warm-up steps run as
the reference's do.

Not ported yet: monolithic prefill (ROADMAP Queue 1 item 2); temperature
and top-k sampling and the radix prefix cache (item 3); tensor-parallel
serving (item 5).  Each raises NotImplementedError.

The only host sync of a decode step is the token readback; prefill syncs
once per engine step so that `prefill_wall_s` times its own work.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.runtime.fault import StepWatchdog

from .pool import PagePool
from .scheduler import Request, RequestState, Scheduler


def greedy_token(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over the unpadded vocab (first index on ties, as jnp)."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)


class Engine:
    """Continuous-batching serving engine over the paged int8 KV pool.

    Args:
      model: an `LMTransformer` (paged: `decode_state_spec`,
        `prefill_page` and `paged_decode_step` against the pool) or an
        `SSMLM` (dense: the same methods on state dicts, plus
        `init_slots`).
      max_lanes: decode batch width (padded; dead lanes ride along masked).
      page_size: tokens per KV page; n_pages: pool size (default
        1 + max_lanes * ceil(max_ctx / page_size)); max_ctx: per-request
        prompt + generation cap.
      prefill_mode: "chunked" (the only mode ported).
      prefill_chunk: full pages per chunk call; prefill_budget: prompt
        tokens of prefill work per engine step (default one chunk).
      temperature/top_k: 0 (greedy) only; radix_cache: False only.
      max_skip / starvation_limit: bounded-skip admission (see Scheduler).
      watchdog: StepWatchdog timing each decode step; clock: time source.
    """

    def __init__(self, model, *, max_lanes: int = 4, page_size: int = 8,
                 n_pages: int | None = None, max_ctx: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 prefill_mode: str = "chunked", prefill_chunk: int = 4,
                 prefill_budget: int | None = None,
                 radix_cache: bool = False, max_skip: int = 4,
                 starvation_limit: int = 8,
                 watchdog: StepWatchdog | None = None, clock=time.monotonic):
        if prefill_mode == "monolithic":
            raise NotImplementedError(
                "prefill_mode='monolithic' is not ported yet (its attention, "
                "the flash_attention kernel K5, is): ROADMAP Queue 1 item 2")
        if prefill_mode != "chunked":
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if temperature > 0.0 or top_k:
            raise NotImplementedError(
                "temperature/top-k sampling is not ported yet: ROADMAP "
                "Queue 1 item 3 (the port serves greedy)")
        if radix_cache:
            raise NotImplementedError(
                "the radix prefix cache is not ported yet: ROADMAP Queue 1 "
                "item 3")
        self.model = model
        self.device = model.device
        self.clock = clock
        spec = model.decode_state_spec()
        self.paged = spec["kv_layers"] > 0
        self.page_size = page_size
        self.max_ctx = max_ctx
        self.n_blocks = -(-max_ctx // page_size)
        self.pool = None
        if self.paged:
            if n_pages is None:
                n_pages = 1 + max_lanes * self.n_blocks
            self.pool = PagePool(n_pages, page_size, spec["kv_layers"],
                                 spec["n_kv"], spec["dh"], device=self.device)
            if self.pool.usable < self.n_blocks:
                raise ValueError(
                    f"pool of {n_pages} pages cannot hold one max_ctx="
                    f"{max_ctx} request ({self.n_blocks} pages needed)")
        else:
            self._dense_axes = spec["dense_axes"]
            self.slots = model.init_slots(max_lanes)
            self._dense0 = model.init_slots(1)   # zero mid-prefill state
            self._pf_dense: dict[int, dict] = {}  # rid -> mid-prefill state
        self.scheduler = Scheduler(self.pool, max_skip=max_skip,
                                   starvation_limit=starvation_limit)
        self.watchdog = watchdog or StepWatchdog()
        self.max_lanes = max_lanes
        self.lane_req: list[Request | None] = [None] * max_lanes
        self.table = np.zeros((max_lanes, self.n_blocks), np.int32)
        self._table_dev = None          # device mirror, rebuilt when dirty
        self.h_tokens = np.zeros((max_lanes,), np.int32)
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget or prefill_chunk * page_size

        self.engine_steps = 0
        self.decode_steps = 0
        self.decode_wall_s = 0.0
        self.prefill_wall_s = 0.0
        self.prefill_tokens = 0
        self.straggler_steps = 0
        self._warmup()

    # ---- submission ------------------------------------------------------

    def submit(self, prompt, max_new: int, arrival: float | None = None):
        """Queue one request: prompt (S,) token ids, max_new >= 1 tokens to
        generate.  Returns the request id.  Raises ValueError on an empty
        prompt, max_new < 1, or S + max_new > max_ctx."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0 or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if len(prompt) + max_new > self.max_ctx:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"max_ctx ({self.max_ctx})")
        req = self.scheduler.submit(
            prompt, max_new, self.clock() if arrival is None else arrival)
        return req.rid

    # ---- engine step -----------------------------------------------------

    def step(self) -> list[Request]:
        """One engine step: admit, prefill work, ensure pages, decode.
        Returns the requests that finished during this step."""
        free = [ln for ln, r in enumerate(self.lane_req) if r is None]
        for req in self.scheduler.admit(len(free)):
            self._admit(req, free.pop(0))

        t0 = time.monotonic()
        finished, worked = self._run_prefill_chunks()
        if worked:
            self._sync()
            self.prefill_wall_s += time.monotonic() - t0

        if self.paged:
            self._ensure_pages()
        live = [ln for ln, r in enumerate(self.lane_req)
                if r is not None and r.state is RequestState.DECODE]
        if live:
            t0 = time.monotonic()
            toks = self._decode()
            dt = time.monotonic() - t0
            self.decode_wall_s += dt
            if self.watchdog.observe(self.decode_steps, dt):
                self.straggler_steps += 1
            self.decode_steps += 1
            for ln in live:
                req = self.lane_req[ln]
                tok = int(toks[ln])
                req.generated.append(tok)
                self.h_tokens[ln] = tok
                if req.done:
                    self._release(req)
                    finished.append(req)
        self.engine_steps += 1
        now = self.clock()
        for req in finished:
            self.scheduler.finish(req, now)
        return finished

    def drain(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Step until every submitted request completes; returns
        {request id: generated token ids}."""
        for _ in range(max_steps):
            if (not self.scheduler.queue
                    and all(r is None for r in self.lane_req)):
                break
            self.step()
        else:
            raise RuntimeError(f"drain did not finish in {max_steps} steps")
        return {r.rid: list(r.generated)
                for r in self.scheduler.requests.values()
                if r.state is RequestState.DONE}

    # ---- admission / release / preemption --------------------------------

    def _admit(self, req: Request, lane: int) -> None:
        """Claim a lane and the prompt's pages; prefill streams later."""
        if req.queue_s is None:
            req.queue_s = self.clock() - req.arrival
        req.pf_pos = 0
        if self.paged:
            nb_total = len(req.prompt) // self.page_size + 1  # + decode block
            pids = self._alloc_pages(nb_total, req)
            assert pids is not None  # not in lane_req yet: no self-preemption
            req.page_ids = pids
            self.table[lane] = 0
            self.table[lane, :nb_total] = pids
            self._table_dev = None
        else:
            self._pf_dense[req.rid] = self._dense0
        req.lane = lane
        self.lane_req[lane] = req       # PREFILL state: masked in decode

    def _release(self, req: Request) -> None:
        """Free the lane and its pages.  A dense family's slot keeps its
        state: the lane rides along in decode with it, as in the
        reference."""
        for pid in req.page_ids:
            self.pool.unref(pid)
        if not self.paged:
            self._pf_dense.pop(req.rid, None)
        if req.lane >= 0:
            self.table[req.lane] = 0
            self.lane_req[req.lane] = None
            self._table_dev = None
        req.page_ids = []
        req.lane = -1

    def _alloc_pages(self, n: int, req: Request) -> list[int] | None:
        """Allocate, preempting the longest-context live request while the
        pool is short.  Returns None iff `req` itself got preempted."""
        pids = self.pool.alloc(n)
        while pids is None:
            live = [r for r in self.lane_req if r is not None]
            if not live:
                raise RuntimeError(
                    f"pool exhausted with no live lanes to preempt "
                    f"(need {n} pages, free {self.pool.free_count})")
            victim = self.scheduler.pick_victim(live)
            self._release(victim)
            self.scheduler.preempt(victim)
            if victim is req:
                return None
            pids = self.pool.alloc(n)
        return pids

    def _ensure_pages(self) -> None:
        """Grow DECODE lanes' page tables at block boundaries."""
        for lane in range(self.max_lanes):
            req = self.lane_req[lane]
            if req is None or req.state is not RequestState.DECODE:
                continue
            blk = req.pos // self.page_size
            if blk < len(req.page_ids):
                continue
            pid = self._alloc_pages(1, req)
            if pid is None:          # this lane itself was preempted
                continue
            self.table[lane, blk] = pid[0]
            self._table_dev = None
            req.page_ids.extend(pid)

    # ---- chunked prefill -------------------------------------------------

    def _chunk(self, row: np.ndarray, toks: np.ndarray, start: int,
               n_full: int):
        """`prefill_chunk` pages of one lane from logical block `start`:
        pages at or past `n_full` are masked onto the trash page (all-zero
        table row) and their logits discarded.  Returns the last active
        page's last-token logits (zeros if none was active)."""
        page = self.page_size
        tab = torch.as_tensor(row[None], device=self.device)
        zero = torch.zeros_like(tab)
        tok_dev = torch.as_tensor(toks, device=self.device)
        lg = torch.zeros((1, self.model.a.vocab_padded), device=self.device)
        for j in range(self.prefill_chunk):
            active = start + j < n_full
            lg2 = self.model.prefill_page(
                self.pool.view(tab if active else zero),
                tok_dev[j * page:(j + 1) * page], (start + j) * page)
            if active:
                lg = lg2
        return lg

    def _tail(self, row: np.ndarray, token: int, pos: int):
        """One prompt-tail token through the B=1 decode step."""
        tab = torch.as_tensor(row[None], device=self.device)
        t = torch.full((1,), token, dtype=torch.int32, device=self.device)
        p = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        return self.model.paged_decode_step(self.pool.view(tab), t, p)

    def _chunk_dense(self, req: Request, tokens: np.ndarray):
        """Full pages of one lane's prompt advance its mid-prefill state;
        returns the last page's last-token logits.  The reference's chunk
        step also runs `prefill_chunk` pages past the prompt and discards
        their state and logits: with no trash page to write, the port skips
        them."""
        page = self.page_size
        tok = torch.as_tensor(tokens, device=self.device)
        dense, lg = self._pf_dense[req.rid], None
        for j in range(len(tokens) // page):
            lg, dense = self.model.prefill_page(
                dense, tok[j * page:(j + 1) * page])
        self._pf_dense[req.rid] = dense
        return lg

    def _tail_dense(self, req: Request, token: int):
        """One prompt-tail token through the B=1 decode step."""
        t = torch.full((1,), token, dtype=torch.int32, device=self.device)
        lg, self._pf_dense[req.rid] = self.model.paged_decode_step(
            self._pf_dense[req.rid], t)
        return lg

    def _warmup(self) -> None:
        """The reference engine's warm-up calls, run the same way: a chunk
        with every page masked, a tail token and a decode step, all on the
        trash page.  They compile the reference's traces; here they leave
        the trash page in the state the reference's does.  A dense family
        runs the tail token from the zero state and the decode step over
        the zero slots and keeps neither result, so the slots stay zero
        (the reference re-initialises them after its warm-up)."""
        if not self.paged:
            z = torch.zeros((self.max_lanes,), dtype=torch.int32,
                            device=self.device)
            self.model.paged_decode_step(self._dense0, z[:1])
            self.model.paged_decode_step(dict(self.slots, pos=z), z)
            self._sync()
            return
        zrow = np.zeros((self.n_blocks,), np.int32)
        self._chunk(zrow, np.zeros((self.prefill_chunk * self.page_size,),
                                   np.int32), 0, 0)
        self._tail(zrow, 0, 0)
        z = torch.zeros((self.max_lanes,), dtype=torch.int32,
                        device=self.device)
        self.model.paged_decode_step(
            self.pool.view(torch.as_tensor(self.table, device=self.device)),
            z, z)
        self._sync()

    def _run_prefill_chunks(self) -> tuple[list[Request], bool]:
        """Advance every mid-prefill lane by up to `prefill_budget` prompt
        tokens: full pages through the chunk step, then the ragged tail
        token by token.  A lane whose prompt completes samples its first
        token.  Returns (finished requests, whether any work ran)."""
        finished: list[Request] = []
        budget = self.prefill_budget
        page = self.page_size
        worked = False
        for lane in range(self.max_lanes):
            if budget <= 0:
                break
            req = self.lane_req[lane]
            if req is None or req.state is not RequestState.PREFILL:
                continue
            s = len(req.prompt)
            nb_full = s // page
            lg = None
            while budget >= page and req.pf_pos < nb_full * page:
                start = req.pf_pos // page
                allowed = min(self.prefill_chunk, nb_full - start,
                              budget // page)
                chunk = req.prompt[start * page:(start + allowed) * page]
                if self.paged:
                    toks = np.zeros((self.prefill_chunk * page,), np.int32)
                    toks[:len(chunk)] = chunk
                    lg = self._chunk(self.table[lane], toks, start,
                                     start + allowed)
                else:
                    lg = self._chunk_dense(req, chunk)
                req.pf_pos = (start + allowed) * page
                budget -= allowed * page
                worked = True
            while budget >= 1 and nb_full * page <= req.pf_pos < s:
                tok = int(req.prompt[req.pf_pos])
                lg = (self._tail(self.table[lane], tok, req.pf_pos)
                      if self.paged else self._tail_dense(req, tok))
                req.pf_pos += 1
                budget -= 1
                worked = True
            if req.pf_pos >= s:         # lg is this lane's final logits
                self._finish_prefill(req, lane, lg)
                if req.done:             # max_new == 1
                    self._release(req)
                    finished.append(req)
        return finished, worked

    def _finish_prefill(self, req: Request, lane: int, logits) -> None:
        """Prefill done: sample the first token, move a dense family's
        mid-prefill state into the lane's slot, and flip to DECODE."""
        tok0 = int(greedy_token(logits, self.model.a.vocab)[0])
        self.prefill_tokens += len(req.prompt)
        req.generated.append(tok0)
        if req.ttft is None:
            req.ttft = self.clock() - req.arrival
            req.prefill_s = req.ttft - req.queue_s
        if not self.paged:
            dense = self._pf_dense.pop(req.rid)
            for name, ax in self._dense_axes.items():   # in place
                if ax == 0:
                    self.slots[name][lane] = dense[name][0]
                else:
                    self.slots[name][:, lane] = dense[name][:, 0]
        req.state = RequestState.DECODE
        self.h_tokens[lane] = tok0
        self._table_dev = None          # lane unmasks in the decode table

    # ---- decode ----------------------------------------------------------

    def _decode(self) -> np.ndarray:
        pos = np.zeros((self.max_lanes,), np.int32)
        for ln, req in enumerate(self.lane_req):
            if req is not None and req.state is RequestState.DECODE:
                pos[ln] = req.pos
        tokens = torch.as_tensor(self.h_tokens, device=self.device)
        if not self.paged:
            # every lane advances its slot: dead and mid-prefill lanes too
            logits, self.slots = self.model.paged_decode_step(
                dict(self.slots, pos=torch.as_tensor(pos, device=self.device)),
                tokens)
            return greedy_token(logits, self.model.a.vocab).cpu().numpy()
        if self._table_dev is None:     # re-upload only when tables changed
            # mid-prefill lanes decode masked: their rows point at the
            # trash page so the ride-along writes never touch real pages
            eff = self.table.copy()
            for ln, req in enumerate(self.lane_req):
                if req is not None and req.state is not RequestState.DECODE:
                    eff[ln] = 0
            self._table_dev = torch.as_tensor(eff, device=self.device)
        logits = self.model.paged_decode_step(
            self.pool.view(self._table_dev), tokens,
            torch.as_tensor(pos, device=self.device))
        # the one host-device sync of the decode step: the token readback
        return greedy_token(logits, self.model.a.vocab).cpu().numpy()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- metrics ---------------------------------------------------------

    def metrics(self) -> dict:
        """Engine aggregates + per-request rollups: engine/decode step
        counts, decode_wall_s / prefill_wall_s (host clock, synchronized),
        completed, generated_tokens, prefill_tokens, queue_depth,
        live_lanes, preemptions, skips, straggler_steps, TTFT and TPOT mean
        / p50 / p99, decode_tok_s and, for a paged family, the pool
        report."""
        done = [r for r in self.scheduler.requests.values()
                if r.state is RequestState.DONE]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [(r.finish - r.arrival - r.ttft) / (len(r.generated) - 1)
                 for r in done
                 if r.finish is not None and r.ttft is not None
                 and len(r.generated) > 1]

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else 0.0

        gen = sum(len(r.generated) for r in done)
        out = {
            "engine_steps": self.engine_steps,
            "decode_steps": self.decode_steps,
            "decode_wall_s": self.decode_wall_s,
            "prefill_wall_s": self.prefill_wall_s,
            "completed": len(done),
            "generated_tokens": gen,
            "prefill_tokens": self.prefill_tokens,
            "queue_depth": self.scheduler.queue_depth,
            "live_lanes": sum(r is not None for r in self.lane_req),
            "preemptions": self.scheduler.preemptions,
            "skips": self.scheduler.skips,
            "straggler_steps": self.straggler_steps,
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "tpot_mean_s": float(np.mean(tpots)) if tpots else 0.0,
            "tpot_p50_s": pct(tpots, 50),
            "tpot_p99_s": pct(tpots, 99),
            "decode_tok_s": (gen / self.decode_wall_s
                             if self.decode_wall_s > 0 else 0.0),
        }
        if self.paged:
            out["pool"] = self.pool.report()
        return out
