"""Continuous-batching int8 serving engine.

Port of `repro.serving.engine.Engine` at tp=1.  Attention KV lives as int8
pages in a `PagePool`; recurrent SSM state lives in dense per-lane slots,
as in the reference, and a family may have either store or both: the
pages when `decode_state_spec()["kv_layers"] > 0` (the LMs; the hybrid's
shared attention), dense state when its `dense_axes` hold more than the
positions (the Mamba1 SSM; the hybrid's Mamba2 layers).  Every family
takes the same slot API, `prefill_page(dense, pool_view, tokens, pos0)`
and `paged_decode_step(slots, pool_view, tokens)` (pool_view None without
pages), so each step is one call.  One decode step runs all `max_lanes`
lanes (dead lanes ride along: their table rows point at the trash page
and their positions stay 0; dead and mid-prefill lanes advance their
slots' stale dense state, which release never resets, exactly as the
reference's do).

Control plane (host, numpy): `Scheduler` admission/preemption, per-lane
page tables, request bookkeeping, the `RadixCache`.  Data plane (device):
the model's prefill and decode steps, whose ops are the hand-written
kernels on a CUDA device, and the sampler.

Per-step flow (Engine.step):
  1. admit queued requests into free lanes.  Monolithic prefill (the
     default): the whole prompt runs at once through the model's train-mode
     layers (`prefill`, attention on the flash kernel K5 in native mode,
     the plain chunked body in sim and fp32), its int8 KV is
     scattered into the request's pages and the first token sampled, so the
     request joins this very step's decode batch.  Chunked prefill: pages
     for the prompt plus the first decode page are claimed now (radix hits
     by reference) and prefill streams in later steps
  2. chunked only: up to `prefill_budget` prompt tokens of prefill work:
     full pages `prefill_chunk` at a time through `prefill_page`, then the
     ragged tail token by token through the B=1 decode step; a finished
     prefill samples its first token, moves its dense state into the
     lane's slot and publishes its full prompt pages to the radix tree
     (with the dense state after each page, for a family that has one)
  3. paged only: allocate decode pages at page boundaries; on exhaustion
     evict least-recently-used radix subtrees, then preempt the
     longest-context request (recompute preemption)
  4. one decode step over all DECODE lanes (native: fused paged attention,
     K6, or gather-then-attend, K7 + K1, as `cfg.fuse_kernels` says; sim
     and fp32: K7, then fp32 products); sample and append the tokens
  5. retire finished requests, unref their pages

Sampling is greedy at temperature 0, else softmax sampling at
`temperature` restricted to the top-k logits, drawn as
`jax.random.categorical` draws them (argmax of logits plus Gumbel noise
from threefry bits, core/prng.py) with the reference's key stream: one
`fold_in(PRNGKey(seed), n)` per tick of a counter that every prefill sample
and every decode step advance (greedy ticks it and skips the fold-in).

The reference compiles its chunk step for a fixed `prefill_chunk` pages and
masks the pages past the prompt onto the trash page, discarding their
dense state and logits; for a paged family the port runs those masked
pages too, from the last real page's dense state, because their
trash-page writes are what dead lanes read in decode, and dead lanes'
outputs enter the batch-global activation scales (the same tokens as the
reference depend on it).  A family without pages has nothing to write
there, and the port skips its masked pages.  Likewise the chunked
engine's warm-up steps run as the reference's do (monolithic engines have
none).

Radix hits restore both stores: the hit pages by reference, and for a
family with dense state the snapshot the tree keeps after the deepest hit
page, which seeds the lane's mid-prefill state; the page and the snapshot
are both pure functions of the token prefix, so a hit equals recompute
bit for bit.

Not ported yet: tensor-parallel serving (ROADMAP Queue 1 item 5).

The only host sync of a decode step is the token readback; prefill syncs
once per engine step so that `prefill_wall_s` times its own work.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.runtime.fault import StepWatchdog

from .pool import PagePool
from .radix import RadixCache
from .scheduler import Request, RequestState, Scheduler


def greedy_token(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over the unpadded vocab (first index on ties, as jnp)."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)


def make_sampler(vocab: int, temperature: float = 0.0, top_k: int = 0):
    """(logits (B, Vp), key) -> (B,) int32 token ids; `key` a threefry key
    (core/prng.py).

    temperature <= 0 is greedy (key ignored, may be None); otherwise softmax sampling at
    `temperature`, optionally restricted to the top-k logits, as the
    reference's `jax.random.categorical`: argmax of the logits plus Gumbel
    noise of the logits' (B, vocab) shape."""
    if temperature <= 0.0:
        return lambda logits, key: greedy_token(logits, vocab)

    def sampler(logits, key):
        lg = logits[..., :vocab] / temperature
        if top_k:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, -torch.inf, lg)
        noise = prng.gumbel(key, lg.shape, lg.device)
        return torch.argmax(lg + noise, dim=-1).to(torch.int32)
    return sampler


class Engine:
    """Continuous-batching serving engine over the paged int8 KV pool.

    Args:
      model: an `LMTransformer` (pages), an `SSMLM` (dense state) or a
        `Zamba2` (both): `decode_state_spec`, `init_slots`, `prefill`,
        `slot_from_cache`, `prefill_page` and `paged_decode_step`.
      max_lanes: decode batch width (padded; dead lanes ride along masked).
      page_size: tokens per KV page; n_pages: pool size (default
        1 + max_lanes * ceil(max_ctx / page_size)); max_ctx: per-request
        prompt + generation cap.
      temperature/top_k: sampling policy (0.0 = greedy); seed: the
        sampling key's seed.
      prefill_mode: "monolithic" (default: the whole prompt in one prefill
        call at admission) or "chunked" (page-sized chunks interleaved with
        decode).
      prefill_chunk: full pages per chunk call; prefill_budget: prompt
        tokens of prefill work per engine step (default one chunk).
      radix_cache: front the pool with a prefix-sharing RadixCache
        (requires prefill_mode="chunked", where pages are bitwise-
        deterministic in their token prefix, and a paged family).
      max_skip / starvation_limit: bounded-skip admission (see Scheduler).
      watchdog: StepWatchdog timing each decode step; clock: time source.

    The decode attention's route (fused K6 or gather-then-attend) is the
    model's `q.fuse_kernels` in native mode, gather-then-attend in sim and
    fp32 (`fused_decode_active`).  Every mode writes int8 KV pages, as the
    reference does.  Raises ValueError if the pool cannot hold
    one max-context request, on an unknown prefill_mode, or for a radix
    cache without chunked prefill or a paged family.
    """

    def __init__(self, model, *, max_lanes: int = 4, page_size: int = 8,
                 n_pages: int | None = None, max_ctx: int = 64,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 prefill_mode: str = "monolithic", prefill_chunk: int = 4,
                 prefill_budget: int | None = None,
                 radix_cache: bool = False, max_skip: int = 4,
                 starvation_limit: int = 8,
                 watchdog: StepWatchdog | None = None, clock=time.monotonic):
        if prefill_mode not in ("monolithic", "chunked"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.model = model
        self.device = model.device
        self.clock = clock
        spec = model.decode_state_spec()
        self.paged = spec["kv_layers"] > 0
        self.dense = len(spec["dense_axes"]) > 1     # state beyond "pos"
        if radix_cache and prefill_mode != "chunked":
            raise ValueError(
                "radix_cache requires prefill_mode='chunked' (only the "
                "page-scoped quantization of chunked prefill makes cached "
                "pages bitwise-exact in their token prefix)")
        if radix_cache and not self.paged:
            raise ValueError(f"radix_cache needs a paged KV family (got "
                             f"{model.a.family!r})")
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
        self._dense_axes = spec["dense_axes"]
        self.slots = model.init_slots(max_lanes)
        self.scheduler = Scheduler(self.pool, max_skip=max_skip,
                                   starvation_limit=starvation_limit)
        self.watchdog = watchdog or StepWatchdog()
        self.max_lanes = max_lanes
        self.lane_req: list[Request | None] = [None] * max_lanes
        self.table = np.zeros((max_lanes, self.n_blocks), np.int32)
        self._table_dev = None          # device mirror, rebuilt when dirty
        self.h_tokens = np.zeros((max_lanes,), np.int32)

        self.key = prng.prng_key(seed)
        self._sample_ctr = 0
        self.greedy = temperature <= 0.0
        self.sampler = make_sampler(model.a.vocab, temperature, top_k)

        self.prefill_mode = prefill_mode
        self.chunked = prefill_mode == "chunked"
        self.radix = None
        self._pf_dense: dict[int, dict] = {}  # rid -> mid-prefill state
        if self.chunked:
            self.prefill_chunk = prefill_chunk
            self.prefill_budget = prefill_budget or prefill_chunk * page_size
            self._dense0 = model.init_slots(1)   # zero mid-prefill state
            self._warmup()
        if radix_cache:
            self.radix = RadixCache(self.pool, store_dense=self.dense)
            self.scheduler.cache = self.radix

        self.engine_steps = 0
        self.decode_steps = 0
        self.decode_wall_s = 0.0
        self.prefill_wall_s = 0.0
        self.prefill_tokens = 0
        self.straggler_steps = 0

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
        """One engine step: admit (and, monolithic, prefill), chunked
        prefill work, ensure pages, decode.  Returns the requests that
        finished during this step."""
        finished: list[Request] = []
        free = [ln for ln, r in enumerate(self.lane_req) if r is None]
        t0 = time.monotonic()
        worked = False
        for req in self.scheduler.admit(len(free)):
            if self.chunked:
                self._admit_chunked(req, free.pop(0))
                continue
            self._admit(req, free.pop(0))
            worked = True
            if req.done:             # max_new == 1: prefill completed it
                self._release(req)
                finished.append(req)
        if self.chunked:
            # chunked prefill's span leaves admission's host work out
            # (pages, preemption, radix lookup); monolithic admission is
            # the prefill and stays in
            t0 = time.monotonic()
            fin, chunk_work = self._run_prefill_chunks()
            finished.extend(fin)
            worked = worked or chunk_work
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

    # ---- sampling --------------------------------------------------------

    def _next_ctr(self) -> int:
        """Sampling-counter tick: each prefill sample and each decode step
        takes the next key, fold_in(key, counter), as in the reference."""
        self._sample_ctr += 1
        return self._sample_ctr

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(B, Vp) logits -> (B,) tokens on the host: the one sync.  The
        counter ticks whatever the policy; greedy skips the key's fold-in
        (host work on every decode step) since its sampler ignores it."""
        ctr = self._next_ctr()
        key = None if self.greedy else prng.fold_in(self.key, ctr)
        return self.sampler(logits, key).cpu().numpy()

    # ---- admission / release / preemption --------------------------------

    def _first_token(self, req: Request, lane: int, logits) -> None:
        """Sample the prompt's first token and time it (TTFT)."""
        tok0 = int(self._sample(logits)[0])
        self.prefill_tokens += len(req.prompt)
        req.generated.append(tok0)
        if req.ttft is None:
            req.ttft = self.clock() - req.arrival
            req.prefill_s = req.ttft - req.queue_s
        self.h_tokens[lane] = tok0

    def _write_slot(self, lane: int, dense: dict) -> None:
        """One lane's dense decode state into its slot, in place (the
        batch axis differs per key)."""
        for name, ax in self._dense_axes.items():
            if ax == 0:
                self.slots[name][lane] = dense[name]
            else:
                self.slots[name][:, lane] = dense[name]

    def _admit(self, req: Request, lane: int) -> None:
        """Monolithic admission: claim the pages, prefill the whole prompt,
        scatter its KV into the pages, sample the first token.  The request
        decodes in this very step."""
        if req.queue_s is None:
            req.queue_s = self.clock() - req.arrival
        tokens = torch.as_tensor(req.prompt[None], device=self.device)
        if self.paged:
            nb = self.scheduler.pages_needed(req)  # prompt + 1 decode block
            req.page_ids = self.pool.alloc(nb)
            assert req.page_ids is not None     # admission checked capacity
            cache, logits = self.model.prefill(tokens, nb * self.page_size)
        else:
            cache, logits = self.model.prefill(tokens)
        dense, kv = self.model.slot_from_cache(cache, 0)
        self._write_slot(lane, dense)
        if self.paged:
            pids = torch.as_tensor(req.page_ids, device=self.device)
            for arena, x8 in zip((self.pool.k, self.pool.v), kv):
                arena.index_copy_(1, pids, x8.reshape(
                    x8.shape[0], nb, self.page_size, *x8.shape[2:]))
            self.table[lane] = 0
            self.table[lane, :nb] = req.page_ids
            self._table_dev = None
        self._first_token(req, lane, logits)
        req.lane = lane
        req.state = RequestState.DECODE
        self.lane_req[lane] = req

    def _admit_chunked(self, req: Request, lane: int) -> None:
        """Claim a lane and pages; prefill streams in later engine steps.
        Radix lookup first: the longest cached page-aligned prefix is reused
        by reference (one pool ref per hit page), only the suffix pages are
        allocated, and for a family with dense state the deepest hit node's
        snapshot seeds the mid-prefill state."""
        if req.queue_s is None:
            req.queue_s = self.clock() - req.arrival
        hit_pids, hit_dense = [], None
        if self.radix is not None:
            hit_pids, hit_dense = self.radix.lookup(req.prompt)
            for pid in hit_pids:
                self.pool.ref(pid)      # the request's hold on the hit
        req.n_shared = len(hit_pids)
        req.pf_pos = req.n_shared * self.page_size
        req.page_snaps = [None] * (len(req.prompt) // self.page_size)
        if self.paged:
            nb_total = len(req.prompt) // self.page_size + 1  # + decode block
            new_pids = self._alloc_pages(nb_total - req.n_shared, req)
            assert new_pids is not None  # not in lane_req yet: no self-kill
            req.page_ids = list(hit_pids) + new_pids
            self.table[lane] = 0
            self.table[lane, :nb_total] = req.page_ids
            self._table_dev = None
        self._pf_dense[req.rid] = (self._dense0 if hit_dense is None
                                   else hit_dense)
        req.lane = lane
        self.lane_req[lane] = req       # PREFILL state: masked in decode

    def _release(self, req: Request) -> None:
        """Free the lane and unref its pages (shared pages just drop this
        hold).  The lane's dense slot keeps its state: the lane rides along
        in decode with it, as in the reference."""
        for pid in req.page_ids:
            self.pool.unref(pid)
        self._pf_dense.pop(req.rid, None)
        req.page_snaps = []
        if req.lane >= 0:
            self.table[req.lane] = 0
            self.lane_req[req.lane] = None
            self._table_dev = None
        req.page_ids = []
        req.lane = -1

    def _preempt(self, req: Request) -> None:
        self._release(req)
        self.scheduler.preempt(req)

    def _alloc_pages(self, n: int, req: Request) -> list[int] | None:
        """Allocate under pressure: radix LRU eviction first, recompute
        preemption of the longest-context live request second.  Returns
        None iff `req` itself got preempted."""
        pids = self.pool.alloc(n)
        while pids is None and self.radix is not None \
                and self.radix.evictable() > 0:
            self.radix.evict(n - self.pool.free_count)
            pids = self.pool.alloc(n)
        while pids is None:
            live = [r for r in self.lane_req if r is not None]
            if not live:
                raise RuntimeError(
                    f"pool exhausted with no live lanes to preempt "
                    f"(need {n} pages, free {self.pool.free_count})")
            victim = self.scheduler.pick_victim(live)
            self._preempt(victim)
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

    def _view(self, rows: np.ndarray):
        """The pool view over page-table `rows` (None without pages)."""
        if not self.paged:
            return None
        return self.pool.view(torch.as_tensor(rows, device=self.device))

    def _chunk(self, dense: dict, row: np.ndarray, toks: np.ndarray,
               start: int, n_full: int):
        """`prefill_chunk` pages of one lane from logical block `start`,
        from its mid-prefill state `dense`.  Pages at or past `n_full` are
        masked: a paged family runs them onto the trash page (all-zero
        table row) from the last real page's state and drops their state
        and logits; a family without pages skips them.  Returns (the last
        real page's last-token logits, None if none was real; the state
        after it; the state after each real page)."""
        page = self.page_size
        real, masked = self._view(row[None]), self._view(0 * row[None])
        tok = torch.as_tensor(toks, device=self.device)
        lg, snaps = None, []
        for j in range(self.prefill_chunk):
            active = start + j < n_full
            if not (active or self.paged):
                break
            lg2, dn2 = self.model.prefill_page(
                dense, real if active else masked,
                tok[j * page:(j + 1) * page], (start + j) * page)
            if active:
                lg, dense = lg2, dn2
                snaps.append(dn2)
        return lg, dense, snaps

    def _tail(self, dense: dict, row: np.ndarray, token: int, pos: int):
        """One prompt-tail token through the B=1 decode step from the
        mid-prefill state `dense`.  Returns (logits, the state after it;
        its "pos" is the engine's, passed through)."""
        t = torch.full((1,), token, dtype=torch.int32, device=self.device)
        p = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        lg, dn = self.model.paged_decode_step(dict(dense, pos=p),
                                              self._view(row[None]), t)
        return lg, dict(dn, pos=dense["pos"])

    def _warmup(self) -> None:
        """The reference engine's warm-up calls, run the same way: a chunk
        with every page masked (a paged family's), a tail token and a
        decode step, all on the trash page and from the zero state.  They
        compile the reference's traces; here they leave the trash page in
        the state the reference's does.  Their dense results are dropped,
        so the slots stay zero (the reference re-initialises them after
        its warm-up)."""
        zrow = np.zeros((self.n_blocks,), np.int32)
        self._chunk(self._dense0, zrow,
                    np.zeros((self.prefill_chunk * self.page_size,),
                             np.int32), 0, 0)
        self._tail(self._dense0, zrow, 0, 0)
        z = torch.zeros((self.max_lanes,), dtype=torch.int32,
                        device=self.device)
        self.model.paged_decode_step(dict(self.slots, pos=z),
                                     self._view(self.table), z)
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
                toks = np.zeros((self.prefill_chunk * page,), np.int32)
                chunk = req.prompt[start * page:(start + allowed) * page]
                toks[:len(chunk)] = chunk
                lg, self._pf_dense[req.rid], snaps = self._chunk(
                    self._pf_dense[req.rid], self.table[lane], toks, start,
                    start + allowed)
                if self.radix is not None and self.radix.store_dense:
                    req.page_snaps[start:start + allowed] = snaps
                req.pf_pos = (start + allowed) * page
                budget -= allowed * page
                worked = True
            while budget >= 1 and nb_full * page <= req.pf_pos < s:
                lg, self._pf_dense[req.rid] = self._tail(
                    self._pf_dense[req.rid], self.table[lane],
                    int(req.prompt[req.pf_pos]), req.pf_pos)
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
        """Prefill done: sample the first token, move the mid-prefill dense
        state into the lane's slot, flip to DECODE, and publish the full
        prompt pages (with their dense snapshots) to the radix tree
        (deduping against a concurrent identical prefill that published
        first)."""
        self._first_token(req, lane, logits)
        dense = self._pf_dense.pop(req.rid)
        self._write_slot(lane, {
            name: (dense[name][0] if ax == 0 else dense[name][:, 0])
            for name, ax in self._dense_axes.items()})
        req.state = RequestState.DECODE
        self._table_dev = None          # lane unmasks in the decode table
        if self.radix is not None:
            nb_full = len(req.prompt) // self.page_size
            if nb_full:
                dedup = self.radix.insert(req.prompt,
                                          req.page_ids[:nb_full],
                                          req.page_snaps)
                for blk, cached in dedup.items():
                    self.pool.ref(cached)           # byte-identical page:
                    self.pool.unref(req.page_ids[blk])  # swap to cached
                    req.page_ids[blk] = cached
                    self.table[lane, blk] = cached
        req.page_snaps = []

    # ---- decode ----------------------------------------------------------

    def _decode(self) -> np.ndarray:
        pos = np.zeros((self.max_lanes,), np.int32)
        for ln, req in enumerate(self.lane_req):
            if req is not None and req.state is RequestState.DECODE:
                pos[ln] = req.pos
        tokens = torch.as_tensor(self.h_tokens, device=self.device)
        view = None
        if self.paged:
            if self._table_dev is None:     # re-upload only when changed
                # mid-prefill lanes decode masked: their rows point at the
                # trash page so the ride-along writes never touch real pages
                eff = self.table.copy()
                for ln, req in enumerate(self.lane_req):
                    if req is not None \
                            and req.state is not RequestState.DECODE:
                        eff[ln] = 0
                self._table_dev = torch.as_tensor(eff, device=self.device)
            view = self.pool.view(self._table_dev)
        # every lane advances its dense slot: dead and mid-prefill lanes too
        logits, self.slots = self.model.paged_decode_step(
            dict(self.slots, pos=torch.as_tensor(pos, device=self.device)),
            view, tokens)
        # the one host-device sync of the decode step: the token readback
        return self._sample(logits)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- maintenance / metrics -------------------------------------------

    def defrag(self) -> int:
        """Compact the pool's pages; rewrites live page tables, request page
        lists and radix nodes.  Returns the number of pages moved."""
        if not self.paged:
            return 0
        mapping = self.pool.defrag()
        if mapping:
            trans = np.arange(self.pool.n_pages)
            for old, new in mapping.items():
                trans[old] = new
            self.table = trans[self.table].astype(np.int32)
            self._table_dev = None
            for req in self.lane_req:
                if req is not None:
                    req.page_ids = [int(trans[p]) for p in req.page_ids]
            if self.radix is not None:  # shared pages moved exactly once
                self.radix.remap(mapping)
        return len(mapping)

    def metrics(self) -> dict:
        """Engine aggregates + per-request rollups: engine/decode step
        counts, decode_wall_s / prefill_wall_s (host clock, synchronized),
        completed, generated_tokens, prefill_tokens, queue_depth,
        live_lanes, preemptions, skips, straggler_steps, TTFT mean / max /
        p50 / p99 and its split queue_ms_mean / prefill_ms_mean, TPOT mean
        / p50 / p99, decode_tok_s; for a paged family the pool report, and
        with the radix cache on its stats and prefix_hit_rate."""
        done = [r for r in self.scheduler.requests.values()
                if r.state is RequestState.DONE]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        queues = [r.queue_s for r in done if r.queue_s is not None]
        prefills = [r.prefill_s for r in done if r.prefill_s is not None]
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
            "ttft_max_s": float(np.max(ttfts)) if ttfts else 0.0,
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "tpot_mean_s": float(np.mean(tpots)) if tpots else 0.0,
            "tpot_p50_s": pct(tpots, 50),
            "tpot_p99_s": pct(tpots, 99),
            "queue_ms_mean": 1e3 * float(np.mean(queues)) if queues else 0.0,
            "prefill_ms_mean": (1e3 * float(np.mean(prefills))
                                if prefills else 0.0),
            "decode_tok_s": (gen / self.decode_wall_s
                             if self.decode_wall_s > 0 else 0.0),
        }
        if self.pool is not None:
            out["pool"] = self.pool.report(ctx_len=self.max_ctx)
        if self.radix is not None:
            out["radix"] = self.radix.stats()
            out["prefix_hit_rate"] = self.radix.hit_rate
        return out


def fused_decode_active(engine: Engine) -> bool:
    """Whether the engine's decode steps stream KV pages through the fused
    paged-attention kernel (K6) rather than gather-then-attend (K7, then
    K1 in native mode or fp32 products in sim and fp32).  Answered from the
    route `models.layers.paged_decode_attention` takes: fused iff the
    family is paged, the model's mode is native (the decode query is then
    a single-token int8 payload) and its `q.fuse_kernels` is on."""
    q = engine.model.q
    return engine.paged and q.native and q.fuse_kernels
