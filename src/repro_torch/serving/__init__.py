"""Paged int8 serving at tp=1.

  pool.py      — PagePool: refcounted int8 pages + free-list allocator,
                 defrag and the int8-vs-fp32 byte accounting
  radix.py     — RadixCache: prefix-sharing radix tree over the pool
  scheduler.py — request lifecycle, bounded-skip admission, recompute
                 preemption
  engine.py    — Engine: monolithic or chunked prefill, decode over padded
                 lanes (fused or unfused attention), sampling, metrics
  api.py       — make_engine + poisson_traffic / shared_prefix_traffic /
                 run_load / naive_serve
"""
from .api import (make_engine, naive_serve, poisson_traffic, run_load,
                  shared_prefix_traffic)
from .engine import Engine, fused_decode_active, greedy_token, make_sampler
from .pool import PagePool
from .radix import RadixCache
from .scheduler import Request, RequestState, Scheduler

__all__ = ["make_engine", "naive_serve", "poisson_traffic", "run_load",
           "shared_prefix_traffic", "Engine", "fused_decode_active",
           "greedy_token", "make_sampler", "PagePool", "RadixCache",
           "Request", "RequestState", "Scheduler"]
