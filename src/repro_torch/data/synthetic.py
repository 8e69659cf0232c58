"""Deterministic, shardable synthetic token data.

A numpy copy of `repro.data.synthetic.TokenTask` (the port imports nothing
of the reference package): every batch is a pure function of (seed, step,
sample index), so both packages draw identical batches.

  "arith"    learnable: the next token is a fixed affine function of the
             previous two, mod vocab (a convergence probe)
  "uniform"  pure throughput
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def host_local_slice(global_batch: int, shard_idx: int, n_shards: int):
    per = global_batch // n_shards
    return shard_idx * per, per


@dataclass
class TokenTask:
    vocab: int
    seq_len: int
    global_batch: int
    kind: str = "arith"          # arith | uniform
    seed: int = 0

    def sample(self, step: int, start: int, count: int) -> dict:
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2 ** 31))
        rs.randint(0, 2 ** 30, size=start + 1)  # decorrelate shard offsets
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + step * 7919 + start) % (2 ** 31))
        v, s = self.vocab, self.seq_len
        if self.kind == "uniform":
            toks = rs.randint(0, v, size=(count, s + 1), dtype=np.int32)
        else:
            toks = np.empty((count, s + 1), dtype=np.int32)
            toks[:, 0] = rs.randint(0, v, size=count)
            toks[:, 1] = rs.randint(0, v, size=count)
            a, b, c = 3, 5, 7
            for t in range(2, s + 1):
                toks[:, t] = (a * toks[:, t - 1] + b * toks[:, t - 2] + c) % v
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int, shard_idx: int = 0, n_shards: int = 1) -> dict:
        start, count = host_local_slice(self.global_batch, shard_idx,
                                        n_shards)
        return self.sample(step, start, count)
