"""Deterministic, shardable synthetic data.

Numpy copies of `repro.data.synthetic.TokenTask` and `ImageTask` (the port
imports nothing of the reference package): every batch is a pure function
of (seed, step, sample index), so both packages draw identical batches.

TokenTask kinds:
  "arith"    learnable: the next token is a fixed affine function of the
             previous two, mod vocab (a convergence probe)
  "uniform"  pure throughput
ImageTask: class-conditional Gaussian blobs (learnable) for the ResNet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

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


@dataclass
class ImageTask:
    img_size: int
    num_classes: int
    global_batch: int
    seed: int = 0
    # the class prototypes of (seed, num_classes, img_size): the reference
    # draws them anew on every batch, 602 MB of randn at 224 px and 1000
    # classes; the same draw is kept here after the first batch
    _protos: tuple = field(default=(None, None), init=False, repr=False,
                           compare=False)

    def _prototypes(self) -> np.ndarray:
        key = (self.seed, self.num_classes, self.img_size)
        if self._protos[0] != key:
            proto_rs = np.random.RandomState(self.seed + 12345)
            self._protos = (key, proto_rs.randn(
                self.num_classes, self.img_size, self.img_size,
                3).astype(np.float32))
        return self._protos[1]

    def batch(self, step: int, shard_idx: int = 0, n_shards: int = 1) -> dict:
        start, count = host_local_slice(self.global_batch, shard_idx,
                                        n_shards)
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + step * 7919 + start) % (2 ** 31))
        labels = rs.randint(0, self.num_classes, size=count).astype(np.int32)
        # class-conditional means on a fixed random direction per class
        imgs = (self._prototypes()[labels]
                + 0.8 * rs.randn(count, self.img_size, self.img_size, 3)
                ).astype(np.float32)
        return {"images": imgs, "labels": labels}

    def holdout_batch(self, i: int) -> dict:
        """Held-out eval batches: fresh steps the model never trains on."""
        return self.batch(10_000 + i)
