"""Paged int8 KV-cache pool: fixed-size int8 pages + pow2 scales.

Port of `repro.serving.pool.PagePool`.  All resident KV state is int8
payload on a power-of-two grid, cut into fixed-size pages so lanes with
different context lengths share one physical arena.  One logical page owns
that block's storage across ALL layers: the device arrays are
(L, P, page, KV, dh) and a layer's slice is (P, page, KV, dh).

Page id 0 is the trash page: dead lanes' page tables point at it, their
decode writes collide there, and the attention mask never reads it for a
live lane.  The allocator hands out ids 1..P-1, refcounted (`ref`/`unref`).

Unlike the reference, whose jitted steps return new page arrays, the port
updates `k` and `v` IN PLACE (the model writes a page or a token slot into
the arena directly), which saves a copy of the arena per step.
"""
from __future__ import annotations

import torch


class PagePool:
    """Physical page arena + free-list allocator + accounting."""

    def __init__(self, n_pages: int, page_size: int, kv_layers: int,
                 n_kv: int, dh: int, scale: float = 2.0 ** -7,
                 device="cuda"):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.kv_layers, self.n_kv, self.dh = kv_layers, n_kv, dh
        shape = (kv_layers, n_pages, page_size, n_kv, dh)
        self.k = torch.zeros(shape, dtype=torch.int8, device=device)
        self.v = torch.zeros(shape, dtype=torch.int8, device=device)
        self.k_scale = torch.full((kv_layers,), scale, dtype=torch.float32,
                                  device=device)
        self.v_scale = self.k_scale.clone()
        # free list (LIFO for reuse locality); id 0 reserved as trash
        self._free = list(range(n_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}      # live page -> refcount (>= 1)
        self.allocs = 0
        self.frees = 0
        self.failed_allocs = 0
        self.peak_in_use = 0

    @property
    def usable(self) -> int:
        return self.n_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - self.free_count

    def alloc(self, n: int) -> list[int] | None:
        """Pop n pages off the free list, or None (no partial allocation).
        Each page comes out with refcount 1."""
        if n > self.free_count:
            self.failed_allocs += 1
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self._refs[pid] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    def ref(self, pid: int) -> None:
        if pid not in self._refs:
            raise ValueError(f"ref of unallocated page {pid}")
        self._refs[pid] += 1

    def unref(self, pid: int) -> bool:
        """Drop one holder; the page frees when the count reaches zero.
        Returns True iff this call returned the page to the free list."""
        if pid not in self._refs:
            raise ValueError(f"unref of unallocated page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] > 0:
            return False
        del self._refs[pid]
        self._free.append(pid)
        self.frees += 1
        return True

    def view(self, table: torch.Tensor) -> dict:
        """The pool view the model's paged steps take."""
        return {"k_pages": self.k, "v_pages": self.v,
                "k_scale": self.k_scale, "v_scale": self.v_scale,
                "table": table}

    def report(self) -> dict:
        """Occupancy and the int8 footprint beside the fp32 cache the same
        geometry would need."""
        page_elems = self.kv_layers * self.page_size * self.n_kv * self.dh
        int8_bytes = 2 * self.n_pages * page_elems
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "in_use": self.in_use, "free": self.free_count,
                "peak_in_use": self.peak_in_use, "allocs": self.allocs,
                "frees": self.frees, "failed_allocs": self.failed_allocs,
                "pool_bytes_int8": int8_bytes,
                "pool_bytes_fp32_equiv": 4 * int8_bytes}
