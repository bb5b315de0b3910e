"""Paged KV cache: device pools + the host-side page allocator (the port of
``paddle_tpu/serving/generation/kv_cache.py``).

The device side is the model's pools (``model.init_kv_pools``): per-layer
``[num_pages, page_size, heads, head_dim]`` tensors (or int8 ``(values,
scales)`` tuples), or one ``[num_layers, ...]`` stacked pool per side for the
stacked decoder, which the prefill/decode steps update in place
(ops/paged_attention.py). Nothing here looks inside them but
``pool_bytes``. The host side here owns
which pages belong to whom: a free list, per-page reference counts, and the
eviction accounting. Page 0 is the reserved trash page (masked writes land
there) and is never handed out.

Pages are refcounted (``alloc`` hands them out at 1, ``retain`` adds a
sharer, ``release``/``free`` drop one reference and a page returns to the
free list with its last one), so the prefix cache (prefix_cache.py) can
share full pages; ``leak_check`` verifies that free and referenced pages
cover the capacity exactly.

Thread-safety: the engine's worker thread is the only mutator; the
allocator itself is plain data guarded by the engine lock.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

__all__ = ["PagedKVCache"]


def _pool_leaves(pools):
    """The tensors of a pool structure — a tensor, or nested lists and
    tuples of them (per-layer lists, int8 ``(values, scales)`` tuples,
    stacked pools) — in order."""
    if isinstance(pools, (list, tuple)):
        return [t for p in pools for t in _pool_leaves(p)]
    return [pools]


class PagedKVCache:
    """Host bookkeeping for one set of pools.

    ``num_pages`` INCLUDES the trash page, so ``capacity`` (allocatable
    pages) is ``num_pages - 1``. ``alloc`` is all-or-nothing.
    """

    def __init__(self, model, num_pages: int, page_size: int, dtype=None):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page plus the "
                             "trash page")
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        # dtype may be the string "int8": pools then carry per-slot absmax
        # scales beside int8 values (ops/paged_attention)
        self.kv_dtype = dtype if isinstance(dtype, str) else ""
        self.k, self.v = model.init_kv_pools(self.num_pages, self.page_size,
                                             dtype)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}      # page -> live reference count
        self.evicted_pages_total = 0

    # ---- geometry ----
    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` positions."""
        return max(1, math.ceil(tokens / self.page_size))

    def pool_bytes(self) -> int:
        """Device bytes resident in the K+V pools (quantized pools count
        their scale planes), whatever their structure: per-layer lists or
        one stacked pool per side."""
        return sum(t.numel() * t.element_size()
                   for t in _pool_leaves((self.k, self.v)))

    # ---- allocation ----
    def alloc(self, n_pages: int) -> Optional[List[int]]:
        """Take ``n_pages`` from the free list (each at refcount 1), or None
        (and take nothing) if fewer are free."""
        if n_pages > len(self._free):
            return None
        taken = self._free[-n_pages:]
        del self._free[-n_pages:]
        for p in taken:
            self._ref[p] = 1
        return taken

    def retain(self, pages: List[int]) -> None:
        """Add one reference to each already-allocated page."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"retain of unallocated page {p}")
            self._ref[p] += 1

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def release(self, pages: List[int]) -> int:
        """Drop one reference per page; pages whose last reference goes
        away return to the free list (their contents stay as garbage until
        rewritten: correctness relies on block tables, not on zeroing).
        Returns the number of pages actually freed."""
        freed = 0
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} out of range")
            n = self._ref.get(p, 0)
            if n < 1:
                raise RuntimeError(
                    f"double free: page {p} has no live references")
            if n == 1:
                del self._ref[p]
                self._free.append(p)
                freed += 1
            else:
                self._ref[p] = n - 1
        self.evicted_pages_total += freed
        if len(self._free) > self.capacity:
            raise RuntimeError("double free: free list exceeds capacity")
        return freed

    def free(self, pages: List[int]) -> int:
        """Return a finished sequence's references (alias of
        ``release``)."""
        return self.release(pages)

    # ---- invariants ----
    def leak_check(self) -> dict:
        """Accounting snapshot: free + referenced must cover capacity
        exactly, with no page both free and referenced."""
        free_set = set(self._free)
        overlap = sorted(free_set & set(self._ref))
        bad_refs = sorted(p for p, n in self._ref.items() if n < 1)
        return {
            "capacity": self.capacity,
            "free": len(self._free),
            "referenced": len(self._ref),
            "leaked": self.capacity - len(self._free) - len(self._ref),
            "double_booked": overlap,
            "nonpositive_refcounts": bad_refs,
            "ok": (len(self._free) + len(self._ref) == self.capacity
                   and not overlap and not bad_refs),
        }

    def assert_no_leaks(self) -> None:
        chk = self.leak_check()
        if not chk["ok"]:
            raise AssertionError(f"KV page accounting leak: {chk}")
