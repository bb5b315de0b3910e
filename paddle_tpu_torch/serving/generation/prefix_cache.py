"""Radix index over immutable, full KV pages, keyed by token content (the
port's own copy of ``paddle_tpu/serving/generation/prefix_cache.py``: the
same numpy-level index, so the same admissions match, publish and evict the
same pages in both packages).

RadixAttention-style prefix sharing (SGLang) adapted to the paged-pool
substrate: a trie whose every edge is ONE FULL PAGE of token ids
(``page_size`` tokens), mapping a token-content prefix to the pool
pages that already hold its K/V. A request whose prompt walks the trie
reuses those pages directly in its block table — the shared 500-token
preamble prefills once per process; later requests pay prefill only
for their unique suffix.

Sharing rules (the copy-on-write contract):

- Only FULL pages are ever shared, so a shared page is immutable by
  construction: a sequence writes K/V only at positions at or beyond
  its matched prefix, and a page-aligned match puts every write into
  the sequence's own private pages. The divergence page — the first
  page where a request's tokens differ, or its final partial page —
  is always materialized privately (allocated fresh and recomputed by
  the suffix prefill): copy-on-write implemented as
  recompute-into-private-copy, which costs at most ``page_size - 1``
  redundant token prefills and never a device-side page copy.
- A published page carries one index reference (``PagedKVCache.retain``)
  on top of any sequence references. Pages whose ONLY reference is the
  index are *cached* (reusable but reclaimable); under pool pressure
  ``evict`` releases them leaf-first in LRU order — interior nodes are
  never dropped before their descendants, since a lookup must walk an
  unbroken chain from the root.
- Nodes are published only AFTER the prefill/decode step that wrote
  the page content completed, so a matched page always holds valid
  K/V (the engine publishes under its lock, from the worker thread).

Thread-safety: like the allocator, plain data mutated only under the
engine lock.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .kv_cache import PagedKVCache

__all__ = ["PrefixCache"]


class _Node:
    """One full page of the trie: ``tokens`` (length page_size) is the
    edge label, ``page`` the pool page holding that span's K/V."""

    __slots__ = ("tokens", "page", "children", "parent", "last_used")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """The radix index over one ``PagedKVCache`` pool."""

    def __init__(self, kv: PagedKVCache):
        self.kv = kv
        self.page_size = kv.page_size
        # root is a sentinel: children keyed by the first page's tokens
        self._root = _Node((), 0, None)
        self._clock = 0            # monotone LRU tick
        self._n_nodes = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.pages_published = 0
        self.pages_evicted = 0

    def __len__(self) -> int:
        return self._n_nodes

    @property
    def cached_pages(self) -> int:
        return self._n_nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns ``(matched_tokens, pages)`` where ``matched_tokens`` is
        a multiple of ``page_size`` and STRICTLY less than
        ``len(tokens)`` — at least one token is always left for the
        suffix prefill to produce first-token logits. Touches matched
        nodes' LRU clocks; does NOT retain (the caller retains under
        the engine lock while it maps the pages into a block table)
        and does NOT bump hit/miss stats (admission can retry the same
        head-of-line request many times; the engine counts once per
        actual admission via ``note_admission``).
        """
        ps = self.page_size
        tokens = [int(t) for t in tokens]
        node = self._root
        pages: List[int] = []
        tick = self._tick()
        i = 0
        while i + ps < len(tokens):       # strict: keep >= 1 suffix token
            key = tuple(tokens[i:i + ps])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = tick
            pages.append(child.page)
            node = child
            i += ps
        return i, pages

    def note_admission(self, matched_tokens: int) -> None:
        """Count one admitted request's outcome (hit when any prefix
        tokens were reused)."""
        if matched_tokens > 0:
            self.hits += 1
            self.tokens_reused += int(matched_tokens)
        else:
            self.misses += 1

    # ------------------------------------------------------ publish
    def publish(self, tokens: Sequence[int], pages: Sequence[int],
                n_tokens: Optional[int] = None) -> int:
        """Insert the chain of FULL pages covering ``tokens[:n_tokens]``
        whose K/V now lives in ``pages`` (the sequence's block-table
        order). Existing nodes are kept (first writer wins; a duplicate
        page stays private and frees with its sequence); each newly
        published page gains one index reference. Returns the number of
        pages newly published."""
        ps = self.page_size
        n = len(tokens) if n_tokens is None else int(n_tokens)
        n_full = n // ps
        node = self._root
        tick = self._tick()
        fresh = 0
        for pi in range(n_full):
            key = tuple(int(t) for t in tokens[pi * ps:(pi + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = int(pages[pi])
                if self.kv.refcount(page) < 1:
                    break      # defensive: never index an unowned page
                self.kv.retain([page])
                child = _Node(key, page, node)
                node.children[key] = child
                self._n_nodes += 1
                fresh += 1
            child.last_used = tick
            node = child
        self.pages_published += fresh
        return fresh

    # ------------------------------------------------------ eviction
    def _evictable_leaves(self) -> List[_Node]:
        """Leaves whose page the index holds the ONLY reference to —
        shared-with-a-live-sequence pages are pinned (refcount > 1)."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.kv.refcount(n.page) == 1:
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` cached pages, LRU leaf-first
        (evicting a leaf can expose its parent as the next leaf).
        Returns the number of pages actually freed back to the pool."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_pages:
                    break
                freed += self._drop(leaf)
        self.pages_evicted += freed
        return freed

    def clear(self) -> int:
        """Empty the whole index, releasing its reference on EVERY
        node — including pages still pinned by live sequences, which
        stay allocated to those sequences but can no longer be
        matched. The weight-swap invalidation path: cached K/V
        computed under old weights must never serve a new-weight
        request. Returns the number of pages freed to the pool."""
        nodes: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            nodes.append(n)
            stack.extend(n.children.values())
        freed = 0
        for n in nodes:
            freed += self.kv.release([n.page])
        self._root.children = {}
        self._n_nodes = 0
        self.pages_evicted += freed
        return freed

    def _drop(self, node: _Node) -> int:
        assert not node.children
        parent = node.parent
        del parent.children[node.tokens]
        self._n_nodes -= 1
        return self.kv.release([node.page])

    # ------------------------------------------------------ reporting
    def stats(self) -> dict:
        return {
            "cached_pages": self._n_nodes,
            "hits": self.hits,
            "misses": self.misses,
            "tokens_reused": self.tokens_reused,
            "pages_published": self.pages_published,
            "pages_evicted": self.pages_evicted,
        }
