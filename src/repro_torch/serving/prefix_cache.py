"""Cross-request prefix sharing: a host-side radix tree over source tokens.

Port of ``repro/serving/prefix_cache.py`` (host only; no torch).  The same
source sentences arrive over and over at serving time, and the encoder
plus the cross-K/V projection of each is recomputation.  This module
hash-conses the *encoded* cross-attention K/V across requests:

* The tree is keyed by page-granular chunks of the source token ids
  (``page_size`` tokens a chunk, the last one partial), so a walk costs
  O(len(src) / page_size) lookups and page-aligned prefixes share a spine.
  Payload chains hang off **terminal** nodes only: a cached entry is used
  when the incoming source matches it *exactly*.  The encoder is
  bidirectional, so the encoding of a strict prefix is not a prefix of the
  longer source's encoding; reusing partial prefixes would change tokens.

* The payload lives in a page pool on the device
  (``models.kv_cache.insert_chain_pages`` / ``gather_chain_pages``),
  managed by this cache's own :class:`PageAllocator`.  Refcounts above 1
  are real here: the tree holds one reference per chain and every request
  reading the chain holds another (``retain`` at admission, dropped by
  :meth:`PrefixCache.finish` at release).

* Eviction is LRU over chains nobody is reading (every page at refcount
  exactly 1, only the tree's own reference).  When a reservation fails the
  cache evicts cold chains one at a time until it fits or nothing is
  evictable; then the admission proceeds *uncached* (role ``"skip"``), so
  a small pool costs throughput, never progress.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.kv_cache import PageAllocator, pages_per_row

__all__ = ["CachedChain", "PrefixCache", "PrefixCacheStats"]


@dataclasses.dataclass(frozen=True)
class CachedChain:
    """One cached source: its tree key, page chain and token length."""

    key: Tuple[bytes, ...]
    pages: Tuple[int, ...]
    src_len: int

    @property
    def n_pages(self) -> int:
        return len(self.pages)


@dataclasses.dataclass
class PrefixCacheStats:
    """Monotonic counters (the engine reports per-serve deltas)."""

    hits: int = 0
    misses: int = 0
    inserts: int = 0
    skipped_inserts: int = 0
    evictions: int = 0
    hit_pages: int = 0          # pages whose encode+store a hit skipped
    pages_allocated: int = 0    # chain pages reserved by inserts

    def snapshot(self) -> "PrefixCacheStats":
        return dataclasses.replace(self)


class _Node:
    __slots__ = ("children", "chain")

    def __init__(self):
        self.children: Dict[bytes, "_Node"] = {}
        self.chain: Optional[CachedChain] = None


class PrefixCache:
    """Radix tree of cached sources + LRU eviction over their page chains.

    Host-side bookkeeping only: the engine owns the device pool and does
    the scatter and gather; this object decides which pages hold which
    source and who is reading them.
    """

    def __init__(self, allocator: PageAllocator):
        self.allocator = allocator
        self.page_size = allocator.page_size
        self._root = _Node()
        self._lru: Dict[Tuple[bytes, ...], CachedChain] = {}  # insertion = LRU
        self.stats = PrefixCacheStats()

    # ------------------------------------------------------------- keying
    def _chunks(self, src) -> Tuple[bytes, ...]:
        toks = np.ascontiguousarray(np.asarray(src, np.int32))
        if toks.size == 0:
            return (b"",)
        ps = self.page_size
        return tuple(toks[i:i + ps].tobytes()
                     for i in range(0, toks.size, ps))

    # ------------------------------------------------------------- lookup
    def _find(self, key: Tuple[bytes, ...]) -> Optional[CachedChain]:
        node = self._root
        for chunk in key:
            node = node.children.get(chunk)
            if node is None:
                return None
        return node.chain

    def lookup(self, src) -> Optional[CachedChain]:
        """Side-effect-free probe (no stats, no refcounts, no LRU bump)."""
        return self._find(self._chunks(src))

    # ---------------------------------------------------------- admission
    def admit(self, src) -> Tuple[str, Optional[CachedChain]]:
        """Route one admission through the cache.

        Returns ``(role, chain)``:

        * ``("hit", chain)``: the exact source is cached and every chain
          page was retained for this request; skip the encoder and gather
          the chain.
        * ``("insert", chain)``: a miss whose reservation succeeded; the
          pages are retained for this request and referenced by the tree.
          Encode normally and scatter the result into ``pages``.
        * ``("skip", None)``: a miss the pool could not fit even after
          eviction; encode normally, cache nothing.

        For "hit" and "insert" the caller hands ``chain`` back to
        :meth:`finish` exactly once, when the request releases.
        """
        key = self._chunks(src)
        chain = self._find(key)
        if chain is not None:
            self.allocator.retain(chain.pages)
            self._lru.pop(key, None)
            self._lru[key] = chain                   # bump to most-recent
            self.stats.hits += 1
            self.stats.hit_pages += chain.n_pages
            return "hit", chain
        self.stats.misses += 1
        n = pages_per_row(len(np.asarray(src).reshape(-1)), self.page_size)
        pages = self._reserve(n)
        if pages is None:
            self.stats.skipped_inserts += 1
            return "skip", None
        chain = CachedChain(key=key, pages=tuple(pages),
                            src_len=int(np.asarray(src).reshape(-1).size))
        node = self._root
        for chunk in key:
            node = node.children.setdefault(chunk, _Node())
        node.chain = chain
        self._lru[key] = chain
        self.allocator.retain(chain.pages)           # requester's reference
        self.stats.inserts += 1
        self.stats.pages_allocated += n
        return "insert", chain

    def finish(self, chain: Optional[CachedChain]) -> None:
        """Drop one request's reference on its chain (at release)."""
        if chain is not None:
            self.allocator.release(chain.pages)

    # ----------------------------------------------------------- eviction
    def _reserve(self, n: int) -> Optional[List[int]]:
        while True:
            pages = self.allocator.alloc(n)
            if pages is not None:
                return pages
            if not self._evict_one():
                return None

    def _evict_one(self) -> bool:
        """Evict the least-recently-used chain nobody is reading."""
        for key, chain in self._lru.items():
            if all(self.allocator.refcount(p) == 1 for p in chain.pages):
                self._remove(key)
                self.allocator.release(chain.pages)
                self.stats.evictions += 1
                return True
        return False

    def _remove(self, key: Tuple[bytes, ...]) -> None:
        self._lru.pop(key, None)
        path = [self._root]
        for chunk in key:
            nxt = path[-1].children.get(chunk)
            if nxt is None:
                return
            path.append(nxt)
        path[-1].chain = None
        for depth in range(len(key) - 1, -1, -1):    # prune empty spine
            node = path[depth + 1]
            if node.chain is None and not node.children:
                del path[depth].children[key[depth]]
            else:
                break

    def clear(self) -> None:
        """Drop every chain nobody is reading."""
        for key in [k for k, c in self._lru.items()
                    if all(self.allocator.refcount(p) == 1
                           for p in c.pages)]:
            chain = self._lru[key]
            self._remove(key)
            self.allocator.release(chain.pages)
            self.stats.evictions += 1

    # ----------------------------------------------------------- metrics
    @property
    def n_chains(self) -> int:
        return len(self._lru)

    @property
    def pages_held(self) -> int:
        return sum(c.n_pages for c in self._lru.values())
