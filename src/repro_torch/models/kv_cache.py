"""KV cache with an optional INT8 payload (paper §5.3): port of
``repro/models/kv_cache.py`` — the contiguous cache, the paged cache with
its host-side ``PageAllocator``, the slot and group operations continuous
greedy and beam serving need, the paged cache's zero-copy beam reorder
(``gather_beams_paged``), and the prefix cache's chain pages
(``insert_chain_pages``, ``gather_chain_pages``).

Keeping the cache int8 (per-token per-head symmetric scales, computed when
the token is appended) cuts the bytes every decode step reads, and that a
beam reorder moves, 4× against f32.

Unlike the reference's immutable arrays, payload writes (appends, splices)
go into the cache tensors in place: a decode step then allocates no new
cache.  The small per-row tensors (cursors, block tables) are replaced, not
mutated.  Callers hand the cache on and do not reuse the old one, as in the
reference.

Row lists that come from the host (admission slots, freed slots) are numpy
arrays; entries outside ``[0, rows)`` are padding, dropped on the host
before the upload (``in_range_rows``), as the reference's ``mode="drop"``
scatters drop them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.qtensor import INV_127

INT8_MAX = 127.0
_EPS = 1e-12


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity cache for one attention stack (layers stacked).

    ``k``/``v``: (L, B, S_max, HKV, dh) int8 or activation dtype.
    ``k_scale``/``v_scale``: (L, B, S_max, HKV) f32, or None (fp cache).
    ``lengths``: (B,) int32 valid lengths / per-sequence write cursors.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def nbytes(self) -> int:
        """Bytes of payload and scales: what :func:`gather_beams` moves."""
        n = self.k.numel() * self.k.element_size() * 2
        if self.quantized:
            n += self.k_scale.numel() * 4 * 2
        return int(n)


def init_cache(n_layers: int, batch: int, max_len: int, n_kv: int, dh: int,
               *, quantized: bool, dtype=torch.bfloat16,
               device=None) -> KVCache:
    shape = (n_layers, batch, max_len, n_kv, dh)
    if quantized:
        k = torch.zeros(shape, dtype=torch.int8, device=device)
        v = torch.zeros(shape, dtype=torch.int8, device=device)
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    else:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = vs = None
    return KVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token per-head symmetric quantization: (…, dh) → int8 + scale.

    The scale is ``amax · float32(1/127)`` (the reference's ``amax / 127``
    as its jitted engine computes it), the codes an IEEE division by it
    rounded half to even, so both equal the engine's bit for bit."""
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1), _EPS)
    scale = amax * INV_127
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class LayerCacheView:
    """One layer's slice, as consumed by attention.

    Contiguous cache: ``k``/``v`` are (B, S, HKV, dh) views into the stacked
    cache.  Paged cache: ``k``/``v`` are the layer's page *store*
    (P + 1, ps, HKV, dh) — the pool and its sink page, see
    :class:`PagedKVCache` — and ``block_tables`` (B, maxP) maps rows to
    pages (None ⇔ contiguous).
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor      # (B,)
    block_tables: Optional[torch.Tensor] = None


def layer_view(cache: KVCache, layer: int) -> LayerCacheView:
    """Layer ``layer`` of a contiguous cache, as attention reads it."""
    pick = lambda a: None if a is None else a[layer]
    return LayerCacheView(k=cache.k[layer], v=cache.v[layer],
                          k_scale=pick(cache.k_scale),
                          v_scale=pick(cache.v_scale), lengths=cache.lengths)


def write_prompt(cache: KVCache, layer: int, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Write a prompt's K/V (B, S, HKV, dh) into positions [0, S) of
    ``layer`` in place, quantized to int8 for an INT8 cache."""
    S = k.shape[1]
    if cache.quantized:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache.k[layer, :, :S] = kq
        cache.v[layer, :, :S] = vq
        cache.k_scale[layer, :, :S] = ks
        cache.v_scale[layer, :, :S] = vs
    else:
        cache.k[layer, :, :S] = k.to(cache.k.dtype)
        cache.v[layer, :, :S] = v.to(cache.v.dtype)


def _put(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``cache[b, pos[b]] = new[b]`` in place, for rows with ``pos < S``.

    Rows at or past capacity write nowhere (the reference's ``mode="drop"``
    scatter): their clamped slot is rewritten with its own old value, so
    no row's cursor is read on the host.
    """
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    live = (pos < S).reshape((B,) + (1,) * (new.dim() - 1))
    slot = pos.clamp(max=S - 1).long()
    cache[rows, slot] = torch.where(live, new.to(cache.dtype),
                                    cache[rows, slot])


def append_tokens(
    k_cache: torch.Tensor,               # (B, S_max, HKV, dh)
    v_cache: torch.Tensor,
    ks_cache: Optional[torch.Tensor],
    vs_cache: Optional[torch.Tensor],
    k_new: torch.Tensor,                 # (B, T, HKV, dh) fp
    v_new: torch.Tensor,
    lengths: torch.Tensor,               # (B,) per-sequence cursors
):
    """Write ``T`` consecutive tokens per row starting at its cursor (in
    place): row b's token t lands at ``lengths[b] + t``; any position at or
    past capacity writes nowhere."""
    if ks_cache is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
    for t in range(k_new.shape[1]):
        pos = lengths + t
        if ks_cache is not None:
            _put(k_cache, kq[:, t], pos)
            _put(v_cache, vq[:, t], pos)
            _put(ks_cache, ks[:, t], pos)
            _put(vs_cache, vs[:, t], pos)
        else:
            _put(k_cache, k_new[:, t], pos)
            _put(v_cache, v_new[:, t], pos)
    return k_cache, v_cache, ks_cache, vs_cache


def gather_beams(cache: KVCache, beam_idx: torch.Tensor) -> KVCache:
    """Beam-search cache reorder along batch — the paper's GatherNd.

    ``beam_idx``: (B,) source rows.  On an int8 cache this moves 4× fewer
    bytes than f32 (2× vs bf16).
    """
    idx = beam_idx.long()
    take = lambda a: None if a is None else a.index_select(1, idx)
    return KVCache(k=take(cache.k), v=take(cache.v),
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale),
                   lengths=cache.lengths.index_select(0, idx))


# ---------------------------------------------------------------------------
# slot operations of continuous serving (contiguous cache)
# ---------------------------------------------------------------------------

def in_range_rows(rows, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split a host row list into (positions of its in-range entries, those
    rows), both int64: entries outside ``[0, n_rows)`` are padding, and are
    dropped here as the reference's ``mode="drop"`` scatters drop them."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    keep = np.flatnonzero((rows >= 0) & (rows < n_rows))
    return keep, rows[keep]


def insert_at_slots(cache: KVCache, sub: KVCache, slots) -> KVCache:
    """Scatter ``sub``'s batch rows into ``slots`` of the running cache.

    The continuous-batching engine prefills newly admitted requests as a
    small side batch and splices its rows into the long-lived decode cache
    mid-flight (the payload in place).  ``slots``: (B_sub,) host array of
    unique destination rows; out-of-range entries are padding and dropped.
    """
    if cache.quantized != sub.quantized:
        raise ValueError("cannot mix quantized and fp caches "
                         f"(main quantized={cache.quantized}, "
                         f"sub quantized={sub.quantized})")
    if cache.capacity != sub.capacity:
        raise ValueError(f"capacity mismatch: {cache.capacity} vs "
                         f"{sub.capacity}")
    keep, rows = in_range_rows(slots, cache.lengths.shape[0])
    dev = cache.lengths.device
    src = torch.as_tensor(keep, device=dev)
    dst = torch.as_tensor(rows, device=dev)
    for main, part in ((cache.k, sub.k), (cache.v, sub.v),
                       (cache.k_scale, sub.k_scale),
                       (cache.v_scale, sub.v_scale)):
        if main is not None:
            main[:, dst] = part[:, src].to(main.dtype)
    return dataclasses.replace(cache, lengths=cache.lengths.index_put(
        (dst,), sub.lengths[src].to(cache.lengths.dtype)))


def free_slots(cache: KVCache, slots) -> KVCache:
    """Mark ``slots`` empty by resetting their write cursors to zero.

    The payload is left in place: every read is masked by ``lengths`` and
    the next ``insert_at_slots`` overwrites the rows wholesale."""
    _, rows = in_range_rows(slots, cache.lengths.shape[0])
    dst = torch.as_tensor(rows, device=cache.lengths.device)
    return dataclasses.replace(cache, lengths=cache.lengths.index_put(
        (dst,), torch.zeros_like(cache.lengths[dst])))


def free_inactive(cache: KVCache, live: torch.Tensor) -> KVCache:
    """Mask-driven ``free_slots`` (the fused admission prologue): every row
    not in ``live`` (B,) bool gets its write cursor reset to 0."""
    return dataclasses.replace(cache, lengths=torch.where(
        live, cache.lengths, torch.zeros_like(cache.lengths)))


def with_lengths(cache, lengths: torch.Tensor):
    """Replace the write cursors of a :class:`KVCache`/:class:`PagedKVCache`
    (the payload past a cursor is junk by contract)."""
    return dataclasses.replace(cache, lengths=lengths)


def group_rows(base_slots, group: int) -> np.ndarray:
    """Expand group base rows to the strided row set they own: (G,) host
    base rows → (G * group,) rows ``base + [0, group)``.  An out-of-range
    base expands to out-of-range rows, which every scatter drops."""
    base = np.asarray(base_slots, np.int64).reshape(-1)
    return (base[:, None] + np.arange(group)[None, :]).reshape(-1)


def insert_at_groups(cache: KVCache, sub: KVCache, base_slots,
                     group: int) -> KVCache:
    """Group-strided :func:`insert_at_slots`: ``sub`` holds ``group``
    contiguous rows per base slot, spliced into ``[base, base + group)``."""
    return insert_at_slots(cache, sub, group_rows(base_slots, group))


def free_groups(cache: KVCache, base_slots, group: int) -> KVCache:
    """Group-strided :func:`free_slots`: a finished beam group frees all
    ``group`` of its rows at once (cursor reset only)."""
    return free_slots(cache, group_rows(base_slots, group))


# ---------------------------------------------------------------------------
# paged cache: fixed-size pages + per-row block tables
# ---------------------------------------------------------------------------
#
# The paged cache stores tokens in fixed-size pages shared by all rows; each
# row sees its sequence through a block table of page ids.  HBM is reserved
# per *request* (ceil(budget / page_size) pages per live row) instead of per
# grid row, so short-budget requests stop paying for max_len capacity and a
# fixed pool admits more concurrent rows.
#
# Sentinel convention (the reference's): the page id ``n_pages`` (one past
# the pool) marks an unreserved block-table slot.  A row stepping past its
# reservation (finished rows keep stepping until the burst edge) writes
# nowhere; reads clamp into the pool and are masked by ``lengths``.
#
# The reference drops such writes with ``mode="drop"`` scatters.  A torch
# scatter has no drop mode, and clamping a dropped write into the pool could
# land it on a page that a live row owns, racing the live row's write in one
# scatter.  So the store holds one page more than the pool: the sentinel id
# *is* the index of that sink page, every dropped write lands there, and no
# read ever touches it.


@dataclasses.dataclass
class PagedKVCache:
    """Paged cache for one attention stack (layers stacked).

    ``k_store``/``v_store``: (L, n_pages + 1, page_size, HKV, dh) int8 or
    activation dtype; ``ks_store``/``vs_store``: (L, n_pages + 1,
    page_size, HKV) f32 or None.  Page ``n_pages`` is the sink.
    ``k``/``v``/``k_scale``/``v_scale`` are views of the pool without the
    sink: the reference's arrays.
    ``block_tables``: (B, max_pages) int32 — token position p of row r
    lives in page ``block_tables[r, p // page_size]`` at offset
    ``p % page_size``.  ``own_pages``: (B, max_pages) int32 — the pages
    physically reserved for row r.  ``lengths``: (B,) int32 cursors.
    """

    k_store: torch.Tensor
    v_store: torch.Tensor
    ks_store: Optional[torch.Tensor]
    vs_store: Optional[torch.Tensor]
    block_tables: torch.Tensor
    own_pages: torch.Tensor
    lengths: torch.Tensor

    @property
    def k(self) -> torch.Tensor:
        return self.k_store[:, :-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_store[:, :-1]

    @property
    def k_scale(self) -> Optional[torch.Tensor]:
        return None if self.ks_store is None else self.ks_store[:, :-1]

    @property
    def v_scale(self) -> Optional[torch.Tensor]:
        return None if self.vs_store is None else self.vs_store[:, :-1]

    @property
    def quantized(self) -> bool:
        return self.ks_store is not None

    @property
    def n_pages(self) -> int:
        return self.k_store.shape[1] - 1

    @property
    def page_size(self) -> int:
        return self.k_store.shape[2]

    @property
    def max_pages(self) -> int:
        return self.block_tables.shape[1]

    @property
    def capacity(self) -> int:
        """Logical row capacity in tokens (same contract as ``KVCache``)."""
        return self.max_pages * self.page_size

    def nbytes(self) -> int:
        """Bytes the cache holds on the device: the reference's count (pool
        payload, scales, tables) plus the sink page."""
        n = self.k_store.numel() * self.k_store.element_size() * 2
        if self.quantized:
            n += self.ks_store.numel() * 4 * 2
        n += (self.block_tables.numel() + self.own_pages.numel()) * 4
        return int(n)

    def reorder_bytes_per_step(self) -> int:
        """Bytes one beam reorder moves (the reference's count, which has
        no sink page): the block-table and cursor permutation plus one
        page copy per row; compare ``KVCache.nbytes()``, which
        :func:`gather_beams` moves."""
        L, _, ps, HKV, dh = self.k_store.shape
        B = self.block_tables.shape[0]
        page = L * B * ps * HKV * dh * self.k_store.element_size() * 2
        if self.quantized:
            page += L * B * ps * HKV * 4 * 2
        return int(page + self.block_tables.numel() * 4 + B * 4)


def pages_per_row(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions (≥ 1)."""
    return max((int(n_tokens) + page_size - 1) // page_size, 1)


def init_paged_cache(n_layers: int, batch: int, max_len: int, n_kv: int,
                     dh: int, *, page_size: int, n_pages: Optional[int] = None,
                     quantized: bool, dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Pool of ``n_pages`` pages (plus the sink) and all-sentinel tables.

    ``max_len`` must be a page multiple, so the linearized paged view has
    exactly the contiguous cache's shape: that is what makes the paged path
    bit-identical to the contiguous one.  ``n_pages`` defaults to full
    contiguous-equivalent capacity (``batch × max_pages``).
    """
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"page_size={page_size}")
    max_pages = max_len // page_size
    if n_pages is None:
        n_pages = batch * max_pages
    shape = (n_layers, n_pages + 1, page_size, n_kv, dh)
    if quantized:
        k = torch.zeros(shape, dtype=torch.int8, device=device)
        v = torch.zeros(shape, dtype=torch.int8, device=device)
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    else:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = vs = None
    tables = torch.full((batch, max_pages), n_pages, dtype=torch.int32,
                        device=device)
    return PagedKVCache(k_store=k, v_store=v, ks_store=ks, vs_store=vs,
                        block_tables=tables, own_pages=tables.clone(),
                        lengths=torch.zeros((batch,), dtype=torch.int32,
                                            device=device))


def append_tokens_paged(
    k_store: torch.Tensor,               # (P + 1, ps, HKV, dh) one layer
    v_store: torch.Tensor,
    ks_store: Optional[torch.Tensor],    # (P + 1, ps, HKV)
    vs_store: Optional[torch.Tensor],
    block_tables: torch.Tensor,          # (B, maxP) int32
    k_new: torch.Tensor,                 # (B, T, HKV, dh) fp
    v_new: torch.Tensor,
    lengths: torch.Tensor,               # (B,) per-row cursors
):
    """Paged append of T consecutive tokens per row, in place.

    Row b's token t targets position ``lengths[b] + t``; its page comes
    from the block table.  Positions past capacity and sentinel entries go
    to the sink page ``P`` (the reference drops them), so a dropped write
    never shares a (page, offset) with a live one.
    """
    P, ps = k_store.shape[0] - 1, k_store.shape[1]
    maxP = block_tables.shape[1]
    T = k_new.shape[1]
    pos = (lengths.long()[:, None]
           + torch.arange(T, device=lengths.device)[None, :])
    slot = torch.div(pos, ps, rounding_mode="floor")
    off = pos - slot * ps
    entry = torch.gather(block_tables.long(), 1, slot.clamp(max=maxP - 1))
    page = torch.where(slot < maxP, entry.clamp(0, P),
                       torch.full_like(entry, P))
    if ks_store is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        k_store[page, off] = kq
        v_store[page, off] = vq
        ks_store[page, off] = ks
        vs_store[page, off] = vs
    else:
        k_store[page, off] = k_new.to(k_store.dtype)
        v_store[page, off] = v_new.to(v_store.dtype)
    return k_store, v_store, ks_store, vs_store


def append_token_paged(k_store, v_store, ks_store, vs_store, block_tables,
                       k_new, v_new, lengths):
    """One new token per row at its own cursor (``k_new``: (B, 1, …))."""
    return append_tokens_paged(k_store, v_store, ks_store, vs_store,
                               block_tables, k_new, v_new, lengths)


def linearize_pages(pages: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Gather one layer's paged payload into the contiguous row view.

    ``pages``: (P, ps, …) pool (no sink) → (B, maxP·ps, …).  Sentinel
    entries clamp into the pool and read garbage; every consumer masks by
    ``lengths``.
    """
    P = pages.shape[0]
    B, maxP = block_tables.shape
    got = pages[block_tables.long().clamp(0, P - 1)]    # (B, maxP, ps, …)
    return got.reshape((B, maxP * pages.shape[1]) + tuple(pages.shape[2:]))


def assign_pages(cache: PagedKVCache, rows, pages) -> PagedKVCache:
    """Install per-row page reservations (admission).

    ``rows``: (R,) host destination rows (out-of-range entries dropped);
    ``pages``: (R, maxP) host page ids, sentinel-padded past each row's
    reservation.  Both ``own_pages`` and ``block_tables`` are set and the
    cursors reset to 0.
    """
    keep, dst = in_range_rows(rows, cache.lengths.shape[0])
    dev = cache.lengths.device
    dst = torch.as_tensor(dst, device=dev)
    pg = torch.as_tensor(np.asarray(pages, np.int32)[keep], device=dev)
    return dataclasses.replace(
        cache,
        block_tables=cache.block_tables.index_put((dst,), pg),
        own_pages=cache.own_pages.index_put((dst,), pg),
        lengths=cache.lengths.index_put(
            (dst,), torch.zeros_like(cache.lengths[dst])))


def free_slots_paged(cache: PagedKVCache, slots) -> PagedKVCache:
    """Paged ``free_slots``: reset cursors AND sentinel the freed rows'
    tables.  A freed row keeps stepping until refilled, and its pages may
    be handed to a new request: its writes must go to the sink."""
    _, dst = in_range_rows(slots, cache.lengths.shape[0])
    dst = torch.as_tensor(dst, device=cache.lengths.device)
    sent = torch.full((dst.shape[0], cache.max_pages), cache.n_pages,
                      dtype=torch.int32, device=dst.device)
    return dataclasses.replace(
        cache,
        block_tables=cache.block_tables.index_put((dst,), sent),
        own_pages=cache.own_pages.index_put((dst,), sent),
        lengths=cache.lengths.index_put(
            (dst,), torch.zeros_like(cache.lengths[dst])))


def free_inactive_paged(cache: PagedKVCache,
                        live: torch.Tensor) -> PagedKVCache:
    """Mask-driven :func:`free_slots_paged` for the fused admission
    prologue: every row not in ``live`` gets cursor 0 and all-sentinel
    tables, so its pages can be reassigned by the splice that follows."""
    sent = torch.full_like(cache.block_tables, cache.n_pages)
    col = live[:, None]
    return dataclasses.replace(
        cache,
        block_tables=torch.where(col, cache.block_tables, sent),
        own_pages=torch.where(col, cache.own_pages, sent),
        lengths=torch.where(live, cache.lengths,
                            torch.zeros_like(cache.lengths)))


def insert_rows_paged(cache: PagedKVCache, sub: KVCache, slots,
                      pages) -> PagedKVCache:
    """Splice a *contiguous* prefilled side batch into the paged cache
    (the unfused admission path): each sub row is cut into page-sized
    chunks that go to its reserved ``pages`` (host (W, maxP), sentinel
    entries drop their chunk), and the tables and cursors of ``slots``
    (host (W,), out-of-range entries dropped) are installed.
    """
    if cache.quantized != sub.quantized:
        raise ValueError("cannot mix quantized and fp caches "
                         f"(main quantized={cache.quantized}, "
                         f"sub quantized={sub.quantized})")
    if sub.capacity != cache.capacity:
        raise ValueError(f"capacity mismatch: paged {cache.capacity} vs "
                         f"side batch {sub.capacity}")
    ps, maxP, P = cache.page_size, cache.max_pages, cache.n_pages
    W = sub.k.shape[1]
    pages = np.asarray(pages, np.int64).reshape(W, maxP)
    dev = cache.lengths.device
    chunk_keep, ids = in_range_rows(pages.reshape(-1), P)
    src = torch.as_tensor(chunk_keep, device=dev)
    dst = torch.as_tensor(ids, device=dev)
    for store, part in ((cache.k_store, sub.k), (cache.v_store, sub.v),
                        (cache.ks_store, sub.k_scale),
                        (cache.vs_store, sub.v_scale)):
        if store is not None:
            # (L, W, maxP·ps, …) → (L, W·maxP, ps, …) page-sized chunks
            chunks = part.reshape((part.shape[0], W * maxP, ps)
                                  + tuple(part.shape[3:]))
            store[:, dst] = chunks[:, src].to(store.dtype)
    row_keep, rows = in_range_rows(slots, cache.lengths.shape[0])
    rows = torch.as_tensor(rows, device=dev)
    pg = torch.as_tensor(pages[row_keep].astype(np.int32), device=dev)
    lengths = sub.lengths[torch.as_tensor(row_keep, device=dev)]
    return dataclasses.replace(
        cache,
        block_tables=cache.block_tables.index_put((rows,), pg),
        own_pages=cache.own_pages.index_put((rows,), pg),
        lengths=cache.lengths.index_put(
            (rows,), lengths.to(torch.int32)))


def cow_write_slot(cache: PagedKVCache) -> PagedKVCache:
    """Copy-on-write of each row's current write-slot page.

    For every row, the page its block table maps for the next write
    position is copied into the row's own page for that slot
    (``own_pages``), and the table entry is pointed there, so the next
    append lands in a page no other row maps.  A row whose entry is already
    its own page copies the page onto itself.  A row whose own slot is the
    sentinel copies into the sink page, which nothing reads; several such
    rows in one call all write the sink.

    The whole payload is gathered before the scatter: a row's own page can
    be another row's source in the same call.
    """
    P, ps, maxP = cache.n_pages, cache.page_size, cache.max_pages
    B = cache.block_tables.shape[0]
    rows = torch.arange(B, device=cache.lengths.device)
    sp = torch.clamp(torch.div(cache.lengths, ps, rounding_mode="floor"),
                     max=maxP - 1).long()                 # next write slot
    src = cache.block_tables[rows, sp].long().clamp(0, P - 1)
    dst = cache.own_pages[rows, sp].long()          # sentinel → the sink
    for store in (cache.k_store, cache.v_store, cache.ks_store,
                  cache.vs_store):
        if store is not None:
            store[:, dst] = store.index_select(1, src)
    tables = cache.block_tables.clone()
    tables[rows, sp] = cache.own_pages[rows, sp]
    return dataclasses.replace(cache, block_tables=tables)


def gather_beams_paged(cache: PagedKVCache,
                       beam_idx: torch.Tensor) -> PagedKVCache:
    """Zero-copy beam reorder: permute block tables, not payload.

    The (B, maxP) block tables and (B,) cursors are gathered by
    ``beam_idx``; then :func:`cow_write_slot` gives each row a private copy
    of its source lineage's current partial page.  Full pages stay shared
    between the beams of a group, read-only; a group's rows are freed
    together, so no refcount is needed on the device.
    """
    idx = beam_idx.long()
    return cow_write_slot(dataclasses.replace(
        cache, block_tables=cache.block_tables.index_select(0, idx),
        lengths=cache.lengths.index_select(0, idx)))


# ---------------------------------------------------------------------------
# prefix-chain pools: page-granular storage for cached cross-attention K/V
# ---------------------------------------------------------------------------
#
# The prefix cache (serving/prefix_cache.py) keeps each cached source's
# encoded cross-attention K/V as a chain of pages in a pool of its own,
# (L, n_pages, page_size, HKV, dh), in the activation dtype: never
# quantized, so a cached read is bit-identical to a fresh encode.  These
# two functions are the only device operations it needs (torch indexing,
# as the reference's ``.at[].set`` and ``jnp.take``).  The page matrices
# come from the host scheduler, so sentinel entries are dropped on the host
# before the upload and the pool needs no sink page.

def insert_chain_pages(pool: torch.Tensor, part: torch.Tensor,
                       pages) -> torch.Tensor:
    """Scatter per-row payload into reserved page chains, in place.

    ``pool``: (L, P, ps, …); ``part``: (L, B, S, …); ``pages``: host
    (B, nP) int32 with ``nP = ceil(S / ps)``.  Sentinel entries (≥ P) drop
    their chunk, so padding rows write nowhere.
    """
    L, B, S = part.shape[0], part.shape[1], part.shape[2]
    P, ps = pool.shape[1], pool.shape[2]
    pages = np.asarray(pages, np.int64).reshape(B, -1)
    nP = pages.shape[1]
    pad = nP * ps - S
    if pad:
        part = torch.cat([part, part.new_zeros(
            (L, B, pad) + tuple(part.shape[3:]))], dim=2)
    chunks = part.reshape((L, B * nP, ps) + tuple(part.shape[3:]))
    keep, ids = in_range_rows(pages.reshape(-1), P)
    dev = pool.device
    pool[:, torch.as_tensor(ids, device=dev)] = chunks[
        :, torch.as_tensor(keep, device=dev)].to(pool.dtype)
    return pool


def gather_chain_pages(pool: torch.Tensor, pages,
                       seq_len: int) -> torch.Tensor:
    """Read page chains back as contiguous rows.

    ``pages``: host (B, nP) int32 → (L, B, seq_len, …).  Sentinel entries
    clamp into the pool and read garbage past each chain's valid span;
    callers mask by source length, as they mask a fresh encode's padding.
    """
    P = pool.shape[1]
    pages = np.clip(np.asarray(pages, np.int64), 0, P - 1)
    B, nP = pages.shape
    got = pool[:, torch.as_tensor(pages, device=pool.device)]
    got = got.reshape((pool.shape[0], B, nP * pool.shape[2])
                      + tuple(pool.shape[3:]))
    return got[:, :, :seq_len]


class PageAllocator:
    """Host-side page pool: free list + refcounts + high-water mark.

    The scheduler reserves ``pages_per_row(budget) × live rows`` pages at
    admission and returns them at release, so admission is gated by real
    device memory instead of contiguous row capacity.  Refcounts support
    shared reservations (``retain``).  Every mutating call validates its
    *entire* argument first and only then mutates, so a bad call (double
    free, retain of a free page) raises without changing any state.
    """

    def __init__(self, n_pages: int, page_size: int, *,
                 overcommit_limit: float = 1.0):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool: n_pages={n_pages}, "
                             f"page_size={page_size}")
        if overcommit_limit < 1.0:
            raise ValueError(
                f"overcommit_limit={overcommit_limit} must be >= 1.0")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.overcommit_limit = float(overcommit_limit)
        self._free = list(range(self.n_pages - 1, -1, -1))   # pop() = page 0
        self._refcount = [0] * self.n_pages
        self.hwm = 0
        self.free_lwm = self.n_pages      # low-water mark of the free list
        self.reserved = 0                 # virtual worst-case reservations
        self.spilled = 0                  # pages' worth of KV held on host

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return pages_per_row(n_tokens, self.page_size)

    def _check(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"page id {p} outside pool "
                                 f"[0, {self.n_pages})")

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages (refcount 1 each) or None if the pool can't.
        The free list is validated before any page leaves it."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        candidates = self._free[len(self._free) - n:]
        for p in candidates:
            if self._refcount[p] != 0:
                raise RuntimeError(
                    f"page {p} double-assigned: on the free list with "
                    f"refcount {self._refcount[p]}")
        del self._free[len(self._free) - n:]
        pages = list(reversed(candidates))               # pop() order
        for p in pages:
            self._refcount[p] = 1
        self.hwm = max(self.hwm, self.in_use)
        self.free_lwm = min(self.free_lwm, len(self._free))
        return pages

    # virtual worst-case reservations, capped at overcommit_limit × n_pages
    @property
    def reserve_cap(self) -> int:
        return int(self.overcommit_limit * self.n_pages)

    def can_reserve(self, n: int) -> bool:
        if n < 0:
            raise ValueError(f"cannot reserve {n} pages")
        return self.reserved + n <= self.reserve_cap

    def reserve(self, n: int) -> bool:
        if not self.can_reserve(n):
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n < 0 or n > self.reserved:
            raise ValueError(f"unreserve({n}) with reserved={self.reserved}")
        self.reserved -= n

    def spill(self, pages: Sequence[int]) -> None:
        """Release ``pages`` whose content moved to the host (atomic, as
        :meth:`release`), counted as spilled."""
        self.release(pages)
        self.spilled += len(pages)

    def unspill(self, n: int) -> None:
        if n < 0 or n > self.spilled:
            raise ValueError(f"unspill({n}) with spilled={self.spilled}")
        self.spilled -= n

    @property
    def fragmentation(self) -> float:
        """Free-list scatter in [0, 1]: 0 when the free pages form one
        contiguous id run, →1 as every free page sits in its own run."""
        if len(self._free) <= 1:
            return 0.0
        ids = sorted(self._free)
        runs = 1 + sum(1 for a, b in zip(ids, ids[1:]) if b != a + 1)
        return (runs - 1) / (len(self._free) - 1)

    def retain(self, pages: Sequence[int]) -> None:
        self._check(pages)
        for p in pages:
            if self._refcount[p] <= 0:
                raise ValueError(f"retain of unallocated page {p}")
        for p in pages:
            self._refcount[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        # validate the FULL list, with multiplicity, before mutating
        self._check(pages)
        drops: dict = {}
        for p in pages:
            drops[p] = drops.get(p, 0) + 1
        for p, n in drops.items():
            if self._refcount[p] < n:
                raise ValueError(
                    f"release of page {p} ×{n} exceeds refcount "
                    f"{self._refcount[p]} (double free)")
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return self._refcount[page]
