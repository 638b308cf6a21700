"""Preempt-by-page-spill: the host-side spill store and victim selection.

Port of ``repro/serving/preemption.py`` (host only; no torch).  Under
overcommit the scheduler admits more concurrent rows than the page pool
could back in the worst case; what keeps that from deadlocking is this
module.  Any running request can be *preempted*: its KV pages (INT8
payload and scales verbatim), cross-attention K/V, cursors and current
tokens are copied to the host, its pages go back to the pool, and it
re-enters the wait queue.  On re-admission the engine restores the payload
through the paged splice admission uses (``kv_cache.insert_rows_paged``),
and decoding continues bit-identically to an uninterrupted serve.

The device gather and scatter are the engine's ``_spill`` and ``_resume``.
A bfloat16 payload (no numpy dtype) is held as its ``uint16`` bit pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SpilledRequest:
    """One preempted request's whole decode state, on the host.

    Arrays keep the *logical* (linearized) row view, ``(L, W, cap, …)``
    with ``cap = max_pages × page_size``, so a restore is the unfused
    admission splice: a contiguous side batch scattered into freshly
    allocated pages.
    """

    req_id: int
    n_rows: int                        # 1 (greedy) or the group width
    # self-attention KV, linearized rows (junk past each cursor is masked
    # on the device like any partially filled row)
    k: np.ndarray                      # (L, W, cap, HKV, dh)
    v: np.ndarray
    k_scale: Optional[np.ndarray]      # (L, W, cap, HKV) when quantized
    v_scale: Optional[np.ndarray]
    lengths: np.ndarray                # (W,) decode cursors
    tokens_row: np.ndarray             # (W,) last token fed to each row
    # cross-attention KV and source lengths, whatever the splice installed
    # (a fresh encode, a prefix-cache chain, or an earlier restore)
    cross_k: np.ndarray                # (L, W, S_enc, HKV, dh)
    cross_v: np.ndarray
    src_lengths: np.ndarray            # (W,)
    # allocator accounting: pages' worth of KV this spill represents
    n_pages: int
    # beam serving: the host-side search state (None for greedy): scores,
    # finished, history and budget_left of the group's rows
    beam: Optional[dict] = None

    @property
    def n_bytes(self) -> int:
        total = 0
        for a in (self.k, self.v, self.k_scale, self.v_scale,
                  self.cross_k, self.cross_v, self.lengths,
                  self.tokens_row, self.src_lengths):
            if a is not None:
                total += a.nbytes
        return int(total)


class SpillStore:
    """Host spill store: req_id → :class:`SpilledRequest`, with the counters
    ``ServeResult`` reports.  A serve ends with the store empty (every
    spill restored)."""

    def __init__(self) -> None:
        self._store: Dict[int, SpilledRequest] = {}
        self.spill_events = 0
        self.restore_events = 0
        self.spilled_bytes = 0         # cumulative

    def put(self, spill: SpilledRequest) -> None:
        if spill.req_id in self._store:
            raise ValueError(f"request {spill.req_id} is already spilled")
        self._store[spill.req_id] = spill
        self.spill_events += 1
        self.spilled_bytes += spill.n_bytes

    def pop(self, req_id: int) -> SpilledRequest:
        if req_id not in self._store:
            raise ValueError(f"request {req_id} has no spill to restore")
        self.restore_events += 1
        return self._store.pop(req_id)

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, req_id: int) -> bool:
        return req_id in self._store


def pick_victims(candidates: Sequence, *, pages_needed: int,
                 key_fn, pages_held_fn,
                 exclude: Iterable = (),
                 min_key: Optional[float] = None) -> Tuple[List, bool]:
    """Choose running requests to preempt until ``pages_needed`` pages
    would come free.

    Least urgent first (largest ``key_fn``: latest deadline, lowest
    priority), ties toward the youngest admission so older work keeps its
    progress.  ``exclude`` protects requests that must survive this round.
    ``min_key``: only requests *strictly less urgent* than this key may be
    evicted, so two equally urgent requests cannot evict each other in
    turn.

    Returns ``(victims, covered)``: ``covered`` says whether evicting the
    victims frees at least ``pages_needed`` pages.  Mandatory growth fails
    loudly on an uncovered need; admission-driven preemption evicts nothing
    unless the head request fits afterwards.
    """
    if pages_needed <= 0:
        return [], True
    excluded = {id(r) for r in exclude}
    pool = [r for r in candidates if id(r) not in excluded]
    if min_key is not None:
        pool = [r for r in pool if key_fn(r) > min_key]
    pool.sort(key=lambda r: (-key_fn(r),
                             -(r.admitted_step if r.admitted_step
                               is not None else 0)))
    victims: List = []
    freed = 0
    for r in pool:
        if freed >= pages_needed:
            break
        victims.append(r)
        freed += pages_held_fn(r)
    return victims, freed >= pages_needed
