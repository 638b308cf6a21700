"""Serving-side batch composition (paper §5.4 + §5.6 front half).

Port of ``repro/serving/scheduler.py`` (host-side numpy; no torch):

* ``TokenSortedScheduler`` — the paper's static composer: orders requests by
  **token** count (descending), composes fixed-size batches padded to
  bucketed lengths, and hands them to the parallel streams
  (``streams.py``) through a thread-safe ``BatchQueue``.

* ``ContinuousScheduler`` — the request lifecycle behind
  ``ServingEngine.serve``: requests flow *waiting → running → finished*
  through a fixed pool of decode **slots**, one row per request (greedy)
  or one group of ``group_size`` rows (beam search).  Admission is FIFO
  (EDF with aging once a request carries a deadline or a priority) with an
  optional per-round prefill token budget and, on the paged cache, a page
  budget against a ``PageAllocator``; a group freed by a finished request
  is refilled mid-decode.  With a ``PrefixCache`` attached, admissions are
  routed hit / insert / skip; under overcommit a request reserves its
  worst case virtually and is allocated only its next burst's pages, and a
  running request can be preempted back to the queue (its KV spilled to
  the host by the engine).  With ``prefill_chunk``, a source longer than
  the chunk is staged: the engine spreads its encode over rounds, one
  encoder layer a round.  Per-request arrival / first-token / finish
  times feed the latency metrics.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.sorting import make_batches, next_pow2, padding_stats
from repro_torch.data.synthetic import Sentence, pad_batch


@dataclasses.dataclass
class WorkItem:
    batch_id: int
    indices: List[int]                 # request ids in this batch
    batch: Dict[str, np.ndarray]
    n_real_tokens: int
    n_padded_tokens: int


class TokenSortedScheduler:
    """Requests → ordered, padded batches (+ padding accounting)."""

    def __init__(self, batch_size: int, *, sort_mode: str = "tokens",
                 pad_to_multiple: int = 8):
        self.batch_size = batch_size
        self.sort_mode = sort_mode
        self.pad_to_multiple = pad_to_multiple

    def _round(self, n: int) -> int:
        m = self.pad_to_multiple
        return ((n + m - 1) // m) * m

    def plan(self, requests: Sequence[Sentence]) -> List[WorkItem]:
        batches = make_batches(requests, self.batch_size, self.sort_mode)
        items = []
        for bid, idx in enumerate(batches):
            sents = [requests[i] for i in idx]
            L = self._round(max(s.n_tokens for s in sents))
            src, lens = pad_batch([s.src for s in sents], length=L)
            items.append(WorkItem(
                batch_id=bid,
                indices=list(idx),
                batch={"src_tokens": src, "src_lengths": lens},
                n_real_tokens=int(lens.sum()),
                n_padded_tokens=int(L * len(sents)),
            ))
        return items

    def stats(self, requests: Sequence[Sentence]) -> dict:
        batches = make_batches(requests, self.batch_size, self.sort_mode)
        return padding_stats(requests, batches)


@dataclasses.dataclass
class Request:
    """One serving request and its measured lifecycle."""

    req_id: int
    src: np.ndarray                     # (S,) int32 source tokens
    max_new_tokens: int = 64
    arrival_s: float = 0.0
    # SLO knobs: absolute deadline on the serve clock (None = best-effort)
    # and a priority boost, both feeding the EDF-with-aging queue order
    deadline_s: Optional[float] = None
    priority: float = 0.0

    # lifecycle (scheduler/engine-maintained)
    status: str = "waiting"             # waiting | running | finished | rejected
    slot: Optional[int] = None          # base row of the request's group
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # decode-step attribution: wall-clock latencies are observed at burst
    # edges, the step counters carry the exact position
    admitted_step: Optional[int] = None
    finish_step: Optional[int] = None
    # beam serving: the winning hypothesis' length-penalized log-prob
    score: Optional[float] = None
    # mixed-width beam serving: this request's own beam width (None = the
    # serve call's default).  Caller-owned: the engine never writes it.
    beam: Optional[int] = None
    # paged KV cache: flat page ids reserved for this request
    pages: Optional[List[int]] = None
    # prefix cache (scheduler-managed): how this admission was routed
    # ("hit" | "insert" | "skip" | None when the cache is off) and the
    # chain whose reference the request holds until release
    prefix_role: Optional[str] = None
    prefix_chain: Optional[object] = None
    # overload machinery: why a shed request was rejected, how many times
    # it was preempted, its host spill payload while preempted
    # (``preemption.SpilledRequest``), the admission rounds it has waited
    # (aging) and its worst-case page reservation
    reject_reason: Optional[str] = None
    preemptions: int = 0
    spill: Optional[object] = None
    wait_rounds: int = 0
    reserved_pages: int = 0

    @property
    def n_src_tokens(self) -> int:
        return int(len(self.src))

    @property
    def first_token_latency_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def total_latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s


def pad_rows_pow2(src: np.ndarray, lens: np.ndarray
                  ) -> "tuple[np.ndarray, np.ndarray, int]":
    """Pad an admission batch to the next power-of-two row count.

    Padding rows replay row 0; their results are discarded downstream (their
    destinations are out of range).  The one padding contract shared by the
    fused (``ContinuousScheduler.plan_admission``) and unfused
    (``ServingEngine._prefill_padded``) admission paths, so both run the
    same shapes.  Returns ``(src, lens, width)``.
    """
    n = src.shape[0]
    width = next_pow2(n)
    if width > n:
        src = np.concatenate(
            [src, np.broadcast_to(src[0], (width - n,) + src.shape[1:])],
            axis=0)
        lens = np.concatenate(
            [lens, np.broadcast_to(lens[0], (width - n,))])
    return src, lens, width


def _empty_i32() -> np.ndarray:
    return np.zeros((0,), np.int32)


def _empty_i32_2d() -> np.ndarray:
    return np.zeros((0, 0), np.int32)


@dataclasses.dataclass
class AdmissionPlan:
    """One admission round, shaped for the fused decode burst.

    Sources are right-padded to ``enc_len`` columns and the batch to a
    power-of-two ``width`` (padding rows replay row 0; their ``base_rows``
    entry is the out-of-range ``oob_row``, so every scatter drops them).
    Zero-budget requests never reach the device: they are finished at
    admission and reported in ``released``.  The array fields default to
    fresh empty arrays (``default_factory``): an ndarray class default is
    what stops the reference's module from importing on Python 3.12.

    With a prefix cache, ``requests`` holds only the rows to *encode* (the
    misses); hits skip the encoder and arrive in the ``hit_*`` fields,
    padded to a power of two under the same row-0-replay contract, and
    the misses routed "insert" carry their chain reservations in
    ``ins_pages``.  ``resumed`` requests carry a host spill payload
    (preempted earlier): the engine restores their KV instead of encoding.
    ``staged`` requests have sources longer than the scheduler's
    ``prefill_chunk``: the engine encodes them over later rounds, one
    encoder layer a round.  Neither kind takes an encode row here.
    """

    requests: List[Request]            # encode rows: budget > 0, slot order
    released: List[Request]            # zero-budget: finished at admission
    src_tokens: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    src_lengths: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    base_rows: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    width: int = 0                     # pow2 batch width (0 = no device work)
    hits: List[Request] = dataclasses.field(default_factory=list)
    hit_rows: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    hit_lengths: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    hit_pages: np.ndarray = dataclasses.field(        # (hit_width, maxPP)
        default_factory=_empty_i32_2d)
    hit_width: int = 0                 # pow2 (0 = no hits)
    ins_pages: np.ndarray = dataclasses.field(        # (width, maxPP)
        default_factory=_empty_i32_2d)
    resumed: List[Request] = dataclasses.field(default_factory=list)
    staged: List[Request] = dataclasses.field(default_factory=list)

    @property
    def n_admitted(self) -> int:
        return (len(self.requests) + len(self.hits) + len(self.released)
                + len(self.resumed) + len(self.staged))

    @property
    def prefix_hit_pages(self) -> int:
        """Chain pages whose encode and store this round's hits skipped."""
        return sum(r.prefix_chain.n_pages for r in self.hits)


class ContinuousScheduler:
    """Admission control + slot lifecycle for continuous batching.

    ``n_slots`` decode rows exist for the whole serve; a request occupies
    one group of ``group_size`` contiguous rows from admission to finish
    (``group_size=1``, greedy serving, makes a group one row).
    ``Request.slot`` and the ``slot_map`` keys are group base rows, always
    multiples of ``group_size``; rows past ``n_groups × group_size`` are
    never assigned.  ``admit`` hands out free groups to waiting requests in
    queue order, bounded per round by ``prefill_token_budget`` and by the
    page pool; the head of the queue is always admitted when a group and
    its pages are free, so no request starves.  The budget counts prefilled
    row-tokens: a request charges ``group_size × n_src_tokens``, whether
    the engine encodes its source once (fused) or once a row (unfused), so
    admission, and with it the token stream, is the same either way.

    Paged cache: ``allocator`` and ``pages_per_request`` go together; a
    request's full-budget worst case is reserved and, by default,
    physically allocated at admission, so decode never runs out of pages.
    With ``initial_pages`` (overcommit) the worst case is a *virtual*
    reservation, capped at the allocator's ``overcommit_limit × n_pages``,
    and only ``initial_pages(req)`` pages are allocated; the engine grows
    rows between bursts and preempts when growth or admission comes up
    short.

    ``prefix_cache``: routes each admission "hit" / "insert" / "skip"
    (:meth:`assign_prefix`).  Chain pages come from the cache's own
    allocator, so a full prefix pool degrades to uncached admission and
    never eats into the decode page budget.

    ``prefill_chunk``: a source of more tokens than this is routed to
    :attr:`AdmissionPlan.staged` instead of the round's encode rows.
    """

    _NO_DEADLINE = 1e6                 # best-effort = very late deadline

    def __init__(self, n_slots: int, *, group_size: int = 1,
                 prefill_token_budget: Optional[int] = None,
                 allocator=None,
                 pages_per_request: Optional[Callable[[Request], int]] = None,
                 prefix_cache=None,
                 initial_pages: Optional[Callable[[Request], int]] = None,
                 prefill_chunk: Optional[int] = None,
                 starvation_aging: float = 0.5):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        if group_size < 1:
            raise ValueError(f"group_size must be ≥ 1, got {group_size}")
        if n_slots < group_size:
            raise ValueError(f"{n_slots} rows cannot hold a group of "
                             f"{group_size}")
        if (allocator is None) != (pages_per_request is None):
            raise ValueError("allocator and pages_per_request go together")
        if starvation_aging < 0:
            raise ValueError(f"starvation_aging must be >= 0, "
                             f"got {starvation_aging}")
        self.n_slots = n_slots
        self.group_size = group_size
        self.n_groups = n_slots // group_size
        self.prefill_token_budget = prefill_token_budget
        self.allocator = allocator
        self.pages_per_request = pages_per_request
        self.prefix_cache = prefix_cache
        self.initial_pages = initial_pages
        self.prefill_chunk = prefill_chunk
        self.starvation_aging = float(starvation_aging)
        self._waiting: Deque[Request] = collections.deque()
        self._free: List[int] = [g * group_size
                                 for g in range(self.n_groups)]
        self.slot_map: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.rejected: List[Request] = []

    # ------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        # reset the whole lifecycle so a Request object can be re-served
        req.status = "waiting"
        req.slot = None
        req.admitted_s = None
        req.first_token_s = None
        req.finish_s = None
        req.tokens = []
        req.admitted_step = None
        req.finish_step = None
        req.score = None
        req.pages = None
        req.prefix_role = None
        req.prefix_chain = None
        req.reject_reason = None
        req.preemptions = 0
        req.spill = None
        req.wait_rounds = 0
        req.reserved_pages = 0
        self._waiting.append(req)

    def submit_many(self, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(r)

    def urgency_key(self, req: Request) -> float:
        """Scalar wait-queue key, smaller = more urgent: earliest deadline
        first, nudged by ``priority`` and by starvation aging (every round
        spent waiting makes a request ``starvation_aging`` virtual seconds
        more urgent)."""
        d = req.deadline_s if req.deadline_s is not None else self._NO_DEADLINE
        return d - req.priority - self.starvation_aging * req.wait_rounds

    def victim_key(self, req: Request) -> float:
        """Preemption key: deadline and priority only.  Aging moves a
        waiting request up the queue; it must not let it evict an equally
        urgent running one."""
        d = req.deadline_s if req.deadline_s is not None else self._NO_DEADLINE
        return d - req.priority

    def _sort_waiting(self) -> None:
        """EDF-with-aging order, preempted (spilled) requests first among
        equals.  Skipped when nothing in the queue carries a deadline, a
        priority, aging credit or a spill: the default stays strict
        submission-order FIFO."""
        if len(self._waiting) < 2:
            return
        if not any(r.deadline_s is not None or r.priority or r.spill
                   is not None or r.wait_rounds for r in self._waiting):
            return
        self._waiting = collections.deque(sorted(
            self._waiting,
            key=lambda r: (self.urgency_key(r),
                           0 if r.spill is not None else 1)))

    def _shed(self, now: float) -> List[Request]:
        """Reject waiting requests whose deadline has already passed (no
        admission order can meet it).  Preempted requests are exempt: their
        spill is freed only by their resume."""
        shed: List[Request] = []
        keep: Deque[Request] = collections.deque()
        for req in self._waiting:
            if (req.deadline_s is not None and now > req.deadline_s
                    and req.spill is None):
                req.status = "rejected"
                req.reject_reason = (
                    f"deadline {req.deadline_s:.3f}s already passed at "
                    f"admission (now={now:.3f}s)")
                req.finish_s = now
                self.rejected.append(req)
                shed.append(req)
            else:
                keep.append(req)
        self._waiting = keep
        return shed

    def admit(self, now: float = 0.0, *,
              step: Optional[int] = None) -> List[Request]:
        """Move waiting requests into free slot groups (one prefill round).

        ``step`` records the global decode-step count at this burst edge.
        Order: shed provably-late requests, sort by urgency (a no-op for
        deadline-free traffic), then admit while slots, the prefill budget
        and the page pool allow.  Under overcommit a request reserves its
        worst case virtually and is allocated ``initial_pages`` pages.
        """
        self._shed(now)
        self._sort_waiting()
        admitted: List[Request] = []
        budget = self.prefill_token_budget
        used = 0
        while self._waiting and self._free:
            req = self._waiting[0]
            cost = req.n_src_tokens * self.group_size   # row-tokens
            if admitted and budget is not None and used + cost > budget:
                break                    # next round; queue order preserved
            pages = None
            worst = 0
            if self.allocator is not None:
                worst = self.pages_per_request(req)
                if not self.allocator.can_reserve(worst):
                    break
                n_pages = worst
                if self.initial_pages is not None:
                    n_pages = min(self.initial_pages(req), worst)
                pages = self.allocator.alloc(n_pages)
                if pages is None:
                    break                # pool short: the head waits
                self.allocator.reserve(worst)
            self._waiting.popleft()
            slot = self._free.pop(0)
            req.status = "running"
            req.slot = slot
            req.pages = pages
            req.reserved_pages = worst
            req.admitted_s = now
            req.admitted_step = step
            self.slot_map[slot] = req
            used += cost
            admitted.append(req)
        for req in self._waiting:
            req.wait_rounds += 1         # starvation aging
        return admitted

    def admission_shortfall(self) -> Optional[Dict[str, object]]:
        """Why the most urgent waiting request cannot be admitted now, in
        pages, or None when nothing page-related blocks it.

        ``pages_short``: physical pages missing for its initial allocation;
        ``reserve_short``: virtual reservation room missing under the
        overcommit cap; ``head_key``: its :meth:`victim_key`.  Preempting
        running victims fixes both.
        """
        if not self._waiting or not self._free or self.allocator is None:
            return None
        self._sort_waiting()
        req = self._waiting[0]
        worst = self.pages_per_request(req)
        n_pages = worst
        if self.initial_pages is not None:
            n_pages = min(self.initial_pages(req), worst)
        reserve_short = max(
            0, self.allocator.reserved + worst - self.allocator.reserve_cap)
        pages_short = max(0, n_pages - self.allocator.n_free)
        if not reserve_short and not pages_short:
            return None
        return {"reserve_short": reserve_short, "pages_short": pages_short,
                "head_key": self.victim_key(req)}

    def preempt(self, req: Request, now: float = 0.0) -> int:
        """Evict a running request back to the front of the wait queue and
        return its freed group base row.

        The engine has already copied the victim's KV to the host
        (``req.spill``), so its pages go back through the allocator's spill
        accounting (a staged victim, whose encode never finished, has
        nothing to spill: its pages are released).  Its prefix chain reference is dropped: a resume
        re-splices cross K/V from the spill, not from the pool.  It keeps
        its emitted tokens, and spilled requests win ties in the queue.
        """
        if req.status != "running" or req.slot is None:
            raise ValueError(f"request {req.req_id} is not running "
                             f"(status={req.status})")
        slot = req.slot
        req.status = "waiting"
        req.slot = None
        req.preemptions += 1
        if req.pages is not None:
            if req.spill is not None:
                self.allocator.spill(req.pages)
            else:
                self.allocator.release(req.pages)
            req.pages = None
        if req.reserved_pages:
            self.allocator.unreserve(req.reserved_pages)
            req.reserved_pages = 0
        if req.prefix_chain is not None:
            self.prefix_cache.finish(req.prefix_chain)
            req.prefix_chain = None
            req.prefix_role = None
        del self.slot_map[slot]
        self._free.append(slot)
        self._free.sort()
        self._waiting.appendleft(req)
        return slot

    def assign_prefix(self, reqs: Sequence[Request]
                      ) -> "tuple[List[Request], List[Request]]":
        """Route live admissions through the prefix cache; returns
        ``(misses, hits)``.  Misses (roles "insert" and "skip") are
        encoded; hits splice their cached chain.  Routing is sequential: a
        source admitted twice in one round makes the first occurrence the
        "insert" and the second a "hit" on the chain reserved moments
        earlier (the engine scatters the pool before it gathers the hits).
        """
        if self.prefix_cache is None:
            return list(reqs), []
        misses: List[Request] = []
        hits: List[Request] = []
        for req in reqs:
            role, chain = self.prefix_cache.admit(req.src)
            req.prefix_role = role
            req.prefix_chain = chain
            (hits if role == "hit" else misses).append(req)
        return misses, hits

    def chain_pages_matrix(self, reqs: Sequence[Request], width: int,
                           enc_len: int, stride: int = 1) -> np.ndarray:
        """(width, maxPP) chain page ids, sentinel-padded.

        ``maxPP`` is the chain length of a full ``enc_len`` source in the
        prefix allocator's pages; rows without a chain (role "skip",
        padding) are all sentinel, so their scatters drop and their
        gathers clamp.  Request ``i``'s chain lands on row ``i × stride``
        (the unfused beam side batch tiles each source ``beam×``, and only
        a group's first row feeds the pool).
        """
        al = self.prefix_cache.allocator
        maxPP = (enc_len + al.page_size - 1) // al.page_size
        out = np.full((width, max(maxPP, 1)), al.n_pages, np.int32)
        for i, req in enumerate(reqs):
            if req.prefix_chain is not None:
                out[i * stride, :req.prefix_chain.n_pages] = \
                    req.prefix_chain.pages
        return out

    def shape_hits(self, hits: Sequence[Request], *, enc_len: int,
                   oob_row: int
                   ) -> "tuple[np.ndarray, np.ndarray, np.ndarray, int]":
        """Shape prefix hits for a device splice: pow2-padded
        ``(hit_rows, hit_lengths, hit_pages, hit_width)`` under the
        :func:`pad_rows_pow2` contract (row-0 replays, ``oob_row``
        destinations)."""
        hlens = np.asarray([r.n_src_tokens for r in hits], np.int32)
        hrows = np.asarray([r.slot for r in hits], np.int32)
        hw = next_pow2(len(hits))
        pad = hw - len(hits)
        hit_lengths = np.concatenate(
            [hlens, np.broadcast_to(hlens[:1], (pad,))])
        hit_rows = np.concatenate(
            [hrows, np.full((pad,), oob_row, np.int32)])
        hit_pages = self.chain_pages_matrix(hits, hw, enc_len)
        hit_pages[len(hits):] = hit_pages[0]         # padding replays row 0
        return hit_rows, hit_lengths, hit_pages, hw

    def plan_admission(self, now: float = 0.0, *, step: Optional[int] = None,
                       enc_len: int, oob_row: int) -> AdmissionPlan:
        """Admit one round and shape it for the fused burst: runs
        :meth:`admit`, finishes zero-budget requests on the spot, sets
        preempted requests aside as ``resumed`` (their KV comes back from
        the host) and sources longer than ``prefill_chunk`` as ``staged``
        (they bypass the prefix cache both ways: a hit has no encode to
        stage, and a chain insert would need the monolithic encode), routes
        the rest through the prefix cache and pads the
        rows to encode (sources to ``enc_len``, rows to a power of two with
        row-0 replays, destinations with ``oob_row``).  Zero-budget
        requests are excluded before the routing: they never encode, so an
        "insert" for one would cache garbage."""
        live: List[Request] = []
        released: List[Request] = []
        resumed: List[Request] = []
        staged: List[Request] = []
        for req in self.admit(now, step=step):
            if req.max_new_tokens <= 0:
                req.first_token_s = now          # observed: empty output
                self.release(req, now, step=step)
                released.append(req)
            elif req.spill is not None:
                resumed.append(req)
            elif (self.prefill_chunk is not None
                  and req.n_src_tokens > self.prefill_chunk):
                staged.append(req)
            else:
                live.append(req)
        misses, hits = self.assign_prefix(live)
        if misses:
            src, lens = pad_batch([r.src for r in misses], length=enc_len)
            src, lens, width = pad_rows_pow2(src, lens)
            base = np.full((width,), oob_row, np.int32)
            base[:len(misses)] = [r.slot for r in misses]
        else:
            width = 0
            src = np.zeros((0, enc_len), np.int32)
            lens = base = np.zeros((0,), np.int32)
        plan = AdmissionPlan(requests=misses, released=released,
                             src_tokens=np.ascontiguousarray(src),
                             src_lengths=np.ascontiguousarray(lens),
                             base_rows=base, width=width, resumed=resumed,
                             staged=staged)
        if self.prefix_cache is not None:
            plan.ins_pages = self.chain_pages_matrix(misses, width, enc_len)
            if hits:
                (plan.hit_rows, plan.hit_lengths, plan.hit_pages,
                 plan.hit_width) = self.shape_hits(hits, enc_len=enc_len,
                                                   oob_row=oob_row)
                plan.hits = hits
        return plan

    def release(self, req: Request, now: float = 0.0, *,
                step: Optional[int] = None) -> int:
        """Finish a running request and return its freed group base row
        (the whole group is freed); its pages go back to the pool and its
        prefix chain reference is dropped.
        ``step``: the exact global decode step the request finished at."""
        if req.status != "running" or req.slot is None:
            raise ValueError(f"request {req.req_id} is not running "
                             f"(status={req.status})")
        slot = req.slot
        req.status = "finished"
        req.finish_s = now
        req.finish_step = step
        req.slot = None
        if req.pages is not None:
            self.allocator.release(req.pages)
            req.pages = None
        if req.reserved_pages:
            self.allocator.unreserve(req.reserved_pages)
            req.reserved_pages = 0
        if req.prefix_chain is not None:
            self.prefix_cache.finish(req.prefix_chain)
            req.prefix_chain = None
        del self.slot_map[slot]
        self._free.append(slot)
        self._free.sort()
        self.finished.append(req)
        return slot

    # ------------------------------------------------------------ inspection
    @property
    def n_free(self) -> int:
        """Free slot groups (free rows when ``group_size == 1``)."""
        return len(self._free)

    @property
    def n_running(self) -> int:
        return len(self.slot_map)

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def all_done(self) -> bool:
        return not self._waiting and not self.slot_map


class BatchQueue:
    """Thread-safe queue feeding the worker streams (paper Fig. 6)."""

    def __init__(self, items: Optional[Sequence[WorkItem]] = None):
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.enqueued = 0
        if items:
            for item in items:
                self.put(item)

    def put(self, item: WorkItem) -> None:
        with self._lock:
            self.enqueued += 1
        self._q.put(item)

    def close(self, n_consumers: int) -> None:
        for _ in range(n_consumers):
            self._q.put(None)

    def get(self) -> Optional[WorkItem]:
        return self._q.get()
