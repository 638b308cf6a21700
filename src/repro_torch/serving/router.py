"""Data-parallel replica router: fan requests across N serving engines.

Port of ``repro/serving/router.py``.  Tensor parallelism
(``ServingEngine(mesh=...)``) buys per-step latency; this buys throughput:
N independent engine replicas — each its own weights, page pool and
scheduler — behind a host-side router that assigns every request to the
replica with the shallowest queue, breaking ties by the most *estimated
free pages* (a shadow ``kv_cache.PageAllocator`` per replica mirrors what
that replica's serve pool will reserve, by the engine's worst-case
``pages_per_row(max_new_tokens)`` accounting).  Queue depth leads the
score, so counts never drift more than one apart; the page estimate picks
which near-even replica takes a long request.

Replicas serve concurrently (one host thread each, ``parallel=True``); each
replica's serve is untouched and its output equals running that share
alone.  Engines may share one card: the kernel launch table
(``kernels.build.LAUNCHES``) is counted under a lock.  The merged
:class:`RouterResult` restores submission order and exposes the
``ServeResult`` surface the benches read.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.models import kv_cache as kvc
from repro_torch.serving.engine import ServeResult, ServingEngine
from repro_torch.serving.scheduler import Request

__all__ = ["ReplicaRouter", "RouterResult"]


@dataclasses.dataclass
class RouterResult:
    """Merged outcome of one routed serve across all replicas."""

    results: List[ServeResult]        # one per replica, replica order
    assignment: List[int]             # replica index per request, submission order
    requests: List[Request]           # submission order, lifecycle filled in
    wall_s: float

    @property
    def replicas(self) -> int:
        return len(self.results)

    @property
    def n_tokens(self) -> int:
        return int(sum(len(r.tokens) for r in self.requests))

    @property
    def tokens_per_s(self) -> float:
        return self.n_tokens / max(self.wall_s, 1e-9)

    @property
    def peak_running_per_replica(self) -> List[int]:
        return [r.peak_running for r in self.results]

    @property
    def host_syncs(self) -> int:
        return int(sum(r.host_syncs for r in self.results))

    def tokens_for(self, req_id: int) -> np.ndarray:
        for r in self.requests:
            if r.req_id == req_id:
                return np.asarray(r.tokens, np.int32)
        raise KeyError(req_id)

    def metrics(self) -> Dict[str, float]:
        out = {"replicas": float(self.replicas),
               "n_requests": float(len(self.requests)),
               "n_tokens": float(self.n_tokens),
               "wall_s": self.wall_s,
               "tokens_per_s": self.tokens_per_s,
               "host_syncs": float(self.host_syncs)}
        for i, r in enumerate(self.results):
            out[f"replica{i}_peak_running"] = float(r.peak_running)
            out[f"replica{i}_n_tokens"] = float(
                sum(len(q.tokens) for q in r.requests))
        return out


class ReplicaRouter:
    def __init__(self, engines: Sequence[ServingEngine]):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)

    # ------------------------------------------------------------- routing
    def route(self, reqs: Sequence[Request], *, n_slots: int = 8
              ) -> List[int]:
        """Replica index per request: shallowest queue, then free pages.

        The shadow allocators are sized like each replica's serve pool and
        charged the worst-case reservation the engine's admission would
        hold for the request: free-page *estimates*, not live pool state
        (the pools do not exist until the serves run), which is what a
        front-end router has to work from.  Unpaged replicas balance on
        queue depth alone.
        """
        shadows = [kvc.PageAllocator(eng.n_pages
                                     or n_slots * eng._max_pages,
                                     eng.page_size)
                   if eng.paged else None for eng in self.engines]
        depth = [0] * len(self.engines)
        out = []
        for req in reqs:
            def score(i):
                free = shadows[i].n_free if shadows[i] is not None else 0
                return (depth[i], -free, i)
            best = min(range(len(self.engines)), key=score)
            out.append(best)
            depth[best] += 1
            if shadows[best] is not None:
                eng = self.engines[best]
                need = kvc.pages_per_row(
                    min(req.max_new_tokens, eng.max_len), eng.page_size)
                shadows[best].alloc(min(need, shadows[best].n_free))
        return out

    # ------------------------------------------------------------- serving
    def serve(self, requests: Sequence[Any], *, n_slots: int = 8,
              max_new_tokens=64, parallel: bool = True,
              chaos: Optional[Any] = None, **kw) -> RouterResult:
        """Route ``requests`` and serve every share, merging the results.

        ``kw`` goes to every replica's ``ServingEngine.serve``; ``chaos``
        is a per-replica sequence of schedules, or one schedule for all.
        Requests keep their submission-order ``req_id``, so ``tokens_for``
        works on the merged result.  A replica's exception is raised after
        every thread has ended.
        """
        reqs = self.engines[0]._as_requests(requests, max_new_tokens)
        assignment = self.route(reqs, n_slots=n_slots)
        # the shares' Requests carry their own budgets; each replica's
        # serve only sees a scalar default
        mx_default = (int(np.max(max_new_tokens))
                      if isinstance(max_new_tokens, (list, tuple, np.ndarray))
                      else int(max_new_tokens))
        shares: List[List[Request]] = [[] for _ in self.engines]
        for req, idx in zip(reqs, assignment):
            shares[idx].append(req)

        per_chaos: List[Any] = [None] * len(self.engines)
        if chaos is not None:
            if isinstance(chaos, (list, tuple)):
                if len(chaos) != len(self.engines):
                    raise ValueError(
                        f"per-replica chaos needs {len(self.engines)} "
                        f"schedules, got {len(chaos)}")
                per_chaos = list(chaos)
            else:
                per_chaos = [chaos] * len(self.engines)

        t0 = time.perf_counter()
        results: List[Optional[ServeResult]] = [None] * len(self.engines)
        errors: List[Optional[BaseException]] = [None] * len(self.engines)

        def run(i: int) -> None:
            skw = dict(kw)
            if per_chaos[i] is not None:
                skw["chaos"] = per_chaos[i]
            try:
                results[i] = self.engines[i].serve(
                    shares[i], n_slots=n_slots, max_new_tokens=mx_default,
                    **skw)
            except BaseException as e:       # raised after the join
                errors[i] = e

        if parallel and len(self.engines) > 1:
            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(len(self.engines))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for i in range(len(self.engines)):
                run(i)
        for e in errors:
            if e is not None:
                raise e

        done = [r for r in results if r is not None]
        for r in done:
            r.replicas = len(self.engines)
        return RouterResult(results=done, assignment=assignment,
                            requests=reqs, wall_s=time.perf_counter() - t0)
