"""Parallel inference streams (paper §5.6).

The paper: a parent session owns a batch queue; child processes dequeue
batches asynchronously, so long- and short-sentence batches overlap and
utilization rises.  Here a *stream* is a thread over its own engine
replica; the queue/worker mechanism is the reference's
(``repro/serving/streams.py``; its queueing simulators are not ported yet).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Sequence

from repro_torch.serving.scheduler import BatchQueue, WorkItem


@dataclasses.dataclass
class StreamRecord:
    stream_id: int
    batch_id: int
    start_s: float
    end_s: float
    n_tokens: int


class ParallelStreams:
    """N worker streams draining one batch queue."""

    def __init__(self, run_batch: Callable[[int, WorkItem], int],
                 n_streams: int):
        """``run_batch(stream_id, item) -> n_generated_tokens``."""
        self.run_batch = run_batch
        self.n_streams = n_streams
        self.records: List[StreamRecord] = []
        self._lock = threading.Lock()
        self._errors: List[Exception] = []

    def _worker(self, sid: int, q: BatchQueue, t0: float) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            s = time.perf_counter() - t0
            try:
                n = self.run_batch(sid, item)
            except Exception as e:         # re-raised by run(), not lost
                with self._lock:
                    self._errors.append(e)
                continue
            e = time.perf_counter() - t0
            with self._lock:
                self.records.append(StreamRecord(sid, item.batch_id, s, e, n))

    def run(self, items: Sequence[WorkItem]) -> Dict:
        q = BatchQueue(items)
        q.close(self.n_streams)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._worker, args=(i, q, t0))
                   for i in range(self.n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._errors:
            raise self._errors[0]
        makespan = max((r.end_s for r in self.records), default=0.0)
        busy = sum(r.end_s - r.start_s for r in self.records)
        return {
            "makespan_s": makespan,
            "throughput_tok_s": sum(r.n_tokens for r in self.records)
            / max(makespan, 1e-9),
            "utilization": busy / max(makespan * self.n_streams, 1e-9),
            "records": self.records,
        }
