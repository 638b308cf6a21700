"""Serving (port of ``repro/serving``): static translation, continuous
greedy and beam serving with the adaptive burst, the schedulers and the
parallel streams.  Not ported yet: the prefix cache, the overload machinery
(preemption, chunked prefill, chaos), speculation and the replica router
(ROADMAP Queue 1)."""

from repro_torch.serving.burst_control import AdaptiveBurst  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    GenerationResult,
    ServeResult,
    ServingEngine,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    AdmissionPlan,
    BatchQueue,
    ContinuousScheduler,
    Request,
    TokenSortedScheduler,
    WorkItem,
    pad_rows_pow2,
)
from repro_torch.serving.streams import ParallelStreams, StreamRecord  # noqa: F401
