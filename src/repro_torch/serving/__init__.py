"""Serving (port of ``repro/serving``): static translation, continuous
greedy serving, the schedulers and the parallel streams."""

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
