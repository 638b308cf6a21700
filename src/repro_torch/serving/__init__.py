"""Serving (port of ``repro/serving``): static translation, continuous
greedy and beam serving with the adaptive burst, the prefix cache, the
overload machinery (overcommit, preempt-by-page-spill, the chaos harness),
chunked prefill, self-speculative decoding, the schedulers, the
parallel streams, tensor-parallel serving on a mesh
(``ServingEngine(mesh=...)``, ``serving.sharding``) and the replica
router."""

from repro_torch.serving.burst_control import AdaptiveBurst  # noqa: F401
from repro_torch.serving.chaos import ChaosSchedule, make_chaos  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    GenerationResult,
    ServeResult,
    ServingEngine,
)
from repro_torch.serving.preemption import (  # noqa: F401
    SpilledRequest,
    SpillStore,
    pick_victims,
)
from repro_torch.serving.prefix_cache import (  # noqa: F401
    CachedChain,
    PrefixCache,
    PrefixCacheStats,
)
from repro_torch.serving.router import ReplicaRouter, RouterResult  # noqa: F401
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
