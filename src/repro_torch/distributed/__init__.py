"""Distributed plumbing (port of ``repro/distributed``): the step watchdog
and the restart wrapper.  The rest (meshes, sharding, compression) waits
for ROADMAP Queue 1: multi-GPU and the cost accounting."""

from repro_torch.distributed.fault import (  # noqa: F401
    StepWatchdog,
    run_with_restarts,
)
