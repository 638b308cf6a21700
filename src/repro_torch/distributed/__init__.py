"""Distributed plumbing (port of ``repro/distributed``): the step watchdog
the serving loop feeds.  The rest (meshes, sharding, compression, restarts)
waits for ROADMAP Queue 1: multi-GPU and the cost accounting."""

from repro_torch.distributed.fault import StepWatchdog  # noqa: F401
