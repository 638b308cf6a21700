"""Distributed plumbing (port of ``repro/distributed``): the step watchdog
and the restart wrapper, the parameter sharding rules (``sharding``) and
the tensor-parallel collectives (``collectives``).  Gradient compression
and the training context wait for ROADMAP Queue 1: multi-GPU and the cost
accounting.  The reference's ``compat.py`` (a JAX API shim) has no
counterpart."""

from repro_torch.distributed.fault import (  # noqa: F401
    StepWatchdog,
    run_with_restarts,
)
