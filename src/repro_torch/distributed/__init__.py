"""Distributed plumbing (port of ``repro/distributed``): the step watchdog
and the restart wrapper, the parameter sharding rules (``sharding``), the
collectives of tensor-parallel serving and of FSDP × tensor-parallel
training (``collectives``), the activation-sharding context
(``context``) and INT8 error-feedback gradient compression
(``compression``).  The reference's ``compat.py`` (a JAX API shim) has no
counterpart."""

from repro_torch.distributed.fault import (  # noqa: F401
    StepWatchdog,
    run_with_restarts,
)
