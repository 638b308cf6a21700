"""Checkpointed, watchdogged training loop (fault-tolerant driver).

Port of ``repro/train/loop.py``.  Restores from the latest checkpoint on
entry (so ``run_with_restarts`` can call it again after a failure), saves
every ``save_every`` steps with the data iterator's state, and times every
step for straggler accounting.  On CUDA each step ends with a
``torch.cuda.synchronize`` so the watchdog times the device's work, as the
reference's ``block_until_ready`` does; metrics cross to the host only on
the steps that log them.

On a mesh (a ``make_train_step(grad_shardings=...)`` step, which carries
its ``grad_shardings``) every rank runs the loop with its shards and the
same batches (the step takes each rank's rows), and one ``Checkpointer``
over a directory they share: it writes whole arrays, an unsharded run's
checkpoint, and restores each rank's shard, from a run on any mesh.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.distributed.sharding import TreeSharding
from repro_torch.tree import tree_leaves

log = logging.getLogger("repro_torch.train")


def train_loop(
    *,
    train_step: Callable,
    params: Any,
    opt_state: Any,
    batches,                        # object with next_batch()/state_dict()
    steps: int,
    checkpointer: Optional[Checkpointer] = None,
    save_every: int = 100,
    log_every: int = 10,
    watchdog: Optional[StepWatchdog] = None,
    metrics_cb: Optional[Callable[[int, Dict], None]] = None,
) -> Dict[str, Any]:
    start = 0
    layout = getattr(train_step, "grad_shardings", None)
    # the (params, optimizer state) tree's specs: the moments mirror the
    # parameters, the step counter is whole
    shardings = None if layout is None else TreeSharding(
        layout.mesh, (layout.specs, opt_state._replace(
            step=(), m=layout.specs, v=layout.specs)))
    if checkpointer is not None and checkpointer.latest_step() is not None:
        meta = checkpointer.read_meta()
        start = int(meta["step"])
        params, opt_state = checkpointer.restore((params, opt_state),
                                                 shardings=shardings)
        if "data_state" in meta.get("extra", {}):
            batches.load_state_dict(meta["extra"]["data_state"])
        log.info("restored checkpoint at step %d", start)

    device = tree_leaves(params)[0].device
    watchdog = watchdog or StepWatchdog()
    history = []
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batches.next_batch().items()}
        watchdog.start()
        (params, opt_state), metrics = train_step(params, opt_state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        watchdog.stop()

        if (step + 1) % log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step + 1, **m})
            log.info("step %d: %s", step + 1,
                     {k: round(v, 4) for k, v in m.items()})
            if metrics_cb is not None:
                metrics_cb(step + 1, m)

        if checkpointer is not None and (step + 1) % save_every == 0:
            checkpointer.save(step + 1, (params, opt_state),
                              extra={"data_state": batches.state_dict()},
                              shardings=shardings)

    if checkpointer is not None:
        checkpointer.save(steps, (params, opt_state),
                          extra={"data_state": batches.state_dict()},
                          shardings=shardings)
        checkpointer.wait()
    return {"params": params, "opt_state": opt_state,
            "history": history, "watchdog": watchdog.summary()}
