"""Spec trees of a training step's arguments on a mesh.

Port of ``train_arg_specs`` of ``repro/launch/specs.py``.  Training
parallelism is FSDP over the batch axes (``pod``, ``data``) × tensor
parallelism over ``"model"``:

* the parameters by :func:`distributed.sharding.param_specs` with
  ``fsdp=fsdp_axes(mesh)`` and the config's kv heads;
* AdamW's ``m`` and ``v`` mirror them; its step counter is replicated;
* the batch splits its rows over the batch axes
  (:func:`distributed.sharding.batch_specs`).

The reference returns abstract arrays with shardings attached; the port
returns the spec trees, which ``distributed.sharding.shard_params`` and
``shard_opt_state`` cut a rank's shard by and ``TreeSharding(mesh,
specs)`` hands to ``train.step.make_train_step`` as ``grad_shardings``.
The rest of the reference's module (the serving, prefill and decode
specs of the dry run) waits with ``launch/dryrun.py`` (ROADMAP Queue 1:
multi-GPU and the cost accounting).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.distributed.sharding import batch_specs, param_specs
from repro_torch.launch.mesh import batch_axes, fsdp_axes
from repro_torch.optim.adamw import AdamWState


def train_arg_specs(cfg, params: Any, batch: Dict[str, Any], mesh
                    ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """``(param specs, AdamWState of specs, batch specs)`` for
    ``make_train_step`` on ``mesh``.  ``params`` is the whole tree (any
    tensors of the right shapes) and ``batch`` the global batch."""
    p = param_specs(params, mesh, tensor="model", fsdp=fsdp_axes(mesh),
                    kv_heads=cfg.n_kv_heads)
    return (p, AdamWState(step=(), m=p, v=p),
            batch_specs(batch, mesh, batch_axes(mesh)))
