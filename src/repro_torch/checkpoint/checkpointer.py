"""Fault-tolerant checkpointing: atomic writes, retention, async save, and
mesh-independent restore (elastic rescaling).

Port of ``repro/checkpoint/checkpointer.py``, in the same format: one
``arrays.npz`` with the leaves keyed by their tree path, and a
``meta.json`` beside it, under ``<dir>/step_<8 digits>``.  The keys are the
reference's (``repro_torch.tree.leaves_with_paths``), so each package
restores the other's checkpoints: ``1/.m/dec_blocks.0/ffn/in/w`` is the
first moment of that weight in a ``(params, AdamWState)`` tuple, and a
quantized weight's three arrays are ``.../w/0``, ``/1`` and ``/2``.  A
bfloat16 leaf is written as float32 (numpy has no bfloat16), which restores
to the same bits.

Checkpoints store *whole* (unsharded) arrays, as the reference's do, so a
restart may use another mesh.  On a mesh every rank calls ``save`` with
its shard and the tree's ``distributed.sharding.TreeSharding``: each leaf
is made whole (collective, a leaf at a time on the device) and the mesh's
first rank writes it; the keys, shapes and dtypes are an unsharded run's.
``restore(..., shardings=...)`` reads the whole arrays and keeps this
rank's shard under the current mesh's specs.  The directory is one that
every rank sees.

Atomicity: write to ``<dir>/tmp.<step>``, fsync, ``os.replace`` into place,
so a killed job never leaves a half-written checkpoint as the latest.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import cut, owns, spec_leaves, uncut
from repro_torch.tree import leaves_with_paths, tree_unflatten


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in leaves_with_paths(tree)}


def _writes(mesh) -> bool:
    """The mesh's first rank (coordinate 0 on every axis) writes."""
    return owns((), mesh, mesh.coords)


def _gather_flat(tree, shardings) -> Optional[Dict[str, np.ndarray]]:
    """Every leaf of this rank's shard ``tree`` made whole (``uncut``, one
    leaf at a time: collective) and, on the writing rank, copied to the
    host; None on the others."""
    mesh = shardings.mesh
    writer = _writes(mesh)
    flat = {}
    for (key, leaf), spec in zip(leaves_with_paths(tree),
                                 spec_leaves(tree, shardings.specs)):
        whole = uncut(leaf, spec, mesh, mesh.coords)
        if writer:
            flat[key] = _to_numpy(whole)
        del whole
    return flat if writer else None


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._mesh_write = False        # a mesh save every rank waits for
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None,
             shardings: Any = None) -> str:
        """Write ``tree`` as checkpoint ``step``.  ``shardings``: the
        ``TreeSharding`` of ``tree`` when it is this rank's shard on a
        mesh; every rank of the mesh calls ``save``, and returns once the
        write is in place (with ``async_save``, once :meth:`wait` has
        returned on every rank)."""
        # copy to the host before handing over to the async thread, so the
        # training loop may reuse the device buffers at once
        flat = (_flatten_with_paths(tree) if shardings is None
                else _gather_flat(tree, shardings))
        self.wait()
        if flat is not None:
            meta = {"step": int(step),
                    "treedef": f"repro_torch tree of {len(flat)} leaves",
                    "extra": extra or {}}
            if self.async_save:
                self._thread = threading.Thread(
                    target=self._write, args=(step, flat, meta),
                    daemon=True)
                self._thread.start()
            else:
                self._write(step, flat, meta)
        self._mesh_write = shardings is not None
        if not self.async_save:
            self.wait()
        return self._step_dir(step)

    def wait(self) -> None:
        """Until the last save is in place (on a mesh: on every rank, so
        every rank of it calls this)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh_write:
            self._mesh_write = False
            if dist.is_initialized():
                dist.barrier()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               meta: Dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """A tree of ``target``'s structure (tensor leaves), each leaf on
        the device and of the dtype of ``target``'s leaf.

        ``shardings``: the ``TreeSharding`` of ``target`` when it is this
        rank's shard on a mesh (any mesh: the checkpoint holds whole
        arrays); each leaf is read whole and this rank's block of it kept
        (elastic restore).  The host holds one whole leaf at a time."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self._step_dir(step), "arrays.npz")
        pairs = leaves_with_paths(target)
        specs = ([None] * len(pairs) if shardings is None
                 else spec_leaves(target, shardings.specs))
        out = []
        with np.load(path) as data:
            stored = set(data.files)
            for (key, leaf), spec in zip(pairs, specs):
                if key not in stored:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = torch.from_numpy(data[key])
                if spec is not None:
                    mesh = shardings.mesh
                    block = cut(arr, spec, mesh, mesh.coords)
                    # a block that views the whole array would keep it
                    arr = block.clone() if block.numel() < arr.numel() \
                        else block
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint leaf {key}: "
                                     f"{tuple(arr.shape)} does not fit "
                                     f"{tuple(leaf.shape)}")
                out.append(arr.to(device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(target, out)

    def read_meta(self, step: Optional[int] = None) -> Dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)
