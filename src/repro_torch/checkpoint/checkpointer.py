"""Fault-tolerant checkpointing: atomic writes, retention, async save.

Port of ``repro/checkpoint/checkpointer.py``, in the same format: one
``arrays.npz`` with the leaves keyed by their tree path, and a
``meta.json`` beside it, under ``<dir>/step_<8 digits>``.  The keys are the
reference's (``repro_torch.tree.leaves_with_paths``), so each package
restores the other's checkpoints: ``1/.m/dec_blocks.0/ffn/in/w`` is the
first moment of that weight in a ``(params, AdamWState)`` tuple, and a
quantized weight's three arrays are ``.../w/0``, ``/1`` and ``/2``.  A
bfloat16 leaf is written as float32 (numpy has no bfloat16), which restores
to the same bits.

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

from repro_torch.tree import leaves_with_paths, tree_unflatten


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in leaves_with_paths(tree)}


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> str:
        # copy to the host before handing over to the async thread, so the
        # training loop may reuse the device buffers at once
        flat = _flatten_with_paths(tree)
        meta = {"step": int(step),
                "treedef": f"repro_torch tree of {len(flat)} leaves",
                "extra": extra or {}}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)
        return self._step_dir(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """A tree of ``target``'s structure (tensor leaves), each leaf on
        the device and of the dtype of ``target``'s leaf."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self._step_dir(step), "arrays.npz")
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        out = []
        for key, leaf in leaves_with_paths(target):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            out.append(torch.from_numpy(np.array(flat[key])).to(
                device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(target, out)

    def read_meta(self, step: Optional[int] = None) -> Dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)
