#!/usr/bin/env python3
"""Phase 5g of ``chip_smoke.py`` alone on one GPU: training on a mesh of
two gloo ranks on ``cuda:0``, with the card and the host to themselves.

    python3 tools/train_mesh_alone.py

It builds the kernels, spawns two ranks that run
``chip_smoke.train_tp_runs`` (mistral-nemo-12b at 2 layers on ``(1, 2)``
with remat and on ``(2, 1)`` with remat off and on; transformer-base's parity steps on
``(2, 1)`` and ``(1, 2)``, its checkpointed loop on ``(2, 1)`` restored
onto ``(1, 2)`` and unsharded, the compressor on the ranks' gradients,
granite-moe-1b-a400m at 2 layers on both meshes, and the bf16 steps
timed) and checks their results with ``chip_smoke.check_train_tp``,
which prints the "5g ..." lines.  In ``chip_smoke.py`` these runs share
the card with phase 7d and with the drivers, so their ms a step read
slower there; this is the measurement of the sharded steps beside
nothing.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (train_tp_runs, check_train_tp)


def rank_main(rank: int, world: int, rdzv: str, paths: dict) -> None:
    """One rank: join the gloo group on ``cuda:0`` (TF32 off), run phase
    5g, save its results; a traceback goes to ``paths["errs"][rank]``."""
    import traceback
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            chip_smoke.save_atomic(chip_smoke.train_tp_runs(rank, paths),
                                   paths["outs_5g"][rank])
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(paths["errs"][rank], "w") as f:
            f.write(traceback.format_exc())
        raise


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("train_mesh_alone: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    chip_smoke.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    chip_smoke.log(f"build: {build.build_seconds():.2f} s")
    tmp = tempfile.mkdtemp(prefix="train_mesh_")
    n = chip_smoke.TP
    paths = dict(outs_5g=[f"{tmp}/rank{r}-5g.pt" for r in range(n)],
                 ckpt_5g=f"{tmp}/ckpt-5g",
                 card_5g=f"{tmp}/card-5g",
                 errs=[f"{tmp}/rank{r}.err" for r in range(n)])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, daemon=True,
                         args=(r, n, f"file://{tmp}/rdzv", paths))
             for r in range(n)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    chip_smoke.check_train_tp(dict(paths, tmp=tmp, procs=procs))
    chip_smoke.log(f"5g alone: {time.perf_counter() - t:.1f} s from the "
                   "spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
