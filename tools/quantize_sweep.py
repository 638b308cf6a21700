#!/usr/bin/env python3
"""Time every launch plan of K1 and K2 (the INT8 activation quantizers)
against each other on one GPU.

    python3 tools/quantize_sweep.py [--out FILE]

For every shape that ``chip_smoke.py`` phase 3 gives the quantizers (the
enc-dec and MoE linears' inputs, and the MoE expert inputs), bf16, it
times in one process on one card: an empty kernel (torch's sleep for 0
cycles); K1
(``quantize_static``) under every plan of
``kernels/quantize.py:static_plans`` (16-byte or scalar path, one block
up to two waves of 256-thread blocks); K2 (``quantize_rowwise``) under
every plan of ``rowwise_plans`` (vectors a lane and warps a row, and the
scalar path), each first checked bit for bit against the plain version.
Times are device ms per call behind a sleeping kernel
(``chip_smoke.time_ms``), warm L2, with the plan's choice marked and its
time over inputs rotated past the L2 (``chip_smoke.cold_ms``).  The table
goes to stdout and, with ``--out FILE``, as JSON to that file.  This is the
measurement that sets the thresholds of ``plan`` in
``kernels/quantize.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (time_ms, cold_ms, the phase-3 shapes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("quantize_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import (
        is_aligned, plan, quantize_rowwise_cuda,
        quantize_static_cuda, rowwise_plans, static_plans)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    empty = chip_smoke.time_ms(lambda: torch.cuda._sleep(0))
    print(f"empty kernel {empty:.4f} ms", flush=True)
    rows = []
    for M, K in chip_smoke.quantizer_shapes(*chip_smoke.path_dims()):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        amax = float(x.float().abs().max()) * 0.7
        want_s = ref.ref_quantize_static(x, amax)
        want_q, want_sc = ref.ref_quantize_rowwise(x)
        chosen = plan(M, K, x.dtype, is_aligned(x))
        row = {"shape": [M, K], "bound_ms": M * K * 3 / chip_smoke.
               HBM_BYTES_PER_S * 1e3, "k1": {}, "k2": {},
               "k1_plan": str(chosen.static), "k2_plan": str(chosen.rowwise)}
        for p in dict.fromkeys([chosen.static]
                               + static_plans(M, K, x.dtype, True)):
            if not torch.equal(quantize_static_cuda(x, amax, tile=p), want_s):
                raise AssertionError(f"K1 {p} differs at {(M, K)}")
            row["k1"][str(p)] = chip_smoke.time_ms(
                lambda p=p: quantize_static_cuda(x, amax, tile=p))
        for p in dict.fromkeys([chosen.rowwise]
                               + rowwise_plans(M, K, x.dtype, True)):
            q, sc = quantize_rowwise_cuda(x, tile=p)
            if not (torch.equal(q, want_q) and torch.equal(sc, want_sc)):
                raise AssertionError(f"K2 {p} differs at {(M, K)}")
            row["k2"][str(p)] = chip_smoke.time_ms(
                lambda p=p: quantize_rowwise_cuda(x, tile=p))
        row["k1_cold"] = chip_smoke.cold_ms(
            lambda xi: quantize_static_cuda(xi, amax), x, M * K)
        row["k2_cold"] = chip_smoke.cold_ms(quantize_rowwise_cuda, x,
                                            M * K + 4 * M)
        rows.append(row)
        for k in ("k1", "k2"):
            best = min(row[k], key=row[k].get)
            mine = row[k][row[f"{k}_plan"]]
            print(f"{k.upper()} {M}x{K}: plan {row[f'{k}_plan']} "
                  f"{mine:.4f} ms (cold {row[f'{k}_cold']:.4f}); best "
                  f"{best} {row[k][best]:.4f}; bound {row['bound_ms']:.5f}",
                  flush=True)
            for name, ms in sorted(row[k].items(), key=lambda kv: kv[1]):
                print(f"    {ms:.4f}  {name}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "empty_ms": empty,
                                   "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
