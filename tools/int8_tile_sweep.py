#!/usr/bin/env python3
"""Time the s8 tensor-core tiles' configurations against each other on one
GPU: the INT8 GEMM tile (K3, K7) and the INT4-weight tile (K6).

    python3 tools/int8_tile_sweep.py [--cold] [--only k3|k7|k6] [--out FILE]

For every shape the port's main paths give K3 (``int8_matmul``, the
enc-dec and MoE linears) and K7 (``int8_matmul_batched``, the MoE experts),
it times, in one process on one card: the configuration that
``kernels/int8_matmul.py:plan`` picks, the small tile unsplit and at every
split it may take, the large tile, and ``torch._int_mm`` (M padded to 17
where it wants more than 16 rows; 32 calls for K7).  For K6
(``int4_matmul``, the INT4 decoder linears at decode, and shapes that reach
each row count and split) it times the plan's choice, the tile unsplit and
every group-ordered split into slices of 1, 2, 3, 4 or 8 groups; no PyTorch
call computes K6's function.  Every timed configuration is first checked
bit for bit against the plain version.  Times are device ms per call
behind a sleeping kernel (``chip_smoke.time_ms``), with warm L2; ``--cold``
also times the plan's configuration over rotating weight copies (more than
100 MB between two uses of one copy).  The table goes to stdout and, with
``--out FILE``, as JSON to that file.  This is the measurement that sets
the thresholds of ``plan`` in ``kernels/int8_matmul.py`` and
``kernels/int4_matmul.py``.
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

import chip_smoke  # noqa: E402  (time_ms, cold_ms, the shapes' constants)

# (E, M, K, N): the enc-dec path (transformer-base, 16 requests, sources
# padded to 46, beam 4) and the MoE path (granite-moe-1b-a400m)
K3_SHAPES = ([(1, M, K, N) for M in (16, 64, 736)
              for K, N in ((512, 512), (512, 2048), (2048, 512))]
             + [(1, M, 1024, N) for M in (16, 64, 736, 2944)
                for N in (1024, 512)]
             + [(1, M, K, 512) for M in (1, 17, 65) for K in (1024, 2048)])
K7_SHAPES = [(32, M, K, N) for M in (5, 20, 230, 960)
             for K, N in ((1024, 512), (512, 1024))]
# (M, K, N, G): the INT4 path's decode shapes (16 rows greedy, 64 beam-4),
# then shapes that reach each row count (16, 32, 64, tiled) and split, and
# the group sizes of the tests
K6_SHAPES = ([(M, K, N, 128) for M in (16, 64)
              for K, N in ((512, 512), (512, 2048), (2048, 512))]
             + [(M, K, 512, 128) for M in (1, 17, 65) for K in (1024, 2048)]
             + [(M, 512, 512, 32) for M in (16, 64)]
             + [(300, 2048, 512, 128), (16, 4096, 512, 128)])


def candidates(E, M, N, K):
    from repro_torch.kernels.int8_matmul import Plan, plan
    bm = min(64, 16 * -(-M // 16))
    out = {"plan": plan(E, M, N, K),
           "small": Plan("small", bm, 64, 128, 1, K),
           "large": Plan("large", 128, 128, 64, 1, K)}
    for per in (2, 4, 8):
        if K // (per * 128) >= 2:
            out[f"small/S{K // (per * 128)}"] = Plan(
                "small", bm, 64, 128, K // (per * 128), per * 128)
    return out


def k6_candidates(M, N, K, G):
    from repro_torch.kernels.int4_matmul import Plan, plan
    bm = plan(M, N, K, G).bm
    n_g = -(-K // G)
    out = {"plan": plan(M, N, K, G), "unsplit": Plan(bm, 1, n_g)}
    for per in (1, 2, 3, 4, 8):
        if n_g > per:
            out[f"S{-(-n_g // per)}"] = Plan(bm, -(-n_g // per), per)
    return out


def sweep_k6(args, dev, gen):
    import torch
    from repro_torch.core import quantize_block
    from repro_torch.kernels import ref
    from repro_torch.kernels.int4_matmul import int4_matmul_cuda
    rows = []
    for M, K, N, G in K6_SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        bq = quantize_block(torch.randn((K, N), generator=gen, device=dev)
                            * 0.05, G)
        a_s = torch.rand((M, 1), generator=gen, device=dev) * 0.02
        bias = torch.randn((N,), generator=gen, device=dev)

        def call(tile, w=bq.data):
            return int4_matmul_cuda(a, a_s, w, bq.scale, bq.vmin, None, bias,
                                    group_size=G, out_dtype=torch.bfloat16,
                                    tile=tile)
        want = ref.ref_int4_matmul(a, a_s, bq.data, bq.scale, bq.vmin, None,
                                   bias, group_size=G,
                                   out_dtype=torch.bfloat16)
        row = {"shape": [M, K, N, G], "ms": {}}
        cands = k6_candidates(M, N, K, G)
        for name, tile in cands.items():
            if not torch.equal(call(tile), want):
                raise AssertionError(f"K6 {name} {tile} differs at "
                                     f"{(M, K, N, G)}")
            row["ms"][name] = chip_smoke.time_ms(lambda: call(tile))
        row["plan"] = str(cands["plan"])
        if args.cold:
            row["cold_ms"] = chip_smoke.cold_ms(
                lambda wi: call(None, wi), bq.data, a.numel() + M * N * 2)
        rows.append(row)
        print(f"K6 {str((M, K, N, G)):22s} "
              + " ".join(f"{k}={v:.4f}" for k, v in row["ms"].items())
              + (f" cold={row['cold_ms']:.4f}" if args.cold else ""),
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--only", choices=("k3", "k7", "k6"), default=None)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("int8_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import (int8_matmul_batched_cuda,
                                                 int8_matmul_cuda)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    gemm = {None: K3_SHAPES + K7_SHAPES, "k3": K3_SHAPES, "k7": K7_SHAPES,
            "k6": []}[args.only]
    for E, M, K, N in gemm:
        a = torch.randint(-127, 128, (E, M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (E, K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        a_s = torch.rand((E, M, 1), generator=gen, device=dev) * 0.02
        b_s = torch.rand((E, 1, N), generator=gen, device=dev) * 0.02
        bias = torch.randn((N,), generator=gen, device=dev)
        if E == 1:
            def call(tile, w0=w[0]):
                return int8_matmul_cuda(a[0], a_s[0], w0, b_s[0], None, bias,
                                        out_dtype=torch.bfloat16, tile=tile)
            want = ref.ref_int8_matmul(a[0], a_s[0], w[0], b_s[0], None, bias,
                                       out_dtype=torch.bfloat16)
            a_lib = torch.nn.functional.pad(a[0], (0, 0, 0, max(0, 17 - M)))
            lib = lambda: torch._int_mm(a_lib, w[0])
            lib_iters = 50
        else:
            def call(tile, w0=w):
                return int8_matmul_batched_cuda(a, a_s, w0, b_s,
                                                out_dtype=torch.bfloat16,
                                                tile=tile)
            want = ref.ref_int8_matmul_batched(a, a_s, w, b_s,
                                               out_dtype=torch.bfloat16)
            a_lib = torch.nn.functional.pad(a, (0, 0, 0, max(0, 17 - M)))
            lib = lambda: [torch._int_mm(a_lib[e], w[e]) for e in range(E)]
            lib_iters = 10
        row = {"shape": [E, M, K, N], "ms": {}}
        for name, tile in candidates(E, M, N, K).items():
            if not torch.equal(call(tile), want):
                raise AssertionError(f"{name} {tile} differs at "
                                     f"{(E, M, K, N)}")
            row["ms"][name] = chip_smoke.time_ms(lambda: call(tile))
        row["plan"] = str(candidates(E, M, N, K)["plan"])
        row["library_ms"] = chip_smoke.time_ms(lib, iters=lib_iters)
        if args.cold:
            row["cold_ms"] = chip_smoke.cold_ms(
                lambda wi: call(None, wi), w[0] if E == 1 else w,
                a.numel() + E * M * N * 2)
        rows.append(row)
        print(f"{str((E, M, K, N)):24s} "
              + " ".join(f"{k}={v:.4f}" for k, v in row["ms"].items())
              + f" lib={row['library_ms']:.4f}"
              + (f" cold={row['cold_ms']:.4f}" if args.cold else ""),
              flush=True)
    if args.only in (None, "k6"):
        rows += sweep_k6(args, dev, gen)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
