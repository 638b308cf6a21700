#!/usr/bin/env python3
"""Sweep K4 and K5 (the INT8 flash-decode attention of
``csrc/decode_attention.cu``) over their plans and chunk lengths on one GPU.

    python3 tools/decode_attention_sweep.py [--cold] [--chunks 16,32]
                                            [--out FILE]

For each chunk length (a build constant: the library is built once more
with ``-DREPRO_DA_CHUNK=<c>`` for each length other than ``CHUNK``) and
each shape of ``chip_smoke.py`` phase 3 (K4 at the enc-dec and MoE decode
shapes, K5 at the serve shapes, and a long cache of 4096 positions for
each), every plan (split 1, 2, 4 or 8 up to the chunks; 2, 4 or 8 warps) is
checked against the plain version (f32 within 1e-5) and against the other
plans of the same chunk (bit for bit), then timed warm (``chip_smoke.time_ms``) and, with ``--cold``, with the caches
rotated past the L2 (``chip_smoke.cold_ms``).  It prints one line per run,
the fastest plan of each shape beside the one ``kernels/decode_attention.
py:plan`` picks, and writes the runs as JSON with ``--out``.  This sweep set
``CHUNK`` and the thresholds of ``plan``.
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

DH = 64
# (kernel, B, capacity or (pages, page size), HKV, G): the phase-3 shapes
K4_SHAPES = [(16, 64, 8, 1), (64, 64, 8, 1), (16, 80, 8, 2), (64, 80, 8, 2),
             (16, 4096, 8, 2)]
K5_SHAPES = [(16, (4, 16), 8, 1), (64, (4, 16), 8, 1), (16, (4, 16), 4, 2),
             (16, (256, 16), 8, 2)]


def library(chunk: int):
    """The kernel library built with ``chunk`` positions a chunk."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import CHUNK
    if chunk == CHUNK:
        return build.lib()
    return build.load(build.build((f"-DREPRO_DA_CHUNK={chunk}",)))


def k4_inputs(gen, B, S, HKV, G):
    import torch
    dev = torch.device("cuda")
    kq = torch.randint(-127, 128, (B, S, HKV, DH), generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, HKV, DH), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((B, S, HKV), generator=gen, device=dev) * 0.02
    vs = torch.rand((B, S, HKV), generator=gen, device=dev) * 0.02
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    q = torch.randn((B, HKV * G, DH), generator=gen, device=dev)
    return q, (kq, ks, vq, vs), lengths


def k5_inputs(gen, B, maxP, ps, HKV, G):
    """A pool of B·maxP pages handed out shuffled; lengths in [1, maxP·ps],
    each row reserving the pages its length reaches."""
    import torch
    dev = torch.device("cuda")
    P = B * maxP
    cpu = torch.Generator().manual_seed(B + maxP)
    perm = torch.randperm(P, generator=cpu).int()
    lengths = torch.randint(1, maxP * ps + 1, (B,), generator=cpu)
    tables = torch.full((B, maxP), P, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = perm[b * maxP:b * maxP + n]
    kq = torch.randint(-127, 128, (P, ps, HKV, DH), generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (P, ps, HKV, DH), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((P, ps, HKV), generator=gen, device=dev) * 0.02
    vs = torch.rand((P, ps, HKV), generator=gen, device=dev) * 0.02
    q = torch.randn((B, HKV * G, DH), generator=gen, device=dev)
    return (q, (kq, ks, vq, vs), tables.to(dev),
            lengths.to(torch.int32).to(dev))


def launcher(lib, q, cache, lengths, plan, tables=None):
    """fn(cache) -> out: one launch of ``lib``'s K4 (K5 with ``tables``)
    with ``plan``, on the current stream, as the wrappers launch it."""
    import torch
    from repro_torch.kernels.build import check
    from repro_torch.kernels.decode_attention import Q_DTYPES
    B, H, dh = q.shape
    dt = Q_DTYPES[q.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def fn(c=cache):
        kq, ks, vq, vs = c
        out = torch.empty_like(q)
        if tables is None:
            _, S, HKV, _ = kq.shape
            err = lib.repro_decode_attention(
                q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                vs.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, S, HKV,
                H // HKV, dh, 0.125, dt, plan.split, plan.warps,
                q.device.index, stream)
        else:
            P, ps, HKV, _ = kq.shape
            err = lib.repro_decode_attention_paged(
                q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                vs.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, P, ps, tables.shape[1], HKV, H // HKV, dh,
                0.125, dt, plan.split, plan.warps, q.device.index, stream)
        check(err, "decode_attention sweep")
        return out
    return fn


def sweep(chunks, cold: bool):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import all_plans, plan
    runs = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = ([("K4", B, S, None, HKV, G) for B, S, HKV, G in K4_SHAPES]
              + [("K5", B, maxP * ps, (maxP, ps), HKV, G)
                 for B, (maxP, ps), HKV, G in K5_SHAPES])
    for kernel, B, S, paged, HKV, G in shapes:
        if paged:
            q, cache, tables, lengths = k5_inputs(gen, B, *paged, HKV, G)
            want = ref.ref_decode_attention_paged(q, *cache, tables, lengths,
                                                  0.125)
        else:
            q, cache, lengths = k4_inputs(gen, B, S, HKV, G)
            tables = None
            want = ref.ref_decode_attention(q, cache[0], cache[1], cache[2],
                                            cache[3], lengths, 0.125)
        qb = q.to(torch.bfloat16)
        shape = [B, S, HKV * G, HKV, DH]
        for chunk in chunks:
            lib = library(chunk)
            chosen = plan(B, S, HKV, G, DH, chunk=chunk)
            plans = all_plans(S, chunk)
            first = None
            for p in plans:
                got = launcher(lib, q, cache, lengths, p, tables)()
                if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
                    raise AssertionError(f"{kernel} {shape} chunk {chunk} "
                                         f"{p}: differs from the plain "
                                         f"version")
                if first is None:
                    first = got
                elif not torch.equal(got, first):
                    raise AssertionError(f"{kernel} {shape} chunk {chunk} "
                                         f"{p}: bits differ between plans")
                run = launcher(lib, qb, cache, lengths, p, tables)
                r = {"kernel": kernel, "shape": shape, "chunk": chunk,
                     "plan": [p.split, p.warps],
                     "planned": p == chosen, "ms": cs.time_ms(run)}
                if cold:
                    r["cold_ms"] = cs.cold_ms(run, cache)
                runs.append(r)
                print(f"{kernel} {str(shape):28s} chunk {chunk:2d} "
                      f"split {p.split} warps {p.warps} "
                      f"{r['ms']:.4f} ms"
                      + (f" cold {r['cold_ms']:.4f}" if cold else "")
                      + ("  <- plan" if r["planned"] else ""), flush=True)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cold", action="store_true",
                    help="also time with the caches rotated past the L2")
    ap.add_argument("--chunks", default="16,32",
                    help="chunk lengths to build and sweep")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = sweep([int(c) for c in args.chunks.split(",")], args.cold)
    best = {}
    for r in runs:
        k = (r["kernel"], tuple(r["shape"]))
        if k not in best or r["ms"] < best[k]["ms"]:
            best[k] = r
    print("fastest plan of each shape, and the plan's choice at CHUNK:")
    from repro_torch.kernels.decode_attention import CHUNK
    for (kernel, shape), r in best.items():
        mine = next(x for x in runs if x["kernel"] == kernel
                    and tuple(x["shape"]) == shape and x["planned"]
                    and x["chunk"] == CHUNK)
        print(f"  {kernel} {str(list(shape)):28s} best chunk {r['chunk']} "
              f"plan {r['plan']} {r['ms']:.4f} ms; plan {mine['plan']} "
              f"{mine['ms']:.4f} ms")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
