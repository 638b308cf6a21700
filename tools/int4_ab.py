#!/usr/bin/env python3
"""Compare K6 and the INT4-weight path between package trees on one GPU.

    python3 tools/int4_ab.py SRC [SRC ...] [--out FILE]

Each SRC is a directory that holds a ``repro_torch`` package: ``src`` of
this checkout, or of another commit unpacked with ``git archive``.  For
each, in the order given and in a fresh process that builds that tree's
kernels:

* K6 (``int4_matmul``, bf16 out, group 128, f16 scales) at the six INT4
  decode shapes, warm and cold (``chip_smoke.time_ms``/``cold_ms``), each
  first checked bit for bit (f32 out) against that tree's plain version;
  K3 (``int8_matmul``) warm at the same shapes;
* ``transformer-base`` at full width with INT4 decoder weights, as
  ``chip_smoke.py`` phase 6 builds it (random weights from seed 0, KL
  calibration, static activation scales), and one profiled call each of
  greedy and beam-4 ``generate`` and the paged ``serve`` of the 48
  requests, after one unprofiled greedy call: device busy ms and idle
  share from ``torch.profiler``, K6's device ms and kernels, tokens, steps
  and host syncs.

Giving the trees in turns (parent, change, change, parent) runs both on
one card and shows each one's spread.  One JSON object per run goes to
stdout, prefixed ``AB``, then a table; ``--out FILE`` writes them as a
JSON list.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(M, K, N) for M in (16, 64)
          for K, N in ((512, 512), (512, 2048), (2048, 512))]


def one(src: str) -> dict:
    """The measurements of one tree, in this process."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs               # noqa: E402  (puts ROOT/src first)
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            Path(src).resolve()):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy, quantize_block, quantize_model
    from repro_torch.data import make_corpus, pad_batch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.int4_matmul import int4_matmul_cuda
    from repro_torch.kernels.int8_matmul import int8_matmul_cuda
    from repro_torch.models import EncDecLM
    from repro_torch.serving import ServingEngine

    res = {"src": src, "build_s": build.build_seconds(), "kernels": []}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    G = cs.INT4_GROUP
    for M, K, N in SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        bq = quantize_block(torch.randn((K, N), generator=gen, device=dev)
                            * 0.05, G)
        a_s = torch.rand((M, 1), generator=gen, device=dev) * 0.02
        bias = torch.randn((N,), generator=gen, device=dev)
        args = (a, a_s, bq.data, bq.scale, bq.vmin, None, bias)
        if not torch.equal(int4_matmul_cuda(*args, group_size=G),
                           ref.ref_int4_matmul(*args, group_size=G)):
            raise AssertionError(f"K6 differs from its plain version at "
                                 f"{(M, K, N)}")
        run = lambda wi=bq.data: int4_matmul_cuda(
            a, a_s, wi, bq.scale, bq.vmin, None, bias, group_size=G,
            out_dtype=torch.bfloat16)
        w8 = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                           dtype=torch.int8)
        b_s = torch.rand((1, N), generator=gen, device=dev) * 0.02
        res["kernels"].append({
            "shape": [M, K, N], "k6_ms": cs.time_ms(run),
            "k6_cold_ms": cs.cold_ms(run, bq.data, M * K + M * N * 2),
            "k3_ms": cs.time_ms(lambda: int8_matmul_cuda(
                a, a_s, w8, b_s, None, bias, out_dtype=torch.bfloat16))})

    cfg = get_config("transformer-base")
    corpus = make_corpus(cs.N_REQUESTS + cs.N_CALIB, cfg.vocab, seed=11)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cs.warm_up(model, params, corpus)
    recs = cs.calibrate(model, params, corpus)
    qparams, qctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"),
                                   weight_bits=4, weight_group_size=G)
    src_tok, lens = pad_batch([s.src for s in corpus[:cs.N_REQUESTS]])
    batch = {"src_tokens": src_tok, "src_lengths": lens}
    engine = ServingEngine(model, qparams, quant=qctx, max_len=cs.MAX_LEN)
    engine.generate(batch, max_new_tokens=cs.MAX_NEW)
    requests, budgets = cs.serve_requests(cfg.vocab)
    calls = {
        "greedy": lambda: engine.generate(batch, max_new_tokens=cs.MAX_NEW),
        "beam4": lambda: engine.generate_beam(batch, beam=cs.BEAM,
                                              max_new_tokens=cs.MAX_NEW),
        "serve_paged": lambda: ServingEngine(
            model, qparams, quant=qctx, max_len=cs.MAX_LEN,
            burst_len=cs.SERVE_BURST, paged=True,
            page_size=cs.PAGE).serve(requests, n_slots=cs.SERVE_SLOTS,
                                     max_new_tokens=budgets)}
    res["e2e"] = {}
    for name, fn in calls.items():
        out = {}

        def call(fn=fn, out=out):
            out["r"] = fn()
            return getattr(out["r"], "steps", None) or getattr(
                out["r"], "decode_steps", None)
        busy, rows, wall = cs.profile(f"int4 {name}", call)
        r = out["r"]
        res["e2e"][name] = {
            "busy_ms": busy, "wall_ms": wall, "idle_share": 1 - busy / wall,
            "k6_ms": sum(ms for ms, key, _ in rows if "int4_matmul" in key),
            "k6_kernels": sum(n for _, key, n in rows if "int4_matmul" in key),
            "tokens": r.n_tokens,
            "steps": getattr(r, "steps", None) or r.decode_steps,
            "host_syncs": r.host_syncs}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    if args.one:
        print("AB " + json.dumps(one(args.src[0])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("int4_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for src in args.src:
        proc = subprocess.run([sys.executable, __file__, "--one", src],
                              capture_output=True, text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{src}: exit {proc.returncode}")
        runs.append(json.loads(lines[-1][3:]))
        print(lines[-1], flush=True)
    for i, r in enumerate(runs):
        print(f"run {i} {r['src']} build {r['build_s']:.1f} s")
        for k in r["kernels"]:
            print(f"  K6 {str(tuple(k['shape'])):18s} {k['k6_ms']:.4f} ms "
                  f"cold {k['k6_cold_ms']:.4f}  K3 {k['k3_ms']:.4f}")
        for name, e in r["e2e"].items():
            print(f"  {name:12s} busy {e['busy_ms']:.2f} of {e['wall_ms']:.1f}"
                  f" ms, idle {e['idle_share']:.3f}, K6 {e['k6_ms']:.2f} ms "
                  f"in {e['k6_kernels']} kernels, tokens {e['tokens']}, "
                  f"steps {e['steps']}, host syncs {e['host_syncs']}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
