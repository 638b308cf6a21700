#!/usr/bin/env python3
"""Compare K4 and K5 (the INT8 flash-decode attention) and the paths that
launch them between package trees on one GPU.

    python3 tools/attention_ab.py SRC [SRC ...] [--out FILE]

Each SRC is a directory that holds a ``repro_torch`` package: ``src`` of
this checkout, or of another commit unpacked with ``git archive``.  For
each, in the order given and in a fresh process that builds that tree's
kernels:

* K4 (``decode_attention``) at the shapes of ``chip_smoke.py`` phase 3
  (16 and 64 rows over the enc-dec cache of 64 with 8 heads, and over the
  MoE cache of 80 with 16 heads over 8) and a long cache of 4096
  positions; K5 (``decode_attention_paged``) at the serve shapes (16 and 64
  rows of 4 pages of 16, 8 kv heads; 16 rows with 4 kv heads) and 16 rows
  of 256 pages; bf16, warm and cold (``chip_smoke.time_ms``/``cold_ms``),
  each first checked against that tree's plain version (f32, 1e-5);
* ``granite-moe-1b-a400m`` at full width (random weights from seed 0, INT8
  with dynamic activation scales, as ``chip_smoke.py`` phase 7 builds it):
  one profiled greedy ``generate`` after an unprofiled one;
* ``transformer-base`` at full width (INT8, KL-calibrated static scales, as
  phase 4 builds it): one profiled paged ``serve`` of the first 24 of
  phase 5's requests (as phase 5 profiles it);
  for both, device busy ms and idle share from ``torch.profiler``, K4's and
  K5's device ms and launches, tokens, steps and host syncs.

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
LONG_S = 4096
K4_SHAPES = [(16, 64, 8, 8), (64, 64, 8, 8), (16, 80, 16, 8), (64, 80, 16, 8),
             (16, LONG_S, 16, 8)]
K5_SHAPES = [(16, 4, 8, 8), (64, 4, 8, 8), (16, 4, 8, 4),
             (16, LONG_S // 16, 16, 8)]    # (B, pages a row, H, HKV)


def kernel_times(cs, dev, gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_paged_cuda)
    dh, sm = 64, 0.125
    rows = []
    for B, S, H, HKV in K4_SHAPES:
        kq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, S, HKV), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, S, HKV), generator=gen, device=dev) * 0.02
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
        q = torch.randn((B, H, dh), generator=gen, device=dev)
        if not torch.allclose(
                decode_attention_cuda(q, kq, ks, vq, vs, lengths, sm_scale=sm),
                ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, sm),
                atol=1e-5, rtol=1e-5):
            raise AssertionError(f"K4 differs from its plain version at "
                                 f"{(B, S, H, HKV)}")
        q = q.to(torch.bfloat16)
        run = lambda c=(kq, ks, vq, vs): decode_attention_cuda(
            q, *c, lengths, sm_scale=sm)
        rows.append({"kernel": "K4", "shape": [B, S, H, HKV, dh],
                     "ms": cs.time_ms(run),
                     "cold_ms": cs.cold_ms(run, (kq, ks, vq, vs))})
    for B, maxP, H, HKV in K5_SHAPES:
        ps, P = 16, B * maxP
        cpu = torch.Generator().manual_seed(B + maxP + HKV)
        perm = torch.randperm(P, generator=cpu).int()
        lengths = torch.randint(1, maxP * ps + 1, (B,), generator=cpu)
        tables = torch.full((B, maxP), P, dtype=torch.int32)
        for b in range(B):
            n = -(-int(lengths[b]) // ps)
            tables[b, :n] = perm[b * maxP:b * maxP + n]
        tables, lengths = tables.to(dev), lengths.to(torch.int32).to(dev)
        kq = torch.randint(-127, 128, (P, ps, HKV, dh), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (P, ps, HKV, dh), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((P, ps, HKV), generator=gen, device=dev) * 0.02
        vs = torch.rand((P, ps, HKV), generator=gen, device=dev) * 0.02
        q = torch.randn((B, H, dh), generator=gen, device=dev)
        if not torch.allclose(
                decode_attention_paged_cuda(q, kq, ks, vq, vs, tables,
                                            lengths, sm_scale=sm),
                ref.ref_decode_attention_paged(q, kq, ks, vq, vs, tables,
                                               lengths, sm),
                atol=1e-5, rtol=1e-5):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"{(B, maxP, H, HKV)}")
        q = q.to(torch.bfloat16)
        run = lambda c=(kq, ks, vq, vs): decode_attention_paged_cuda(
            q, *c, tables, lengths, sm_scale=sm)
        rows.append({"kernel": "K5", "shape": [B, P, ps, H, HKV, dh],
                     "ms": cs.time_ms(run),
                     "cold_ms": cs.cold_ms(run, (kq, ks, vq, vs))})
    return rows


ATTENTION_KERNELS = (("k4", "decode_attention_kernel"),
                     ("k5", "decode_attention_paged_kernel"))


def profiled(cs, label, fn, kernels=ATTENTION_KERNELS):
    """One profiled call of ``fn`` (which returns a generation or serve
    result): busy and idle, the device time and launches of each of
    ``kernels`` (name, a substring of its kernels' names), the counters."""
    out = {}

    def call():
        out["r"] = fn()
        return getattr(out["r"], "steps", None) or out["r"].decode_steps
    busy, rows, wall = cs.profile(label, call)
    r = out["r"]
    res = {"busy_ms": busy, "wall_ms": wall, "idle_share": 1 - busy / wall,
           "tokens": r.n_tokens,
           "steps": getattr(r, "steps", None) or r.decode_steps,
           "host_syncs": r.host_syncs}
    for name, key in kernels:
        res[f"{name}_ms"] = sum(ms for ms, k, _ in rows if key in k)
        res[f"{name}_launches"] = sum(n for _, k, n in rows if key in k)
    return res


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
    from repro_torch.core import QuantPolicy, quantize_model
    from repro_torch.data import make_corpus
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"src": src, "build_s": build.build_seconds()}
    dev = torch.device("cuda")
    res["kernels"] = kernel_times(cs, dev,
                                  torch.Generator(device=dev).manual_seed(1))

    # the MoE model's greedy generate (K4 with 16 heads over 8, capacity 80)
    moe_cfg = get_config(cs.MOE_ARCH)
    moe_model = DecoderLM(moe_cfg, device="cuda")
    moe_params = moe_model.init(torch.Generator(device="cuda").manual_seed(0))
    batch, _ = cs.moe_prompts(moe_cfg.vocab)
    dparams, dctx = quantize_model(moe_params, {},
                                   QuantPolicy(act_quant="dynamic"),
                                   device="cuda")
    del moe_params
    engine = ServingEngine(moe_model, dparams, quant=dctx,
                           max_len=cs.MOE_MAX_LEN)
    engine.generate(batch, max_new_tokens=cs.MAX_NEW)
    res["moe_greedy"] = profiled(cs, "moe_greedy_dynamic",
                                 lambda: engine.generate(
                                     batch, max_new_tokens=cs.MAX_NEW))
    del moe_model, dparams, engine
    torch.cuda.empty_cache()

    # the enc-dec model's paged serve (K5, 16 slots of 4 pages of 16)
    cfg = get_config("transformer-base")
    corpus = make_corpus(cs.N_REQUESTS + cs.N_CALIB, cfg.vocab, seed=11)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cs.warm_up(model, params, corpus)
    recs = cs.calibrate(model, params, corpus)
    qparams, qctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"))
    requests, budgets = cs.serve_requests(cfg.vocab)
    half = cs.SERVE_REQUESTS // 2
    serve = lambda: ServingEngine(
        model, qparams, quant=qctx, max_len=cs.MAX_LEN,
        burst_len=cs.SERVE_BURST, paged=True, page_size=cs.PAGE).serve(
        requests[:half], n_slots=cs.SERVE_SLOTS, max_new_tokens=budgets[:half])
    serve()
    res["serve_paged"] = profiled(cs, f"serve_paged {half} requests", serve)
    return res


def run_trees(tool: str, srcs, timeout: int = 900):
    """Run ``tool --one SRC`` for each tree, in the order given, each in a
    fresh process that builds that tree's kernels; return (the card's name
    and power limit, the runs' ``AB`` objects), or (None, None) without a
    CUDA device."""
    import torch
    if not torch.cuda.is_available():
        print(f"{Path(tool).name}: no CUDA device", file=sys.stderr)
        return None, None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for src in srcs:
        proc = subprocess.run([sys.executable, tool, "--one", src],
                              capture_output=True, text=True, timeout=timeout)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{src}: exit {proc.returncode}")
        runs.append(json.loads(lines[-1][3:]))
        print(lines[-1], flush=True)
    return card, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    if args.one:
        print("AB " + json.dumps(one(args.src[0])), flush=True)
        return 0
    card, runs = run_trees(__file__, args.src)
    if runs is None:
        return 1
    for i, r in enumerate(runs):
        print(f"run {i} {r['src']} build {r['build_s']:.1f} s")
        for k in r["kernels"]:
            print(f"  {k['kernel']} {str(tuple(k['shape'])):28s} "
                  f"{k['ms']:.4f} ms cold {k['cold_ms']:.4f}")
        for name in ("moe_greedy", "serve_paged"):
            e = r[name]
            print(f"  {name:12s} busy {e['busy_ms']:.2f} of {e['wall_ms']:.1f}"
                  f" ms, idle {e['idle_share']:.3f}, K4 {e['k4_ms']:.2f} ms "
                  f"({e['k4_launches']}), K5 {e['k5_ms']:.2f} ms "
                  f"({e['k5_launches']}), tokens {e['tokens']}, steps "
                  f"{e['steps']}, host syncs {e['host_syncs']}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
