#!/usr/bin/env python3
"""Compare K1 and K2 (the INT8 activation quantizers) and the paths that
launch them between package trees on one GPU.

    python3 tools/quantize_ab.py SRC [SRC ...] [--out FILE]

Each SRC is a directory that holds a ``repro_torch`` package: ``src`` of
this checkout, or of another commit unpacked with ``git archive``.  For
each, in the order given and in a fresh process that builds that tree's
kernels (``tools/attention_ab.py:run_trees``):

* K1 (``quantize_static``) and K2 (``quantize_rowwise``) at every shape of
  ``chip_smoke.py`` phase 3 (``chip_smoke.quantizer_shapes``), bf16, warm
  and cold (``chip_smoke.time_ms``/``cold_ms``), each first checked bit
  for bit against that tree's plain version, and an empty kernel's time;
* ``granite-moe-1b-a400m`` at full width (random weights from seed 0, INT8
  with dynamic activation scales, as phase 7 builds it): one profiled
  greedy ``generate`` after an unprofiled one, with its token ids;
* ``transformer-base`` at full width (INT8, KL-calibrated static scales, as
  phase 4 builds it): one profiled greedy ``generate`` after an
  unprofiled one;
  for both, device busy ms and idle share from ``torch.profiler``
  (``tools/attention_ab.py:profiled``), K1's and K2's device ms and
  launches, tokens, steps and host syncs.

Giving the trees in turns (parent, change, change, parent) runs both on
one card and shows each one's spread.  The MoE greedy token ids must be
the same in every run.  One JSON object per run goes to stdout, prefixed
``AB``, then a table; ``--out FILE`` writes them as a JSON list.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from attention_ab import profiled, run_trees  # noqa: E402

QUANT_KERNELS = (("k1", "quantize_static_kernel"), ("k2", "quantize_rowwise"))


def kernel_times(cs, dev, gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import (quantize_rowwise_cuda,
                                              quantize_static_cuda)
    rows = []
    for M, K in cs.quantizer_shapes(*cs.path_dims()):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        amax = float(x.float().abs().max()) * 0.7
        q, sc = quantize_rowwise_cuda(x)
        rq, rsc = ref.ref_quantize_rowwise(x)
        if not (torch.equal(quantize_static_cuda(x, amax),
                            ref.ref_quantize_static(x, amax))
                and torch.equal(q, rq) and torch.equal(sc, rsc)):
            raise AssertionError(f"K1/K2 differ from the plain versions at "
                                 f"{(M, K)}")
        k1 = lambda xi=x: quantize_static_cuda(xi, amax)
        rows.append({"shape": [M, K],
                     "bound_ms": M * K * 3 / cs.HBM_BYTES_PER_S * 1e3,
                     "k1_ms": cs.time_ms(k1),
                     "k1_cold_ms": cs.cold_ms(k1, x, M * K),
                     "k2_ms": cs.time_ms(lambda: quantize_rowwise_cuda(x)),
                     "k2_cold_ms": cs.cold_ms(quantize_rowwise_cuda, x,
                                              M * K + 4 * M)})
    return rows


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
    from repro_torch.data import make_corpus, pad_batch
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"src": src, "build_s": build.build_seconds()}
    dev = torch.device("cuda")
    # an empty kernel, timed the same way (torch's, which every tree has)
    res["empty_ms"] = cs.time_ms(lambda: torch.cuda._sleep(0))
    res["kernels"] = kernel_times(cs, dev,
                                  torch.Generator(device=dev).manual_seed(1))

    def generate(engine, batch):
        held = {}

        def call():
            held["r"] = engine.generate(batch, max_new_tokens=cs.MAX_NEW)
            return held["r"]
        engine.generate(batch, max_new_tokens=cs.MAX_NEW)
        return held, call

    # the MoE model's greedy generate with dynamic scales (K2 at the
    # attention sites, and at the expert sites where a tree routes them
    # through it)
    moe_cfg = get_config(cs.MOE_ARCH)
    moe_model = DecoderLM(moe_cfg, device="cuda")
    moe_params = moe_model.init(torch.Generator(device="cuda").manual_seed(0))
    batch, _ = cs.moe_prompts(moe_cfg.vocab)
    dparams, dctx = quantize_model(moe_params, {},
                                   QuantPolicy(act_quant="dynamic"),
                                   device="cuda")
    del moe_params
    held, call = generate(ServingEngine(moe_model, dparams, quant=dctx,
                                        max_len=cs.MOE_MAX_LEN), batch)
    res["moe_greedy"] = profiled(cs, "moe_greedy_dynamic", call,
                                 QUANT_KERNELS)
    res["moe_greedy"]["token_ids"] = [
        [int(t) for t in row] for row in held["r"].tokens]
    del moe_model, dparams, held
    torch.cuda.empty_cache()

    # the enc-dec model's greedy generate with static scales (K1)
    cfg = get_config("transformer-base")
    corpus = make_corpus(cs.N_REQUESTS + cs.N_CALIB, cfg.vocab, seed=11)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cs.warm_up(model, params, corpus)
    recs = cs.calibrate(model, params, corpus)
    qparams, qctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"))
    src_toks, lens = pad_batch([s.src for s in corpus[:cs.N_REQUESTS]])
    _, call = generate(ServingEngine(model, qparams, quant=qctx,
                                     max_len=cs.MAX_LEN),
                       {"src_tokens": src_toks, "src_lengths": lens})
    res["encdec_greedy"] = profiled(cs, "greedy_static", call, QUANT_KERNELS)
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
    card, runs = run_trees(__file__, args.src)
    if runs is None:
        return 1
    for i, r in enumerate(runs):
        print(f"run {i} {r['src']} build {r['build_s']:.1f} s, empty kernel "
              f"{r['empty_ms']:.4f} ms")
        for k in r["kernels"]:
            print(f"  {str(tuple(k['shape'])):14s} K1 {k['k1_ms']:.4f} "
                  f"(cold {k['k1_cold_ms']:.4f}) K2 {k['k2_ms']:.4f} (cold "
                  f"{k['k2_cold_ms']:.4f}) ms; bound {k['bound_ms']:.5f}")
        for name in ("moe_greedy", "encdec_greedy"):
            e = r[name]
            print(f"  {name:13s} busy {e['busy_ms']:.2f} of "
                  f"{e['wall_ms']:.1f} ms, idle {e['idle_share']:.3f}, K1 "
                  f"{e['k1_ms']:.2f} ms ({e['k1_launches']}), K2 "
                  f"{e['k2_ms']:.2f} ms ({e['k2_launches']}), tokens "
                  f"{e['tokens']}, steps {e['steps']}, host syncs "
                  f"{e['host_syncs']}")
    ids = [r["moe_greedy"]["token_ids"] for r in runs]
    same = all(t == ids[0] for t in ids)
    print(f"MoE greedy token ids identical across the {len(runs)} runs: "
          f"{same}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
