#!/usr/bin/env python3
"""Compare beam-4 ``generate_beam`` between package trees on one GPU.

    python3 tools/beam_ab.py SRC [SRC ...] [--out FILE]

Each SRC is a directory that holds a ``repro_torch`` package: ``src`` of
this checkout, or of another commit unpacked with ``git archive``.  For
each, in the order given and in a fresh process that builds that tree's
kernels (``tools/attention_ab.py:run_trees``):

* ``transformer-base`` at full width (INT8, KL-calibrated static scales, as
  ``chip_smoke.py`` phase 4 builds it): ``generate_beam(beam=4)`` of
  phase 4's 16 requests, 24 new tokens;
* ``granite-moe-1b-a400m`` at full width (random weights from seed 0, INT8
  with dynamic activation scales, as phase 7 builds it):
  ``generate_beam(beam=4)`` of its 16 prompts, 24 new tokens;

each once to warm up, then ``REPS`` times unprofiled (each run's prefill
and decode seconds, from ``GenerationResult``) and once profiled (device
busy ms and idle share from ``torch.profiler``,
``tools/attention_ab.py:profiled``), with its token ids.

Giving the trees in turns (parent, change, change, parent) runs both on
one card and shows each one's spread.  The token ids must be the same in
every run.  One JSON object per run goes to stdout, prefixed ``AB``, then a
table; ``--out FILE`` writes them as a JSON list.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from attention_ab import profiled, run_trees  # noqa: E402

REPS = 3
NO_KERNELS = ()


def beam_runs(cs, label, engine, batch) -> dict:
    """Warm-up, ``REPS`` timed runs and one profiled run of beam-4
    ``generate_beam`` on ``batch``."""
    call = lambda: engine.generate_beam(batch, beam=cs.BEAM,
                                        max_new_tokens=cs.MAX_NEW)
    call()
    reps = [call() for _ in range(REPS)]
    res = profiled(cs, label, call, NO_KERNELS)
    res["prefill_s"] = [r.prefill_s for r in reps]
    res["decode_s"] = [r.decode_s for r in reps]
    res["total_s_median"] = statistics.median(r.total_s for r in reps)
    res["tokens_per_s_median"] = statistics.median(
        r.tokens_per_s for r in reps)
    res["token_ids"] = [[int(t) for t in row] for row in reps[-1].tokens]
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
    from repro_torch.data import make_corpus, pad_batch
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"src": src, "build_s": build.build_seconds()}

    cfg = get_config("transformer-base")
    corpus = make_corpus(cs.N_REQUESTS + cs.N_CALIB, cfg.vocab, seed=11)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cs.warm_up(model, params, corpus)
    recs = cs.calibrate(model, params, corpus)
    qparams, qctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"))
    src_toks, lens = pad_batch([s.src for s in corpus[:cs.N_REQUESTS]])
    res["encdec_beam4"] = beam_runs(
        cs, "encdec_beam4_static",
        ServingEngine(model, qparams, quant=qctx, max_len=cs.MAX_LEN),
        {"src_tokens": src_toks, "src_lengths": lens})
    del model, params, qparams
    torch.cuda.empty_cache()

    moe_cfg = get_config(cs.MOE_ARCH)
    moe_model = DecoderLM(moe_cfg, device="cuda")
    moe_params = moe_model.init(torch.Generator(device="cuda").manual_seed(0))
    batch, _ = cs.moe_prompts(moe_cfg.vocab)
    dparams, dctx = quantize_model(moe_params, {},
                                   QuantPolicy(act_quant="dynamic"),
                                   device="cuda")
    del moe_params
    res["moe_beam4"] = beam_runs(
        cs, "moe_beam4_dynamic",
        ServingEngine(moe_model, dparams, quant=dctx,
                      max_len=cs.MOE_MAX_LEN), batch)
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
    same = True
    for i, r in enumerate(runs):
        print(f"run {i} {r['src']} build {r['build_s']:.1f} s")
        for name in ("encdec_beam4", "moe_beam4"):
            e = r[name]
            same &= e["token_ids"] == runs[0][name]["token_ids"]
            print(f"  {name:12s} total {e['total_s_median']:.4f} s (median "
                  f"of {REPS}), {e['tokens_per_s_median']:.1f} tok/s, "
                  f"decode s {['%.4f' % d for d in e['decode_s']]}; "
                  f"profiled busy {e['busy_ms']:.2f} of {e['wall_ms']:.1f} "
                  f"ms, idle {e['idle_share']:.3f}, tokens {e['tokens']}, "
                  f"steps {e['steps']}, host syncs {e['host_syncs']}")
    print(f"token ids identical across the {len(runs)} runs: {same}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
