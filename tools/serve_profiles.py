#!/usr/bin/env python3
"""Profiled continuous serves of the full-width enc-dec INT8 model on one
GPU: where a serve's device time goes.

    python3 tools/serve_profiles.py

``transformer-base`` at full width (bf16 activations, float32 weights from
``torch.Generator`` seed 0, KL-calibrated static activation scales, as
``chip_smoke.py`` phase 4 builds it), then:

* a profiled paged greedy serve of the first quarter of phase 5's requests
  (busy time, idle share, the largest kernels, K1's, K2's, K4's and K5's
  device time and launches);
* a profiled contiguous and a profiled paged beam-4 serve of the first
  ``PROFILED_BEAM_REQUESTS`` of phase 5b's requests (device only), each
  with one beam reorder of its cache profiled alone (device ms and kernels
  a reorder, times the serve's steps, as a share of busy time).

``chip_smoke.py`` ran these until its time budget needed the room for its
training phase; they time and check nothing that it relies on.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                   # noqa: E402  (puts ROOT/src first)
from chip_smoke import (                  # noqa: E402
    BEAM, MAX_LEN, PAGE, SERVE_BURST, SERVE_REQUESTS, SERVE_SLOTS,
    attention_ms, beam_requests, device_rows, log, profile, serve_requests)

PROFILED_BEAM_REQUESTS = 8     # two waves of 4 groups on 16 rows


def profile_paged_serve(model, qparams, qctx) -> None:
    """The first quarter of the requests through a profiled paged serve
    (the profiler's own cost grows with the number of events)."""
    from repro_torch.serving import ServingEngine
    corpus, budgets = serve_requests(model.cfg.vocab)
    quarter = SERVE_REQUESTS // 4
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                           burst_len=SERVE_BURST, paged=True, page_size=PAGE)
    _, rows, _ = profile(
        f"serve_paged {quarter} requests", lambda: engine.serve(
            corpus[:quarter], n_slots=SERVE_SLOTS,
            max_new_tokens=budgets[:quarter]).decode_steps)
    log(f"  {attention_ms(rows)}")




def reorder_ms(model, paged: bool):
    """Device ms and kernels of one beam reorder of a phase-5b decode state
    (16 rows, INT8 cache, cross K/V of the 64-token bucket) by a random
    permutation within each group: contiguous, the slab and cross-K/V
    gathers; paged, the table permutation and the copy-on-write page copy.
    Summed from the profiler over 20 reorders, so launch gaps stay out."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.models import kv_cache as kvc
    from repro_torch.serving import ServingEngine
    R, maxP = SERVE_SLOTS, MAX_LEN // PAGE
    state = model.init_decode_state(R, MAX_LEN, quantized=True, enc_len=64,
                                    paged=paged, page_size=PAGE)
    cache = state["cache"]
    rng = np.random.default_rng(4)
    lengths = torch.as_tensor(rng.integers(1, MAX_LEN, R), dtype=torch.int32,
                              device="cuda")
    if paged:
        cache = kvc.assign_pages(cache, np.arange(R), np.arange(
            R * maxP, dtype=np.int32).reshape(R, maxP))
    state["cache"] = kvc.with_lengths(cache, lengths)
    idx = torch.as_tensor(np.arange(R) // BEAM * BEAM
                          + rng.integers(0, BEAM, R), device="cuda")
    for _ in range(5):
        ServingEngine._beam_gather_state(state, idx)
    torch.cuda.synchronize()
    n = 20
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ServingEngine._beam_gather_state(state, idx)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        raise AssertionError("the profiler saw no reorder kernel")
    return (sum(r[0] for r in rows) / n, sum(r[2] for r in rows) / n)


def profile_beam_serves(model, qparams, qctx) -> None:
    """A profiled contiguous and a profiled paged beam-4 serve of the first
    ``PROFILED_BEAM_REQUESTS`` of phase 5b's requests (device only: busy
    time, idle share, K4's and K5's device time), and one reorder of each
    cache profiled alone."""
    from repro_torch.serving import ServingEngine
    corpus, budgets = beam_requests(model.cfg.vocab)
    n = PROFILED_BEAM_REQUESTS
    for paged in (False, True):
        engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                               burst_len=SERVE_BURST, paged=paged,
                               page_size=PAGE)
        out = {}

        def serve():
            out["res"] = engine.serve(corpus[:n], n_slots=SERVE_SLOTS,
                                      max_new_tokens=budgets[:n],
                                      beam=BEAM)
            return out["res"].decode_steps

        kind = "paged" if paged else "contiguous"
        busy, rows, _ = profile(f"serve_beam_{kind} {n} requests", serve,
                                cpu=False)
        ms, kernels = reorder_ms(model, paged)
        steps = out["res"].decode_steps
        log(f"  {attention_ms(rows)}; one reorder {ms:.4f} device ms in "
            f"{kernels:.0f} kernels (profiled alone), × {steps} steps = "
            f"{ms * steps:.2f} ms = {ms * steps / busy:.3f} of busy")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serve_profiles: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy, quantize_model
    from repro_torch.data import make_corpus
    from repro_torch.models import EncDecLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("transformer-base")
    corpus = make_corpus(cs.N_REQUESTS + cs.N_CALIB, cfg.vocab, seed=11)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cs.warm_up(model, params, corpus)
    qparams, qctx = quantize_model(params, cs.calibrate(model, params, corpus),
                                   QuantPolicy(act_quant="static"))
    profile_paged_serve(model, qparams, qctx)
    profile_beam_serves(model, qparams, qctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
