"""Serving driver: the paper's inference stack on a reduced model.

    python -m repro_torch.launch.serve --arch transformer-base --requests 64 \
        --quant symmetric --streams 2

Port of ``repro/launch/serve.py``.  ``--mode static`` (the paper's):
synthetic requests → token-sorted scheduler → (optional calibrated INT8
PTQ) → parallel stream workers, each running ``generate`` (or
``generate_beam`` with ``--beam B``) → throughput report.

``--mode continuous`` serves the same requests through
``ServingEngine.serve``: admission order from the first-fit-decreasing
token-budget bin-packer, a slot-refill decode loop over ``--slots`` rows,
per-request first-token / total latency and decode-grid utilization.
``--beam B`` (B > 1) serves beam search there, each request on a group of
B rows (``--slots // B`` groups).  ``--paged`` backs the KV cache with
pages and block tables, and admission is paced by the page pool
(``--n-pages``); a beam reorder then moves block tables and one partial
page a row.  Admissions ride the burst by default; ``--unfused-admission``
runs them as separate prefills.  ``--burst-len auto`` lets the adaptive
controller move the burst cap between bursts.
``--weight-bits 4`` drops the decoder FFN and attention output projections
to block-wise INT4 weights (``--weight-group-size`` rows per scale/min
block).  ``--prefix-cache`` shares encoded sources across requests (a
chain pool of ``--prefix-pages`` pages); ``--overcommit`` admits past the
worst-case page reservation, and ``--chaos-seed`` injects seeded forced
preemptions (both ``--paged``), and ``--prefill-chunk N`` stages the
encode of a source longer than N tokens over serving rounds, one encoder
layer a round; they are reported on the "prefix cache:" and "overload:"
lines.

``--mesh DATA,MODEL`` (``--mode continuous``) serves tensor-parallel:
the driver spawns ``DATA·MODEL`` ranks (``torch.multiprocessing``,
``spawn``), joined by a ``--backend`` process group (default gloo on
``--device cpu``, nccl on cuda) through a file rendezvous in a temporary
directory; every rank builds the same model and serves the same requests
with its shard, and rank 0 prints.  NCCL needs a card a rank; where ranks
share a card, ``--backend gloo`` all-reduces the CUDA tensors through the
host.  ``--replicas N`` (``--mode continuous``) serves through a
``ReplicaRouter`` of N engines.

The model runs on ``--device`` (``cuda`` unless the caller asks for the
CPU; rank ``r`` of a mesh on card ``r`` mod the cards), with random weights
from ``torch.Generator`` seed 0.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    FP_CONTEXT,
    Calibrator,
    QuantMode,
    QuantPolicy,
    Taps,
    count_quantized,
    quantize_model,
)
from repro_torch.data import make_corpus, pack_batches_token_budget
from repro_torch.models import EncDecLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import (
    ParallelStreams,
    ReplicaRouter,
    Request,
    ServingEngine,
    TokenSortedScheduler,
    make_chaos,
)

MAX_LEN = 96            # the reference driver's engine KV capacity


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="transformer-base")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--quant", default="symmetric",
                    choices=["none", "naive", "symmetric", "independent",
                             "conjugate"])
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--beam", type=int, default=1,
                    help="beam width (1 = greedy); with --mode continuous, "
                         "each request occupies a group of `beam` decode "
                         "rows (--slots // beam groups)")
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--sort", default="tokens",
                    choices=["none", "words", "tokens"])
    ap.add_argument("--mode", default="static",
                    choices=["static", "continuous"])
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots for --mode continuous")
    ap.add_argument("--token-budget", type=int, default=256,
                    help="FFD bin budget (padded tokens) for admission "
                         "order in --mode continuous")
    ap.add_argument("--burst-len", default="8",
                    help="decode steps per host round trip (1 = per-step "
                         "loop), or 'auto' (the adaptive controller moves "
                         "the cap between bursts of --mode continuous)")
    ap.add_argument("--unfused-admission", action="store_true",
                    help="serve admissions as separate prefills instead of "
                         "folding them into the burst")
    ap.add_argument("--paged", action="store_true",
                    help="back the decode KV cache with fixed-size pages + "
                         "block tables; admission is paced by a page "
                         "budget (--mode continuous only)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged; must divide the "
                         "engine max_len)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size (--paged; default: contiguous-"
                         "equivalent capacity)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline on the serve clock (--mode "
                         "continuous): the wait queue runs EDF-with-aging "
                         "and unmeetable requests are shed")
    ap.add_argument("--weight-bits", type=int, default=8, choices=(8, 4),
                    help="weight payload precision: 8 = the paper's "
                         "per-channel INT8 everywhere; 4 = decoder FFN and "
                         "attention output projections drop to block-wise "
                         "INT4 (packed nibbles + group scale/min, dequantized "
                         "in the matmul kernel) while activations, attention "
                         "score paths and the KV cache stay INT8")
    ap.add_argument("--weight-group-size", type=int, default=128,
                    help="rows per INT4 scale/min block along d_in "
                         "(--weight-bits 4)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share encoded cross-K/V across requests with "
                         "identical sources: a hit splices a cached page "
                         "chain instead of re-running the encoder (--mode "
                         "continuous; the tokens are the same)")
    ap.add_argument("--prefix-pages", type=int, default=256,
                    help="prefix-cache chain-pool size in pages "
                         "(--prefix-cache; LRU-evicted under pressure)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="KV page reservation cap as a multiple of the "
                         "physical pool (--paged; > 1 admits past the "
                         "worst-case reservation, and preempt-by-page-spill "
                         "covers the shortfall when budgets collide)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seeded forced-preemption schedule at "
                         "burst edges (--paged); the tokens are those of "
                         "an uninterrupted serve")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the engine")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: a source longer than this many "
                         "tokens is encoded one encoder layer per serving "
                         "round (fused admission only)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve tensor-parallel on a (data, model) mesh, "
                         "e.g. '1,2': DATA·MODEL ranks, weights and K/V "
                         "heads split on the model axis, the tokens of the "
                         "unsharded engine (--mode continuous)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process group of --mesh (default: gloo on "
                         "--device cpu, nccl on cuda; nccl needs a card a "
                         "rank, gloo lets ranks share a card)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind the "
                         "free-page/queue-depth router (--mode continuous; "
                         "each replica serves its share in a thread)")
    return ap


def _mesh_shape(args) -> tuple:
    try:
        data, model = (int(x) for x in args.mesh.split(","))
    except ValueError:
        raise SystemExit(f"--mesh wants 'DATA,MODEL', got {args.mesh!r}")
    return data, model


def _calibrate(model, params, sentences, mode: str, device, weight_bits: int,
               group_size: int):
    """KL-calibrate the activation thresholds on ``sentences`` and quantize
    (INT8 weights, or INT4 where eligible; static activation scales)."""
    cal = Calibrator()
    for s in sentences:
        taps = Taps()
        tgt = np.concatenate([[1], s.tgt, [2]])[None, :]
        model.forward(params, {
            "src_tokens": torch.as_tensor(s.src[None, :], device=device),
            "tgt_tokens": torch.as_tensor(tgt, device=device)}, taps=taps)
        cal.observe_taps(taps)
    recs = cal.compute(mode)
    params, qctx = quantize_model(
        params, recs, QuantPolicy(mode=QuantMode(mode), act_quant="static"),
        weight_bits=weight_bits, weight_group_size=group_size,
        device=str(device))
    print(f"quantized with mode={mode}: "
          f"{sum(r.quantize for r in recs.values())}/{len(recs)} "
          "calibrated sites quantizable")
    if weight_bits == 4:
        stats = count_quantized(params)
        print(f"INT4 weights: {stats['int4_linears']} decoder linears, "
              f"{stats['int4_bytes']} bytes (group_size={group_size}); "
              f"INT8 elsewhere: {stats['int8_bytes']} bytes")
    return params, qctx


def _serve_continuous(args, model, params, qctx, requests,
                      mesh=None) -> None:
    def mk_engine():
        return ServingEngine(model, params, quant=qctx, max_len=MAX_LEN,
                             burst_len=args.burst_len, paged=args.paged,
                             page_size=args.page_size, n_pages=args.n_pages,
                             prefix_cache=args.prefix_cache,
                             prefix_pages=args.prefix_pages, mesh=mesh,
                             device=args.device)

    engine = mk_engine()
    bins = pack_batches_token_budget(requests, args.token_budget)
    order = [i for b in bins for i in b]         # FFD admission order
    reqs = [requests[i] for i in order]
    if args.deadline_ms is not None:
        reqs = [Request(req_id=k, src=np.asarray(s.src, np.int32),
                        max_new_tokens=args.max_new_tokens,
                        deadline_s=args.deadline_ms / 1e3)
                for k, s in enumerate(reqs)]
    beam = args.beam if args.beam > 1 else None
    chaos = (make_chaos(args.chaos_seed, n_rounds=256, preempt_every=2)
             if args.chaos_seed is not None else None)
    serve_kw = dict(n_slots=args.slots, max_new_tokens=args.max_new_tokens,
                    beam=beam, fused_admission=not args.unfused_admission,
                    overcommit=args.overcommit, chaos=chaos,
                    prefill_chunk=args.prefill_chunk)
    if args.replicas > 1:
        router = ReplicaRouter(
            [engine] + [mk_engine() for _ in range(args.replicas - 1)])
        rres = router.serve(reqs, **serve_kw)
        print(f"router x{args.replicas}: {len(rres.requests)} requests "
              f"in {rres.wall_s:.2f}s ({rres.tokens_per_s:.1f} tok/s), "
              f"per-replica peak_running {rres.peak_running_per_replica}, "
              f"assignment counts "
              f"{[rres.assignment.count(i) for i in range(args.replicas)]}")
        for i, r in enumerate(rres.results):
            print(f"  replica {i}: {sum(len(q.tokens) for q in r.requests)}"
                  f" tokens, {r.host_syncs} syncs, "
                  f"utilization {r.utilization:.2f}"
                  + (f", tp={r.tp_degree} mesh={r.mesh_shape}"
                     if r.tp_degree > 1 else ""))
        return
    t0 = time.perf_counter()
    res = engine.serve(reqs, **serve_kw)
    dt = time.perf_counter() - t0
    met = res.metrics()
    print(f"served {args.requests} requests in {dt:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s, "
          f"slot utilization {res.utilization:.2f}, "
          f"{res.prefill_rounds} admission rounds)")
    if res.tp_degree > 1:
        print(f"tensor-parallel: mesh {res.mesh_shape} "
              f"(tp={res.tp_degree}), predicted "
              f"{res.collective_bytes_per_step} collective "
              f"bytes/step/device")
    if beam:
        print(f"beam={res.beam}: {res.n_groups} groups of {res.beam} "
              f"rows in a {res.n_slots}-row grid"
              + (f" ({args.slots - res.n_slots} rows stranded — "
                 f"beam does not divide --slots)"
                 if res.n_slots != args.slots else ""))
    print(f"burst_len={res.burst_len}"
          + (" (auto)" if res.auto_burst else "")
          + f": {res.host_syncs} host syncs for "
          f"{res.decode_steps} decode steps "
          f"({res.decode_steps_per_s:.0f} steps/s)")
    print(("fused admission" if res.fused_admission
           else "UNFUSED admission")
          + f": {res.prefill_dispatches} prefill dispatches, "
          f"{res.encoder_tokens} encoder row-tokens")
    if res.paged:
        print(f"paged KV: page_size={res.page_size}, "
              f"peak {res.page_hwm} pages "
              f"({res.page_hwm * res.page_size} tokens), "
              f"{res.pages_in_use} leaked, "
              f"beam-reorder bytes {res.reorder_bytes}")
    elif beam:
        print(f"beam-reorder bytes {res.reorder_bytes}")
    if res.prefix_cache:
        print(f"prefix cache: {res.prefix_hits} hits / "
              f"{res.prefix_hits + res.prefix_misses} admissions "
              f"(hit rate {met['prefix_hit_rate']:.2f}), "
              f"{res.prefix_hit_pages} chain pages reused, "
              f"{res.prefix_pages_allocated} allocated, "
              f"{res.prefix_evictions} evicted, "
              f"{res.prefix_chains} chains resident")
    if (res.preemptions or res.chunked_admissions or res.rejected
            or res.overcommit != 1.0 or chaos is not None
            or args.deadline_ms is not None):
        print(f"overload: overcommit={res.overcommit} "
              f"peak_running={res.peak_running}, "
              f"{res.preemptions} preemptions "
              f"({res.spill_events} spills / {res.restore_events} "
              f"restores, {res.spilled_bytes / 1024:.1f} KiB to host), "
              f"free_lwm={res.free_lwm}")
        print(f"         {res.chunked_admissions} chunked admissions "
              f"({res.chunk_rounds} staged encoder rounds), "
              f"{res.rejected} shed, "
              f"{res.deadline_misses} deadline misses, "
              f"{res.straggler_rounds} straggler rounds")
    print(f"latency: first-token mean "
          f"{met['first_token_latency_mean_s']:.3f}s "
          f"p95 {met['first_token_latency_p95_s']:.3f}s; total mean "
          f"{met['total_latency_mean_s']:.3f}s "
          f"p95 {met['total_latency_p95_s']:.3f}s")


def _serve_static(args, model, params, qctx, requests) -> None:
    engines = [ServingEngine(model, params, quant=qctx, max_len=MAX_LEN,
                             device=args.device)
               for _ in range(args.streams)]
    sched = TokenSortedScheduler(batch_size=args.batch_size,
                                 sort_mode=args.sort)
    items = sched.plan(requests)
    print(f"{len(items)} batches; padding stats: {sched.stats(requests)}")

    def run_batch(sid: int, item) -> int:
        eng = engines[sid]
        if args.beam > 1:
            res = eng.generate_beam(item.batch, beam=args.beam,
                                    max_new_tokens=args.max_new_tokens)
        else:
            res = eng.generate(item.batch,
                               max_new_tokens=args.max_new_tokens)
        return res.n_tokens

    streams = ParallelStreams(run_batch, n_streams=args.streams)
    t0 = time.perf_counter()
    out = streams.run(items)
    dt = time.perf_counter() - t0
    print(f"served {args.requests} requests in {dt:.2f}s "
          f"({args.requests / dt:.2f} sentences/s, "
          f"{out['throughput_tok_s']:.1f} tok/s, "
          f"stream utilization {out['utilization']:.2f})")


def _run(args, mesh=None) -> None:
    """Build the model, quantize it and serve: the whole driver in one
    process, or one rank of a ``--mesh``."""
    device = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    if not cfg.enc_dec:
        raise SystemExit("serve driver expects an enc-dec (NMT) arch")
    model = EncDecLM(cfg, device=args.device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    corpus = make_corpus(args.requests + 64, cfg.vocab, seed=11)
    requests = corpus[:args.requests]

    qctx = FP_CONTEXT
    if args.quant != "none":
        params, qctx = _calibrate(
            model, params, corpus[args.requests:args.requests + 32],
            args.quant, device, args.weight_bits, args.weight_group_size)

    if args.mode == "continuous":
        _serve_continuous(args, model, params, qctx, requests, mesh)
    else:
        _serve_static(args, model, params, qctx, requests)


def _rank_main(rank: int, world: int, init_method: str, args) -> None:
    """One rank of ``--mesh``: join the group, serve, leave it."""
    import torch.distributed as dist
    if args.device.startswith("cuda"):
        args.device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(args.device))
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if rank:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group(args.backend, init_method=init_method,
                            rank=rank, world_size=world)
    try:
        _run(args, make_host_mesh(*_mesh_shape(args)))
    finally:
        dist.destroy_process_group()


def _spawn_mesh(args) -> None:
    import torch.multiprocessing as mp
    data, model = _mesh_shape(args)
    world = data * model
    on_cuda = torch.device(args.device).type == "cuda"
    args.backend = args.backend or ("nccl" if on_cuda else "gloo")
    if args.backend == "nccl" and (
            not on_cuda or world > torch.cuda.device_count()):
        raise SystemExit(
            f"--backend nccl needs a card a rank: {world} ranks, "
            f"{torch.cuda.device_count() if on_cuda else 0} cards on "
            f"--device {args.device}; pass --backend gloo to let ranks "
            "share a card (its collectives go through the host)")
    print(f"mesh data={data} model={model}: {world} ranks over "
          f"{args.backend}")
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        from repro_torch.launch import serve as this
        mp.spawn(this._rank_main,
                 args=(world, f"file://{os.path.join(tmp, 'rdzv')}", args),
                 nprocs=world, join=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.burst_len != "auto":
        args.burst_len = int(args.burst_len)
    if args.mesh and args.mode != "continuous":
        raise SystemExit("--mesh needs --mode continuous")
    if args.replicas > 1 and args.mode != "continuous":
        raise SystemExit("--replicas needs --mode continuous")
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    if args.mesh:
        _spawn_mesh(args)
    else:
        _run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
