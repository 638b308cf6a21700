#!/usr/bin/env python3
"""Drive the PyTorch port's INT8 and INT4-weight translation and serving
paths (greedy and beam), its training path, and its decoder-only MoE
generation, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final line):

1. card   — name and power limit from ``nvidia-smi``; no CUDA → exit 1;
2. build  — compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels vs plain — each of the seven kernels at its paths' shapes
   against its plain PyTorch version on the card, with its time, the plain
   version's, a library call's where one computes the same function, and
   its bound; K1-K4 at the enc-dec and the MoE shapes (K4 with 16 heads
   over 8 KV heads for the MoE model); an empty kernel's time first; K1
   and K2 (the activation quantizers) bit for bit also at the MoE expert
   inputs (32 experts' rows at greedy and beam-4 decode and prefill), with
   cold-L2 times at the prefill and expert shapes; K3 (the INT8 GEMM
   tile) bit for bit, f32 and bf16, also at shapes that reach both tile
   configurations and a split of K, with a cold-L2 time beside the warm
   one; K4 and K5 (flash-decode attention, contiguous and paged) also
   under every forced plan (the same bits, and each plan's time), at a
   long cache of 4096 positions that the plan splits over a cluster,
   warm and cold, with a row's output the same bits alone and in its
   batch, and K5 against K4 on the linearized cache, bit for bit, also
   over block tables shared within beam groups (the state a paged beam
   reorder leaves); K6 (the INT4-weight matmul, K3's tile on packed
   nibbles) bit for bit, f32 and bf16, also at shapes that reach each tile
   and its group-ordered split, warm and cold, beside K3's time at the
   same shape;
   K7 (the grouped expert GEMM, K3's tile) bit for bit at the rows per
   expert of every MoE forward pass (greedy and beam-4 decode and
   prefill), f32 and bf16, warm and cold; K1-K4 also at phase 4t's
   Table-1 shapes (d_model 128, d_ff 256, heads of 32) and at phase 7b's
   (rows 16 and 16 × 46; K 5120, 4096 and 14336; N 4096, 1024, 14336 and
   5120; 32 heads of 128 over 8 at a cache of 80), K3 at phase 7d's
   in-projections (16 × 2560 → 10448, 16 × 2048 → 16384, beside
   ``torch._int_mm``), K4 and K5 at zamba2's attention (16 rows, 32
   heads of 80 over 32, a cache of 80: every plan the same bits), and K3
   with a nonzero activation zero point (the affine modes' epilogue) at
   every shape; K3's two halves for a product split across ranks (the s32
   accumulator alone, and the epilogue alone on it) at every K3 shape,
   bit for bit equal to fused K3 and to their plain versions, f32 and
   bf16, with and without a zero point, with a per-row, a per-tensor and
   a by-value activation scale, and timed at phase 5e's sharded shapes
   (transformer-base's linears at half their N or K, at 16 and 736 rows)
   and at phase 5f's (mistral-nemo-12b's o 2048 -> 5120 and down 7168 ->
   5120 at 16 rows, beside fused K3 at its column-parallel q, k/v and
   gate/up at half their N); K7 also at phase 5f's 16 experts a rank
   (5 and 20 rows an expert); K1 also at phase 5g's float32 gradient
   leaves (512 × 2048 and 37000 × 512), warm and cold;
4. end to end — transformer-base at full width (bf16 activations, float32
   weights from ``torch.Generator`` seed 0): after a two-token warm-up,
   KL-calibrate, quantize to INT8, greedy ``generate`` and beam-4
   ``generate_beam`` with static activation scales, one greedy
   ``generate`` with dynamic scales; then the first decode steps' logits
   against the same run with ``impl="torch"``, and a profiled greedy run
   (device busy time, its largest kernels, K4's and K5's device time);
5. continuous serving — 48 requests with budgets of 4–48 tokens through
   ``ServingEngine.serve`` on 16 slots (INT8, static scales): contiguous
   cache, paged cache (default pool and a tight 32-page pool) with fused
   admission, and paged with unfused admission.  Paged and contiguous
   tokens must be identical, every page returned, K5 launched on the paged
   runs only and its plain version never; then the first 12 requests
   again through per-request ``generate`` (logged) (the profiled paged
   serve that followed is now ``tools/serve_profiles.py``);
5b. continuous beam serving — the first 24 of those requests at
   ``beam=4`` (4 groups of 4 rows): contiguous fused, paged fused, paged
   unfused, paged with mixed widths (1–4), paged with
   ``burst_len="auto"``, and paged with dynamic activation scales (K2).
   Every request finishes, paged tokens equal contiguous tokens, every
   page is returned, the reorder bytes a step equal the reference's
   formula, K4 launches on the contiguous run and K5 on the paged ones,
   K2 on the dynamic one, and neither plain attention runs; then the
   agreement of the first 12 with per-request ``generate_beam`` (logged)
   (the profiled beam serves and reorders that followed are now
   ``tools/serve_profiles.py``);
6. INT4 weights — the same model quantized with ``weight_bits=4`` (decoder
   FFN and attention output projections block-wise INT4, group 128, f16
   scales; static activation scales): greedy and beam-4 ``generate``, a
   greedy paged ``serve`` of the 48 requests and a beam-4 one of the first
   24; K6 must launch and its plain version run 0 times, and the first
   decode steps' logits with the kernels must match those with
   ``impl="torch"``; then a profiled greedy run (busy time, idle share,
   K6's time and kernels);
7. the decoder-only MoE family — granite-moe-1b-a400m at its published
   widths and 2 of its 24 layers (32 experts top-8; random weights from
   ``torch.Generator`` seed 0, bf16 activations) on 16 right-padded
   prompts: INT8 greedy and beam-4 ``generate`` with dynamic activation
   scales, and greedy with static scales after KL calibration on 16
   held-out prompts.  K7 (the grouped expert GEMM) must launch three times
   a layer in every forward pass and its plain version never, and one
   quantizer (K2 with dynamic scales, K1 or K2 with static ones) seven
   times a layer (q, k, v, o and the three expert sites), with no plain
   quantizer run; then the
   first decode steps' logits against ``impl="torch"``, with dynamic and
   with static scales, and a profiled greedy run (busy time, idle share,
   K7's share, K4's device time);
7b. the dense SwiGLU family (after phase 7's trees are freed) —
   mistral-nemo-12b at its published widths and, since phases 7d and 5e
   took the time, 4 of its 40 layers (d_model 5120, 32 heads of 128 over 8,
   d_ff 14336, vocab 131072, rope theta 1e6; float32 weights from ``torch.Generator`` seed 0 on the card,
   bf16 activations) on phase 7's 16 prompts, 24 new tokens, cache 80:
   INT8 greedy ``generate`` with dynamic scales; KL calibration on 8
   held-out prompts, the float32 tree freed, INT8 greedy with static
   scales.  K1 (static) or K2 (dynamic) and K3 launch 7 times a layer in
   every forward pass, K4 once a layer a decode step, no other kernel and
   no plain version; a prefill from ``embeds`` equal to the prompts'
   embedding rows (the VLM path) equals the token prefill bit for bit;
   with each kind of scales the prefill and 3 decode steps against the
   plain versions (:func:`check_deep_against_plain`: K1-K3 bit for bit
   with K4's kernel in both, every K4 call within a bf16 ulp of its plain
   version on its inputs, and the all-plain path, with each K4 output
   moved by the kernel's recorded ulps, bit for bit; the all-plain drift
   logged);
   seconds for init, calibration and quantization, tokens/s, a profiled
   greedy call (busy time, idle share, K3's share) and the peak memory;
7c. the audio stub — whisper-base at its published widths, INT8 dynamic,
   from ``src_embeds`` of 4 × 1500 frames: greedy ``generate`` (K2, K3,
   K4, no plain version), then the prefill and 8 decode steps against the
   plain versions as in 7b;
7d. the recurrent families at their published widths, zamba2-2.7b at 13
   of its 54 layers and xlstm-1.3b at 8 of its 48 (phases 5f and 5g
   took the time), after 5f, one model at a time: zamba2-2.7b
   (``HybridLM``: Mamba2 layers, d_model 2560, 80 SSD heads of 64, state
   64, chunk 256; a shared attention + GELU block every 6th layer, 32
   heads of 80: 2 applications at 13 layers) and xlstm-1.3b
   (``XLSTMLM``: an sLSTM layer after every 7 mLSTM layers, 7 and 1 of
   them at 8 layers, d_model 2048, 4 heads of 1024); float32 weights
   from ``torch.Generator`` seed 0 on the card,
   bf16 activations, phase 7's 16 prompts padded to 46, 24 new tokens,
   cache 80: KL calibration on 8 held-out prompts, then INT8 greedy
   ``generate`` with dynamic and with static scales.  Each run's launches
   are held to the quantized tree: the quantizer (K2 dynamic, K1 static)
   and K3 once for each INT8 linear a forward pass (the shared block's
   once an application), K4 once an application a decode step (zamba2's
   head dim 80), no other kernel and no plain version; with static scales
   the reference quantizes only the weights whose parameter path is their
   site name (zamba2's shared block, none of xlstm's), and so does the
   port.  Then the prefill and 3 decode steps against the plain versions
   (:func:`check_deep_against_plain`, as in 7b; xlstm, which has no K4,
   bit for bit end to end), a
   profiled dynamic greedy call (busy time, idle share, tokens/s) and the
   peak memory;
5c. the prefix cache and overload (run after phase 6, whose INT4 weights
   it reuses) — 24 requests, phase 5's first 12 sources each twice with
   their budgets, on 16 rows (INT8 static, burst 8, pages of 16): a cold
   paged greedy serve, then fused with ``prefix_cache=True`` (at least 12
   hits) and again on the same engine (24 hits, no chain page
   allocated, no encoder work); with the cache also a contiguous (K4), an
   unfused, a beam-4 paged and an INT4 paged (K6) serve; then overload:
   a paged pool of half the unloaded serve's page high-water mark at
   ``overcommit=1.5`` with ``make_chaos(5, n_rounds=256,
   preempt_every=2)``, greedy and at beam 4 (against phase 5b's paged
   serve): preemptions, every page returned and every spill restored,
   and in every serve of this phase no plain attention or INT4 call.
   The counts of requests whose tokens equal the cold or unloaded serve's
   are logged; then one spill and one resume of a greedy row and of a
   beam-4 group, timed (device span between CUDA events, host ms, the
   profiler's busy time with its events counted against the launches,
   bytes);
5d. chunked prefill and self-speculative decoding (after 5c) — phase 5's
   first 24 requests with ``prefill_chunk=24`` (13 sources stage, one
   encoder layer a round): paged greedy, paged beam 4, and greedy at
   ``overcommit=1.5`` with a chaos schedule on half its page high-water
   mark; 13 chunked admissions each, 13 × 6 chunk rounds where nothing
   was preempted.  Then ``generate(speculative_k=2, 4)`` on phase 4's
   batch, and ``serve(speculative_k=4)`` of the 24 requests, contiguous
   (K4) and paged (K5) with the self-draft and paged with a dynamic (K2)
   draft under the static (K1) verifier.  No plain attention or INT4 call
   in any run; equal-token counts against the plain serves, acceptance
   rates, tokens/s beside the plain serves' and the K4/K5 launches are
   logged, and one macro-step's verify logits against sequential decode's
   (the largest |Δ| by position);
5e. tensor-parallel serving and the replica router (after 5d) — phase
   4's INT8 static weights saved, and two ranks (spawned as 5d starts,
   so their imports overlap it) run on ``cuda:0``
   over gloo (NCCL cannot put two ranks of one communicator on one
   card), each cutting its shard of transformer-base at full width on a
   ``(1, 2)`` mesh (4 of 8 heads, d_ff 1024, vocab 18500 a rank): greedy
   ``generate`` of phase 4's batch, phase 5's 48 requests through a paged
   ``serve`` (16 slots, burst 8, pages of 16) and a paged
   ``serve(speculative_k=2)`` of phase 5d's 24.  Each rank's tokens, host
   syncs and counters must equal the unsharded runs' (phase 4's, phase
   5's, and the same speculative serve here); its first 3 decode steps'
   logits must equal the other rank's bit for bit and the unsharded ones
   bit for bit or within ``LOGIT_ATOL`` (the difference logged); K1, K3,
   K3's two halves, K4 and K5 must launch on every rank and no plain
   version run; a rank's exception, nonzero exit or timeout fails the
   phase.  Beside the ranks, this process serves phase 5's requests on a
   ``(1, 1)`` mesh (equal to phase 5's paged serve bit for bit) and
   through a two-replica ``ReplicaRouter``, threaded and serial (phase
   5's tokens, an even split).  Tokens/s are logged beside the unsharded
   runs': the ranks' collectives go through the host, so none is a
   multi-GPU speed;
5f. the decoder-only families on 5e's two ranks (their dynamic runs go
   beside phase 4t's Table 1, the static ones after phase 7c, checked
   then, before 7d): each rank remakes phases 7's and 7b's float32 trees
   from seed 0 (granite-moe-1b-a400m at 2 layers, mistral-nemo-12b at
   4), quantizes the whole tree and cuts its shard on the ``(1, 2)``
   mesh: 8 of 16 heads over 4 of 8 kv heads and 16 of 32 experts (vocab
   49155 stays whole), and 16 of 32 heads over 4 of 8, d_ff 7168 and
   vocab 65536; INT8 dynamic greedy and beam-4 ``generate`` of the MoE
   and dynamic greedy of mistral, then static greedy of both on this
   process's thresholds (phases 7's and 7b's calibrations).  Every
   rank's tokens, steps and host syncs must equal phases 7's and 7b's
   runs; its prefill's and first 3 decode steps' logits must equal the
   other rank's bit for bit and the unsharded ones bit for bit or within
   ``LOGIT_ATOL`` (logged); its launches of K1, K2, K4 and K7 (over its
   16 experts) must equal the unsharded run's, K3 fused plus its
   accumulator half the unsharded K3, both halves must launch, and no
   plain version may run.  Each rank's seconds, launches, tokens/s beside
   the unsharded runs' and peak memory are logged, and the expert
   gather's bytes a layer;
5g. training on a mesh on 5e's two ranks, as the reference runs its
   published configs (``remat=True``: each block recomputed in the
   backward, its FSDP-split leaves gathered as it runs, the residual
   stream each rank's ``S/tp`` rows between blocks) —
   ``make_train_step(grad_shardings=...)`` with
   ``launch.specs.train_arg_specs``' layout, each rank remaking the whole
   tree from seed 0 and cutting its shard.  In 5f's wait for this
   process's thresholds (beside phases 7 and 7b): transformer-base at its
   published widths (phase 4t's
   weights, optimizer and 32-row batch, float32 activations, TF32 off)
   trains 2 steps on a ``(2, 1)`` mesh (FSDP) and on a ``(1, 2)`` one
   (tensor parallel: heads, d_ff and vocab split); every step's metrics
   must equal the other rank's bit for bit and the unsharded step's (run
   on rank 0) within 1e-5 relative, the gathered first moment after step
   1 every gradient leaf within ``1e-4·max|g| + 1e-8·‖g‖``, and the
   gathered parameters after each step within
   ``tests/test_torch_train.py``'s bounds over the summed learning
   rates; (c) and (b)'s unsharded step below.  After 5f, beside phase
   7d and the drivers:
   (a) ``train_loop`` with a ``Checkpointer`` on ``(2, 1)`` for 2
   steps and its save (whole arrays: the unsharded tree's keys, shapes
   and dtypes), restored onto ``(1, 2)`` and onto the unsharded model on
   rank 0, one more step each within 1e-5 of the unsharded run's third,
   the save and restore seconds logged.  ``tree_ef_compressed_mean`` of
   the ranks' float32 gradients of their halves of the batch, counted
   (K1 once a leaf, no plain version), its means and residuals equal to
   the plain version's and every code equal (the codes that the
   reference's division would give otherwise counted), with the two wire
   formulas.  (c), run earlier: granite-moe-1b-a400m at its published
   widths and 2 of
   its 24 layers (32 experts top-8, float32, ``LMBatches`` 8 × 256, one
   step) on ``(1, 2)`` (16 experts a rank) and ``(2, 1)``: loss,
   ce_loss, load_balance_loss and grad_norm within 1e-5 of the unsharded
   step, each layer's dropped fraction (forward and recomputation) equal
   to it.  Then the same transformer-base at phase 4t's bf16
   activations, timed (ms a step against the unsharded step on rank 0,
   the FSDP bytes a step, peak memory a rank).  (b) mistral-nemo-12b at
   its published widths and 2 of its 40 layers (float32, ``LMBatches`` 8
   × 64, one step): rank 0's unsharded step in 5f's wait, the ``(1,
   2)`` step (remat on) beside the drivers, the ``(2, 1)`` ones (the
   tied table whole on each rank) last, once this process marks the
   card free, with the card to the ranks; on ``(2, 1)``, where FSDP
   gathers, the step with ``remat`` off (autograd keeps every gathered
   leaf, standing in for the removed gather of the whole tree at the
   step's start) and on; each held to the unsharded step on rank 0's own
   shard (gathering the tree through gloo's host path takes tens of
   seconds), the two to each other bit for bit on every rank, with each
   one's ms, memory at the loss, peak to the update and peak; the loss
   vocab-parallel at 65536 columns a rank on ``(1, 2)``;
4t. train → calibrate → quantize → translate (after 5e; its MoE step
   just before phase 7) — a full-width transformer-base training step
   (phase 4's weights, bf16 activations, ``AdamW(lr=warmup_cosine(2e-3,
   2, 20))``, ``TranslationBatches`` of 32 over an 800-sentence corpus):
   the step on the card against the same step on the CPU on 8 rows (loss
   within 1e-4 and gradient norm within 5e-3 relative), 20 steps on one
   batch (the loss must fall; ms a step from CUDA events, median of steps
   5-20, target tokens/s, peak memory), the same 20 steps with ``remat``
   off beside them (ms, peak, the ratio, whether the losses are the same
   bits), one step with ``accum_steps=2``
   (loss and gradient norm within 1e-5 of the mean of the two halves'
   losses and gradients, taken with ``torch.autograd`` outside the step)
   and one with ``mixed_precision`` (loss within 1e-4 and gradient norm
   within 2e-3 of the plain step's), a profiled step and the optimizer's update profiled alone (its share of
   the launches); one training step of phase 7's full-width MoE model on
   its float32 weights (loss finite, load-balance loss > 0, every leaf
   moved, the weights passed in intact; ms and peak memory); and the
   paper's Table 1 on a model trained here with
   ``benchmarks/common.py:trained_tiny_nmt``'s recipe, cut from 900 steps
   to ``tests/conftest.py:trained_nmt``'s 500 to keep the time: KL
   calibration on 60 held-out sentences, then naive, symmetric,
   independent and conjugate INT8 with static scales, greedy over 96
   sentences and beam 4 for FP and symmetric.  The loss must fall, FP
   BLEU exceed 10, K3 and K4 launch in every quantized run (K1 too where
   the thresholds are symmetric) and no plain version run; each mode's
   first decode steps' logits on 16 sentences must match those with
   ``impl="torch"``; each mode's BLEU, its drop and the paper's row are
   logged;
8. the drivers, all at once: ``python -m repro_torch.launch.serve`` once
   per mode (continuous paged, static, continuous paged with
   ``--weight-bits 4``, continuous paged beam 4 with ``--burst-len
   auto``), ``python -m repro_torch.launch.train`` for 20 steps with a
   checkpoint every 10 and then for 30 from the same directory (it must
   restore step 20), and for 10 steps of the reduced MoE model, and the
   serving driver on a ``--mesh 1,2 --backend gloo`` (two ranks on the
   card) and with ``--replicas 2``; each must exit 0;
9. launch counts of each path, and one JSON line describing each kernel
   (its launches summed over every path of phases 4-7, 4t, 5c, 5d, 5e
   and 5f (both ranks), 7b, 7c and 7d);
10. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores

MAX_LEN = 64                   # decoder self-attention cache capacity
MAX_NEW = 24
N_REQUESTS = 16
N_CALIB = 32
BEAM = 4
LOGIT_ATOL = 0.05              # kernel path vs plain path, see phase 4

SERVE_REQUESTS = 48            # phase 5: continuous serving
SERVE_SLOTS = 16
SERVE_BURST = 8
PAGE = 16                      # tokens per KV page (max_len 64: 4 pages/row)
TIGHT_PAGES = 32               # half of the contiguous-equivalent 64
INT4_GROUP = 128               # rows per INT4 scale/min block

LONG_S = 4096                  # phase 3: a long decode cache (K4, K5)
# phase 3: K1 at phase 5g's float32 gradient leaves (transformer-base's FFN
# weight and tied table), the compressor's shapes
GRAD_SHAPES = ((512, 2048), (37000, 512))

MOE_ARCH = "granite-moe-1b-a400m"
# phase 7 runs the published widths at 2 of the 24 layers: the time the
# full depth took (every kernel shape is a width's) went to phases 7b and
# 5e
MOE_LAYERS = 2
# the longest prompt (46 tokens) plus 24 new tokens must fit the cache
MOE_MAX_LEN = 80
DENSE_ARCH = "mistral-nemo-12b"
# phase 7b runs the published widths at 4 of the 40 layers: the time the
# full depth took (every kernel shape is a width's) went to phases 7d and
# 5e
DENSE_LAYERS = 4


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"== {name} (at {time.perf_counter() - T_START:.1f} s)")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device milliseconds per call of ``fn``.

    The timed launches queue up behind a sleeping kernel, so the GPU runs
    them back to back and the host's launch overhead stays outside the
    window between the two events.  The sleep is lengthened until it
    outlasts the host's enqueueing, at most three times: a function that
    launches more kernels than the launch queue holds (the plain paged
    version, about 30 per call) blocks the host until the sleep ends, however
    long it is.  Such a function is timed without the sleep, its launch gaps
    included, and the log says so.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep_end = torch.cuda.Event(enable_timing=True)
        sleep_start = torch.cuda.Event(enable_timing=True)
        sleep_start.record()
        torch.cuda._sleep(cycles)
        sleep_end.record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * sleep_start.elapsed_time(sleep_end):
            return start.elapsed_time(end) / iters
        cycles *= 4
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    log("  (timed without the sleep: the host could not run ahead of the "
        "card, so launch gaps are included)")
    return start.elapsed_time(end) / iters


L2_BYTES = 50 * 2 ** 20        # H100 L2 cache
COLD_ITERS = 200               # timed calls: two launches each stay queued


def cold_ms(fn, w, other_bytes: int = 0) -> float:
    """Device milliseconds per call of ``fn(w_i)`` over rotating copies of
    the weights ``w`` (a tensor, or a tuple of tensors such as a KV cache),
    enough that more than twice the L2 (50 MB) passes between two uses of
    one copy: the weights are read cold, as on the real path, which streams
    every layer's weights once per step.  One warm-up pass touches every
    copy; then at most ``COLD_ITERS`` calls are timed, each on a copy last
    used a whole pass earlier, so that small weights (hundreds of copies) do
    not overflow the launch queue behind the sleep."""
    ws = w if isinstance(w, tuple) else (w,)
    per_call = sum(t.numel() * t.element_size() for t in ws) + other_bytes
    n = math.ceil(2 * L2_BYTES / per_call) + 1
    copies = [tuple(t.clone() for t in ws) if isinstance(w, tuple)
              else w.clone() for _ in range(n)]
    it = itertools.cycle(copies)
    ms = time_ms(lambda: fn(next(it)), iters=min(n, COLD_ITERS), warmup=n)
    del copies
    return ms


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def moe_expert_rows(cfg, tokens: int) -> int:
    """K7's rows per expert for a forward pass over ``tokens`` tokens: the
    groups times the per-group capacity (``models/moe.py:moe_ffn``)."""
    m = cfg.moe
    g = min(m.group_size, tokens)
    c = max(math.ceil(g * m.top_k / m.n_experts * m.capacity_factor), 4)
    return -(-tokens // g) * c


def path_dims():
    """(s_enc, s_moe, moe_cfg): the enc-dec sources' and the MoE prompts'
    padded lengths, and the MoE model's config, as the paths build them."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_corpus, pad_batch
    corpus = make_corpus(N_REQUESTS + N_CALIB, get_config(
        "transformer-base").vocab, seed=11)
    s_enc = pad_batch([s.src for s in corpus[:N_REQUESTS]])[0].shape[1]
    moe_cfg = get_config(MOE_ARCH)
    s_moe = moe_prompts(moe_cfg.vocab)[0]["tokens"].shape[1]
    return s_enc, s_moe, moe_cfg


def quantizer_shapes(s_enc: int, s_moe: int, moe_cfg):
    """K1's and K2's (M, K) on the paths: the enc-dec linears' inputs
    (greedy and beam-4 decode, prefill; d_model 512 and d_ff 2048), the MoE
    linears' (d_model 1024 at greedy and beam-4 decode and prefill), and
    the MoE expert inputs, E·rows an expert (gate/up d_model wide at every
    forward pass, down d_ff wide at the decode steps)."""
    rows_m = (N_REQUESTS, N_REQUESTS * BEAM, N_REQUESTS * s_enc)
    moe_m = (N_REQUESTS, N_REQUESTS * BEAM, N_REQUESTS * s_moe,
             N_REQUESTS * BEAM * s_moe)
    E = moe_cfg.moe.n_experts
    experts = [E * moe_expert_rows(moe_cfg, t) for t in moe_m]
    return ([(M, K) for M in rows_m for K in (512, 2048)]
            + [(M, moe_cfg.d_model) for M in moe_m]
            + [(M, moe_cfg.d_model) for M in experts]
            + [(M, moe_cfg.d_ff) for M in experts[:2]])


def check_kernels(s_enc: int, s_moe: int, moe_cfg):
    """Each kernel against its plain version at the shapes the enc-dec
    path (sources padded to ``s_enc``) and the MoE path (prompts padded to
    ``s_moe``, ``moe_cfg``) give it."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_paged_cuda)
    from repro_torch.kernels.decode_attention import all_plans
    from repro_torch.kernels.decode_attention import plan as attention_plan
    from repro_torch.core import quantize_block
    from repro_torch.kernels.int4_matmul import int4_matmul_cuda
    from repro_torch.kernels.int4_matmul import plan as plan4
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_accumulate_cuda, int8_matmul_batched_cuda,
        int8_matmul_cuda, int8_matmul_epilogue_cuda, plan)
    from repro_torch.kernels.quantize import (is_aligned,
                                              plan as quant_plan,
                                              quantize_rowwise_cuda,
                                              quantize_static_cuda)
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.kv_cache import linearize_pages

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def row(name, shape, err, ms, plain_ms, bound_ms, bound_by, library_ms):
        log(f"kernel {name} shape={shape} max_abs_err={err:.3g} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) library_ms="
            + ("null" if library_ms is None else f"{library_ms:.4f}"))
        return dict(shape=shape, max_abs_err=float(err), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)

    rows_m = (N_REQUESTS, N_REQUESTS * BEAM, N_REQUESTS * s_enc)
    # the MoE path's rows: greedy and beam-4 decode steps and prefills
    moe_m = (N_REQUESTS, N_REQUESTS * BEAM, N_REQUESTS * s_moe,
             N_REQUESTS * BEAM * s_moe)
    d_moe = moe_cfg.d_model
    d_kv = moe_cfg.n_kv_heads * moe_cfg.hd
    # phase 4t's Table 1: its rows, d_model and d_ff
    t1_m = table1_rows()
    t1_d, t1_ff = TABLE1_DIMS["d_model"], TABLE1_DIMS["d_ff"]
    t1_gemms = [(M, K, N) for M in t1_m
                for K, N in ((t1_d, t1_d), (t1_d, t1_ff), (t1_ff, t1_d))]
    # phase 7b's dense model: its quantizer inputs, linears and attention
    from repro_torch.configs import get_config
    dense_cfg = get_config(DENSE_ARCH)
    s_dense = moe_prompts(dense_cfg.vocab)[0]["tokens"].shape[1]
    d_quant, d_gemms, d_attn = dense_kernel_shapes(s_dense, dense_cfg)
    # phase 7d's: zamba2's Mamba2 in-projection (d_model -> 2 d_inner + 2
    # state + heads, an N that is no multiple of 64), xlstm's sLSTM
    # in-projection (d_model -> 4 · 2 d_model), both at 16 rows, and
    # zamba2's shared attention (32 heads of 80 over 32, capacity
    # MOE_MAX_LEN)
    z_cfg, x_cfg = (get_config(a) for a in RECURRENT_ARCHS)
    z_inner = z_cfg.ssm.expand * z_cfg.d_model
    r_gemms = [(N_REQUESTS, z_cfg.d_model, 2 * z_inner + 2 * z_cfg.ssm.state
                + z_inner // z_cfg.ssm.head_dim),
               (N_REQUESTS, x_cfg.d_model, 8 * x_cfg.d_model)]
    r_attn = (N_REQUESTS, MOE_MAX_LEN, z_cfg.n_heads, z_cfg.n_kv_heads,
              z_cfg.hd)

    # K1 / K2: exact int8 codes (and bit-equal K2 scales) at every path's
    # shapes (quantizer_shapes, Table 1's and the dense path's: a 14336-wide
    # bf16 row at the down site), with an empty kernel's time
    # beside them
    # (torch's sleep for 0 cycles): at the decode shapes a launch is most
    # of the time.  "cold" rotates the input past the L2 (the prefill and
    # expert shapes).
    empty_ms = time_ms(lambda: torch.cuda._sleep(0))
    log(f"empty kernel: {empty_ms:.4f} ms a launch (time_ms)")
    for M, K in (quantizer_shapes(s_enc, s_moe, moe_cfg)
                 + [(M, K) for M in t1_m for K in (t1_d, t1_ff)] + d_quant):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        amax = float(x.float().abs().max()) * 0.7
        tile = quant_plan(M, K, x.dtype, is_aligned(x))
        q = quantize_static_cuda(x, amax)
        err = (q.int() - ref.ref_quantize_static(x, amax).int()).abs().max()
        if err:
            raise AssertionError(f"quantize_static codes differ at "
                                 f"{(M, K)}: {int(err)}")
        b, o = bound(M * K * 3, M * K * 4, F32_FLOPS_PER_S)
        r = row("quantize_static", [M, K], float(err),
                time_ms(lambda: quantize_static_cuda(x, amax)),
                time_ms(lambda: ref.ref_quantize_static(x, amax)), b, o, None)
        r["plan"] = dataclasses.asdict(tile.static)
        r["empty_ms"] = empty_ms
        if M >= N_REQUESTS * s_enc:
            r["cold_ms"] = cold_ms(lambda xi: quantize_static_cuda(xi, amax),
                                   x, M * K)
            log(f"  cold_ms={r['cold_ms']:.4f} plan={r['plan']}")
        results.setdefault("quantize_static", []).append(r)

        q, sc = quantize_rowwise_cuda(x)
        rq, rsc = ref.ref_quantize_rowwise(x)
        err = max(float((q.int() - rq.int()).abs().max()),
                  float((sc - rsc).abs().max()))
        if err:
            raise AssertionError(f"quantize_rowwise differs at {(M, K)}: "
                                 f"{err}")
        b, o = bound(M * K * 3 + M * 4, M * K * 5, F32_FLOPS_PER_S)
        r = row("quantize_rowwise", [M, K], err,
                time_ms(lambda: quantize_rowwise_cuda(x)),
                time_ms(lambda: ref.ref_quantize_rowwise(x)), b, o, None)
        r["plan"] = dataclasses.asdict(tile.rowwise)
        r["empty_ms"] = empty_ms
        if M >= N_REQUESTS * s_enc:
            r["cold_ms"] = cold_ms(quantize_rowwise_cuda, x, M * K + M * 4)
            log(f"  cold_ms={r['cold_ms']:.4f} plan={r['plan']}")
        results.setdefault("quantize_rowwise", []).append(r)

    # K1 at phase 5g's gradient leaves: float32 at transformer-base's FFN
    # weight (512 × 2048) and its tied table (37000 × 512), the threshold
    # the leaf's own max, as the compressor takes it; cold rotates the
    # input past the L2
    for M, K in GRAD_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev)
        amax = float(x.abs().max())
        tile = quant_plan(M, K, x.dtype, is_aligned(x))
        q = quantize_static_cuda(x, amax)
        err = (q.int() - ref.ref_quantize_static(x, amax).int()).abs().max()
        if err:
            raise AssertionError(f"quantize_static codes differ at float32 "
                                 f"{(M, K)}: {int(err)}")
        b, o = bound(M * K * 5, M * K * 4, F32_FLOPS_PER_S)
        r = row("quantize_static", [M, K], float(err),
                time_ms(lambda: quantize_static_cuda(x, amax)),
                time_ms(lambda: ref.ref_quantize_static(x, amax)), b, o, None)
        r.update(dtype="float32", plan=dataclasses.asdict(tile.static),
                 empty_ms=empty_ms,
                 cold_ms=cold_ms(lambda xi: quantize_static_cuda(xi, amax),
                                 x, M * K))
        log(f"  float32 cold_ms={r['cold_ms']:.4f} plan={r['plan']}")
        results["quantize_static"].append(r)

    # K3: exact s32 accumulator; f32 and bf16 outputs equal to the plain
    # version bit for bit (the same accumulator, the epilogue in the
    # reference's op order, one rounding to bf16), also with a nonzero
    # activation zero point (acc - zp·colsum, the affine modes of Table 1)
    # under a per-row and a per-tensor scale.  The MoE path's q and o are
    # d_model -> d_model, its k and v d_model -> n_kv_heads · hd; then
    # Table 1's linears and the dense path's (q 5120 -> 4096, k and v
    # -> 1024, gate and up -> 14336, o 4096 -> 5120, down 14336 -> 5120, at
    # 16 and 736 rows); the last shapes reach both tile configurations and
    # the split of K (kernels/int8_matmul.py:plan).  Library: torch._int_mm
    # without the epilogue, M padded to 17 where it wants more than 16 rows.
    # No cold time at Table 1's shapes: that model's weights (under 1 MB)
    # stay in the L2 on its path.
    # Phase 5e's two ranks run transformer-base's column-parallel linears
    # at half their N (q, k, v 512 -> 256, FFN in 512 -> 1024) and its
    # row-parallel ones at half their K (o 256 -> 512, FFN out 1024 ->
    # 512) through K3's two halves, at 16 slots and a prefill's rows.
    tp_gemms = [(M, K, N) for M in (SERVE_SLOTS, N_REQUESTS * s_enc)
                for K, N in ((512, 256), (512, 1024), (256, 512),
                             (1024, 512))]
    # Phase 5f's ranks run mistral-nemo-12b's column-parallel linears at
    # half their N (q 5120 -> 2048, k and v -> 512, gate and up -> 7168)
    # fused, and its row-parallel o (2048 -> 5120) and down (7168 -> 5120)
    # through the two halves, at the decode's 16 rows
    dtp_col, dtp_row = tp_dense_gemms(dense_cfg)
    tp_gemms += dtp_row
    for M, K, N in ([(M, K, N) for M in rows_m
                     for K, N in ((512, 512), (512, 2048), (2048, 512))]
                    + [(M, d_moe, N) for M in moe_m for N in (d_moe, d_kv)]
                    + t1_gemms + d_gemms + r_gemms + tp_gemms + dtp_col
                    + [(M, K, 512) for M in (1, 17, 65)
                       for K in (1024, 2048)]):
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        a_scale = torch.rand((M, 1), generator=gen, device=dev) * 0.02
        b_scale = torch.rand((1, N), generator=gen, device=dev) * 0.02
        bias = torch.randn((N,), generator=gen, device=dev)
        ones_a = torch.ones((1, 1), device=dev)
        ones_b = torch.ones((1, N), device=dev)
        acc = int8_matmul_cuda(a, ones_a, w, ones_b)
        exact = torch.matmul(a.double(), w.double())
        if not torch.equal(acc.double(), exact.float().double()):
            raise AssertionError(f"int8_matmul accumulator differs at "
                                 f"{(M, K, N)}")
        zp = float(torch.rand((), generator=gen, device=dev)) * 200 - 100
        # K3's two halves (a product split on K across ranks): the s32
        # accumulator alone, exact and equal to its plain version, and the
        # epilogue alone on it, equal bit for bit to fused K3 and to its
        # plain version, also with a calibrated scale given by value
        acc_split = int8_matmul_accumulate_cuda(a, w)
        if not (torch.equal(acc_split.double(), exact) and torch.equal(
                acc_split, ref.ref_int8_matmul_accumulate(a, w))):
            raise AssertionError(f"int8_matmul_accumulate differs at "
                                 f"{(M, K, N)}")
        colsum = w.to(torch.int32).sum(dim=0).to(torch.float32)
        for dt, scale, z in itertools.product(
                (torch.float32, torch.bfloat16),
                (a_scale, a_scale[:1], float(a_scale[0, 0])), (None, zp)):
            got = int8_matmul_cuda(a, scale, w, b_scale, z, bias,
                                   out_dtype=dt)
            want = ref.ref_int8_matmul(a, scale, w, b_scale, z, bias,
                                       out_dtype=dt)
            cs = None if z is None else colsum
            split = int8_matmul_epilogue_cuda(acc_split, scale, b_scale, z,
                                              cs, bias, out_dtype=dt)
            plain = ref.ref_int8_matmul_epilogue(acc_split, scale, b_scale,
                                                 z, cs, bias, out_dtype=dt)
            for what, x in (("int8_matmul", want),
                            ("int8_matmul_epilogue", split),
                            ("ref_int8_matmul_epilogue", plain)):
                if not torch.equal(got, x):
                    raise AssertionError(
                        f"{what} {dt} (scale "
                        f"{getattr(scale, 'shape', 'by value')}, zp {z}) "
                        f"differs from fused K3 at {(M, K, N)} by "
                        f"{float((got.float() - x.float()).abs().max())}")
        run = lambda wi=w: int8_matmul_cuda(a, a_scale, wi, b_scale, None,
                                            bias, out_dtype=torch.bfloat16)
        a_lib = torch.nn.functional.pad(a, (0, 0, 0, max(0, 17 - M)))
        lib_ms = time_ms(lambda: torch._int_mm(a_lib, w))
        b, o = bound(M * K + K * N + M * 4 + N * 8 + M * N * 2,
                     2 * M * N * K, INT8_OPS_PER_S)
        r = row("int8_matmul", [M, K, N], 0.0, time_ms(run),
                time_ms(lambda: ref.ref_int8_matmul(
                    a, a_scale, w, b_scale, None, bias,
                    out_dtype=torch.bfloat16)), b, o, lib_ms)
        r["tile"] = dataclasses.asdict(plan(1, M, N, K))
        if (M, K, N) not in t1_gemms:
            r["cold_ms"] = cold_ms(run, w, M * K + M * N * 2)
        log(f"  cold_ms={r.get('cold_ms', 'n/a')} tile={r['tile']}")
        results.setdefault("int8_matmul", []).append(r)
        if (M, K, N) in tp_gemms:
            b, o = bound(M * K + K * N + M * N * 4, 2 * M * N * K,
                         INT8_OPS_PER_S)
            results.setdefault("int8_matmul_accumulate", []).append(row(
                "int8_matmul_accumulate", [M, K, N], 0.0,
                time_ms(lambda: int8_matmul_accumulate_cuda(a, w)),
                time_ms(lambda: ref.ref_int8_matmul_accumulate(a, w)), b, o,
                lib_ms))
            # s32 in, bf16 out, the row scales, b_scale and bias read once;
            # three float operations an element
            b, o = bound(M * N * 6 + M * 4 + N * 8, 3 * M * N,
                         F32_FLOPS_PER_S)
            results.setdefault("int8_matmul_epilogue", []).append(row(
                "int8_matmul_epilogue", [M, K, N], 0.0,
                time_ms(lambda: int8_matmul_epilogue_cuda(
                    acc_split, a_scale, b_scale, None, None, bias,
                    out_dtype=torch.bfloat16)),
                time_ms(lambda: ref.ref_int8_matmul_epilogue(
                    acc_split, a_scale, b_scale, None, None, bias,
                    out_dtype=torch.bfloat16)), b, o, None))

    # K7: the grouped expert GEMM of the MoE FFN at granite-moe's shapes:
    # 32 experts, gate/up 1024 -> 512 and down 512 -> 1024, at the rows
    # per expert of the MoE path's forward passes (moe_m: 5, 20, 230 and
    # 3 groups × 320 = 960); f32 and bf16 must equal the plain version bit
    # for bit (the same exact accumulator, the same two rounded products
    # and one rounding to bf16).  Library: one torch._int_mm per expert
    # (no epilogue; M padded to 17 where _int_mm wants M > 16).
    # Phase 5f's ranks hold E / TP = 16 experts each at the greedy and
    # beam-4 decode's rows (5 and 20 an expert).
    E_all = moe_cfg.moe.n_experts
    k7_shapes = ([(E_all, moe_expert_rows(moe_cfg, t)) for t in moe_m]
                 + [(E_all // TP, moe_expert_rows(moe_cfg, t))
                    for t in moe_m[:2]])
    for E, M in k7_shapes:
        for K, N in ((d_moe, moe_cfg.d_ff), (moe_cfg.d_ff, d_moe)):
            a = torch.randint(-127, 128, (E, M, K), generator=gen,
                              device=dev, dtype=torch.int8)
            w = torch.randint(-127, 128, (E, K, N), generator=gen,
                              device=dev, dtype=torch.int8)
            a_scale = torch.rand((E, M, 1), generator=gen, device=dev) * 0.02
            b_scale = torch.rand((E, 1, N), generator=gen, device=dev) * 0.02
            for scale in (a_scale, 0.0123):
                for dt in (torch.float32, torch.bfloat16):
                    got = int8_matmul_batched_cuda(a, scale, w, b_scale,
                                                   out_dtype=dt)
                    want = ref.ref_int8_matmul_batched(a, scale, w, b_scale,
                                                       out_dtype=dt)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"int8_matmul_batched {dt} differs at "
                            f"{(E, M, K, N)} by "
                            f"{float((got.float() - want.float()).abs().max())}")
            run = lambda wi=w: int8_matmul_batched_cuda(
                a, a_scale, wi, b_scale, out_dtype=torch.bfloat16)
            a_lib = a if M > 16 else torch.nn.functional.pad(
                a, (0, 0, 0, 17 - M))
            # E launches a call: ten calls keep the launch queue short
            # enough to stay behind the sleep
            lib_ms = time_ms(lambda: [torch._int_mm(a_lib[e], w[e])
                                      for e in range(E)], iters=10)
            b, o = bound(E * (M * K + K * N + M * 4 + N * 4 + M * N * 2),
                         2 * E * M * N * K, INT8_OPS_PER_S)
            r = row("int8_matmul_batched", [E, M, K, N], 0.0, time_ms(run),
                    time_ms(lambda: ref.ref_int8_matmul_batched(
                        a, a_scale, w, b_scale, out_dtype=torch.bfloat16)),
                    b, o, lib_ms)
            r["cold_ms"] = cold_ms(run, w, a.numel() + E * M * N * 2)
            r["tile"] = dataclasses.asdict(plan(E, M, N, K))
            log(f"  cold_ms={r['cold_ms']:.4f} tile={r['tile']}")
            results.setdefault("int8_matmul_batched", []).append(r)

    # K6: the INT4-weight matmul at the decode shapes of the INT4 sites
    # (group 128, f16 scales), then shapes that reach each tile (16, 32, 64
    # rows), split at group boundaries and unsplit (kernels/int4_matmul.py:
    # plan), one with f32 scales; f32 and bf16 must equal the plain version
    # bit for bit (the same exact group sums, combined in ascending groups
    # with the same rounded ops, one rounding to bf16).  "cold" rotates the
    # packed weights (the scales and mins, a sixteenth of the bytes, stay
    # warm).
    # No PyTorch call takes s8 activation codes with INT4 weights
    # (``torch._weight_int4pack_mm`` takes bf16 activations): library null.
    k3_ms = {tuple(r["shape"]): r["ms"] for r in results["int8_matmul"]}
    for M, K, N, sdt in ([(M, K, N, torch.float16)
                          for M in (N_REQUESTS, N_REQUESTS * BEAM)
                          for K, N in ((512, 512), (512, 2048), (2048, 512))]
                         + [(1, 1024, 512, torch.float16),
                            (17, 2048, 512, torch.float16),
                            (65, 2048, 512, torch.float32),
                            (N_REQUESTS * s_enc, 512, 2048, torch.float16)]):
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.05
        bq = quantize_block(w, INT4_GROUP, scale_dtype=sdt)
        a_scale = torch.rand((M, 1), generator=gen, device=dev) * 0.02
        bias = torch.randn((N,), generator=gen, device=dev)
        args = (a, a_scale, bq.data, bq.scale, bq.vmin, None, bias)
        for dt in (torch.float32, torch.bfloat16):
            got = int4_matmul_cuda(*args, group_size=INT4_GROUP, out_dtype=dt)
            want = ref.ref_int4_matmul(*args, group_size=INT4_GROUP,
                                       out_dtype=dt)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int4_matmul {dt} differs at {(M, K, N)} by "
                    f"{float((got.float() - want.float()).abs().max())}")
        run = lambda wi=bq.data: int4_matmul_cuda(
            a, a_scale, wi, bq.scale, bq.vmin, None, bias,
            group_size=INT4_GROUP, out_dtype=torch.bfloat16)
        n_g = K // INT4_GROUP
        b, o = bound(M * K + K * N // 2 + 2 * n_g * N * bq.scale.element_size()
                     + M * 4 + N * 4 + M * N * 2, 2 * M * N * K,
                     INT8_OPS_PER_S)
        r = row("int4_matmul", [M, K, N], 0.0, time_ms(run),
                time_ms(lambda: ref.ref_int4_matmul(
                    *args, group_size=INT4_GROUP,
                    out_dtype=torch.bfloat16)), b, o, None)
        r["cold_ms"] = cold_ms(run, bq.data, M * K + M * N * 2)
        r["tile"] = dataclasses.asdict(plan4(M, N, K, INT4_GROUP))
        r["k3_ms"] = k3_ms[(M, K, N)]
        r["scale_dtype"] = str(sdt).replace("torch.", "")
        log(f"  cold_ms={r['cold_ms']:.4f} tile={r['tile']} "
            f"scales={r['scale_dtype']}; K3 at the same shape: "
            f"{r['k3_ms']:.4f} ms")
        results.setdefault("int4_matmul", []).append(r)

    # K4: flash decode vs masked softmax over the dequantized cache, at the
    # enc-dec decoder's shapes (8 heads, capacity 64), Table 1's (4 heads of
    # 32, capacity TABLE1_MAX_LEN), the MoE path's (16 heads over 8 KV
    # heads, capacity MOE_MAX_LEN) and the dense path's (32 heads of 128
    # over 8, capacity MOE_MAX_LEN), phase 7d's zamba2 (32 heads of 80 over
    # 32, capacity MOE_MAX_LEN), then a long cache
    # (LONG_S positions, lengths drawn in [1, LONG_S]) that the plan splits
    # over a cluster.  f32 within 1e-5 and bf16 within one bf16 ulp of the
    # plain version; under every forced plan (kernels/decode_attention.py:
    # all_plans) the same bits as under the plan; a row the same bits
    # alone and among 16; "cold" rotates the caches past the L2.
    H = HKV = 8
    dh = 64
    t1_h = TABLE1_DIMS["n_heads"]
    for B, S, H_, HKV_, dh_ in (
            [(B, MAX_LEN, H, HKV, dh) for B in (N_REQUESTS, N_REQUESTS * BEAM)]
            + [(B, TABLE1_MAX_LEN, t1_h, t1_h, TABLE1_DIMS["head_dim"])
               for B in t1_m[:2]]
            + [(B, MOE_MAX_LEN, moe_cfg.n_heads, moe_cfg.n_kv_heads, dh)
               for B in (N_REQUESTS, N_REQUESTS * BEAM)]
            + [d_attn, r_attn]
            + [(N_REQUESTS, LONG_S, moe_cfg.n_heads, moe_cfg.n_kv_heads,
                dh)]):
        kq = torch.randint(-127, 128, (B, S, HKV_, dh_), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, S, HKV_, dh_), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, S, HKV_), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, S, HKV_), generator=gen, device=dev) * 0.02
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
        qf = torch.randn((B, H_, dh_), generator=gen, device=dev)
        sm = 1.0 / dh_ ** 0.5
        shape = [B, S, H_, HKV_, dh_]
        cache = (kq, ks, vq, vs)
        tile = attention_plan(B, S, HKV_, H_ // HKV_, dh_)
        errs = []
        for q in (qf, qf.to(torch.bfloat16)):
            out = decode_attention_cuda(q, kq, ks, vq, vs, lengths,
                                        sm_scale=sm)
            out_ref = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, sm)
            err = float((out.float() - out_ref.float()).abs().max())
            # f32: 1e-5; bf16 output: one bf16 ulp (2^-8 relative) either way
            rtol = 1e-5 if q.dtype == torch.float32 else 2.0 ** -7
            if not torch.allclose(out.float(), out_ref.float(), atol=1e-5,
                                  rtol=rtol):
                raise AssertionError(f"decode_attention {q.dtype} err {err} "
                                     f"at {shape}")
            errs.append(err)
            for p in all_plans(S):
                got = decode_attention_cuda(q, kq, ks, vq, vs, lengths,
                                            sm_scale=sm, tile=p)
                if not torch.equal(got, out):
                    raise AssertionError(f"decode_attention {q.dtype} at "
                                         f"{shape}: {p} differs from {tile}")
            for rows in (slice(0, 1), slice(0, min(B, N_REQUESTS))):
                got = decode_attention_cuda(q[rows], kq[rows], ks[rows],
                                            vq[rows], vs[rows],
                                            lengths[rows], sm_scale=sm)
                if not torch.equal(got, out[rows]):
                    raise AssertionError(f"decode_attention {q.dtype} at "
                                         f"{shape}: rows {rows} alone differ "
                                         f"from the batch of {B}")
        q = qf.to(torch.bfloat16)
        run = lambda c=cache, tile=None: decode_attention_cuda(
            q, c[0], c[1], c[2], c[3], lengths, sm_scale=sm, tile=tile)
        tokens = int(lengths.sum())
        b, o = bound(tokens * HKV_ * (2 * dh_ + 8) + 2 * B * H_ * dh_ * 2
                     + 4 * B, 4 * tokens * H_ * dh_, F32_FLOPS_PER_S)
        r = row("decode_attention", shape, max(errs), time_ms(run),
                time_ms(lambda: ref.ref_decode_attention(q, kq, ks, vq, vs,
                                                         lengths, sm)),
                b, o, None)
        r["cold_ms"] = cold_ms(run, cache, 2 * B * H_ * dh_ * 2)
        r["plan"] = dataclasses.asdict(tile)
        r["plans_ms"] = {f"{p.split}x{p.warps}": time_ms(
            lambda p=p: run(tile=p)) for p in all_plans(S)}
        log(f"  cold_ms={r['cold_ms']:.4f} plan={r['plan']} every plan "
            f"(split x warps, ms; same bits, and a row alone and among "
            f"{min(B, N_REQUESTS)} the same bits): "
            + " ".join(f"{k}:{v:.4f}" for k, v in r["plans_ms"].items()))
        results.setdefault("decode_attention", []).append(r)

    # K5: paged flash decode vs the plain version, and vs K4 on the
    # linearized cache (bit for bit, under every forced plan), at the serve
    # shapes (page size 16, 4 pages a row, a pool of B·4 pages handed out
    # shuffled, sentinels past each row's reservation), zamba2's attention
    # (head dim 80, 5 pages a row) and a long cache of LONG_S // PAGE pages
    # a row with the MoE heads
    for B, maxP, H_, HKV_, dh_ in (
            (SERVE_SLOTS, MAX_LEN // PAGE, H, HKV, dh),
            (SERVE_SLOTS * 4, MAX_LEN // PAGE, H, HKV, dh),
            (SERVE_SLOTS, MAX_LEN // PAGE, H, 4, dh),
            (SERVE_SLOTS, MOE_MAX_LEN // PAGE, *r_attn[2:]),
            (SERVE_SLOTS, LONG_S // PAGE, moe_cfg.n_heads,
             moe_cfg.n_kv_heads, dh)):
        S = maxP * PAGE
        P = B * maxP
        cpu = torch.Generator().manual_seed(B + HKV_ + maxP)
        perm = torch.randperm(P, generator=cpu).int()
        reserve = torch.randint(1, maxP + 1, (B,), generator=cpu)
        reserve[1] = maxP                  # row 1 holds the full capacity
        tables = torch.full((B, maxP), P, dtype=torch.int32)
        for i in range(B):
            n = int(reserve[i])
            tables[i, :n] = perm[i * maxP:i * maxP + n]
        lengths = torch.minimum(torch.randint(1, S + 1, (B,), generator=cpu),
                                reserve * PAGE)
        lengths[0], lengths[1] = 1, S
        tables, lengths = tables.to(dev), lengths.to(torch.int32).to(dev)
        kq = torch.randint(-127, 128, (P, PAGE, HKV_, dh_), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (P, PAGE, HKV_, dh_), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((P, PAGE, HKV_), generator=gen, device=dev) * 0.02
        vs = torch.rand((P, PAGE, HKV_), generator=gen, device=dev) * 0.02
        qf = torch.randn((B, H_, dh_), generator=gen, device=dev)
        sm = 1.0 / dh_ ** 0.5
        lin = lambda a: linearize_pages(a, tables).contiguous()
        lin_cache = (lin(kq), lin(ks), lin(vq), lin(vs))
        cache = (kq, ks, vq, vs)
        tile = attention_plan(B, S, HKV_, H_ // HKV_, dh_)
        errs = []
        for q in (qf, qf.to(torch.bfloat16)):
            out = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables,
                                              lengths, sm_scale=sm)
            out_ref = ref.ref_decode_attention_paged(q, kq, ks, vq, vs,
                                                     tables, lengths, sm)
            err = float((out.float() - out_ref.float()).abs().max())
            # f32: 1e-5; bf16 output: one bf16 ulp (2^-8 relative) either way
            rtol = 1e-5 if q.dtype == torch.float32 else 2.0 ** -7
            if not torch.allclose(out.float(), out_ref.float(), atol=1e-5,
                                  rtol=rtol):
                raise AssertionError(f"decode_attention_paged {q.dtype} err "
                                     f"{err} at B={B}, HKV={HKV_}, "
                                     f"maxP={maxP}")
            for p in all_plans(S):
                got = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables,
                                                  lengths, sm_scale=sm,
                                                  tile=p)
                k4 = decode_attention_cuda(q, *lin_cache, lengths,
                                           sm_scale=sm, tile=p)
                if not (torch.equal(got, out) and torch.equal(k4, out)):
                    raise AssertionError(
                        f"decode_attention_paged ({q.dtype}, B={B}, "
                        f"HKV={HKV_}, maxP={maxP}, {p}): differs from K5 "
                        f"under {tile} or from K4 on the linearized cache by "
                        f"{float((k4.float() - out.float()).abs().max())}")
            errs.append(err)
        log(f"kernel decode_attention_paged B={B} HKV={HKV_} maxP={maxP}: "
            f"max |K5 - K4 on the linearized cache| = 0 under every plan "
            f"(f32 and bf16)")
        run = lambda c=cache, tile=None: decode_attention_paged_cuda(
            q, c[0], c[1], c[2], c[3], tables, lengths, sm_scale=sm,
            tile=tile)
        tokens = int(lengths.sum())
        b, o = bound(tokens * HKV_ * (2 * dh_ + 8) + B * maxP * 4
                     + 2 * B * H_ * dh_ * 2, 4 * tokens * H_ * dh_,
                     F32_FLOPS_PER_S)
        r = row("decode_attention_paged", [B, P, PAGE, HKV_, dh_], max(errs),
                time_ms(run),
                time_ms(lambda: ref.ref_decode_attention_paged(
                    q, kq, ks, vq, vs, tables, lengths, sm)),
                b, o, None)
        r["cold_ms"] = cold_ms(run, cache, 2 * B * H_ * dh_ * 2)
        r["plan"] = dataclasses.asdict(tile)
        r["plans_ms"] = {f"{p.split}x{p.warps}": time_ms(
            lambda p=p: run(tile=p)) for p in all_plans(S)}
        r["k4_ms"] = time_ms(lambda: decode_attention_cuda(
            q, *lin_cache, lengths, sm_scale=sm))
        log(f"  cold_ms={r['cold_ms']:.4f} plan={r['plan']} K4 on the "
            f"linearized cache {r['k4_ms']:.4f} ms; every plan (split x "
            f"warps, ms): "
            + " ".join(f"{k}:{v:.4f}" for k, v in r["plans_ms"].items()))
        results.setdefault("decode_attention_paged", []).append(r)

    # K5 over block tables shared within beam groups, the state
    # kv_cache.gather_beams_paged leaves at phase 5b's grid (16 rows in
    # groups of BEAM, 4 pages of 16 a row): two reorders, each a random
    # permutation within every group, so the siblings of a group map the
    # same full pages and each row's write-slot page is its own (a copy of
    # its source's partial page).  The plain version, and K4 on the
    # linearized cache bit for bit, under every forced plan.
    B, maxP = SERVE_SLOTS, MAX_LEN // PAGE
    S, P = maxP * PAGE, SERVE_SLOTS * maxP
    cpu = torch.Generator().manual_seed(20)
    store = lambda *shape, dt: (
        torch.randint(-127, 128, shape, generator=gen, device=dev,
                      dtype=dt) if dt == torch.int8 else
        torch.rand(shape, generator=gen, device=dev) * 0.02)
    own = torch.randperm(P, generator=cpu).int().reshape(B, maxP).to(dev)
    shared = kvc.PagedKVCache(
        k_store=store(1, P + 1, PAGE, HKV, dh, dt=torch.int8),
        v_store=store(1, P + 1, PAGE, HKV, dh, dt=torch.int8),
        ks_store=store(1, P + 1, PAGE, HKV, dt=torch.float32),
        vs_store=store(1, P + 1, PAGE, HKV, dt=torch.float32),
        block_tables=own.clone(), own_pages=own,
        lengths=torch.randint(1, S - 1, (B,), generator=cpu).int().to(dev))
    for _ in range(2):
        pick = torch.randint(0, BEAM, (B,), generator=cpu)
        idx = (torch.arange(B) // BEAM * BEAM + pick).to(dev)
        shared = kvc.gather_beams_paged(shared, idx)
        shared = kvc.with_lengths(shared, shared.lengths + 1)
    tables, lengths = shared.block_tables, shared.lengths
    sibling_pages = sum(
        len(set(tables[g * BEAM:(g + 1) * BEAM].flatten().tolist()))
        for g in range(B // BEAM))
    kq, vq = shared.k[0], shared.v[0]
    ks, vs = shared.k_scale[0], shared.v_scale[0]
    qf = torch.randn((B, H, dh), generator=gen, device=dev)
    sm = 1.0 / dh ** 0.5
    lin = lambda a: linearize_pages(a, tables).contiguous()
    lin_cache = (lin(kq), lin(ks), lin(vq), lin(vs))
    errs = []
    for q in (qf, qf.to(torch.bfloat16)):
        out = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables, lengths,
                                          sm_scale=sm)
        out_ref = ref.ref_decode_attention_paged(q, kq, ks, vq, vs, tables,
                                                 lengths, sm)
        err = float((out.float() - out_ref.float()).abs().max())
        rtol = 1e-5 if q.dtype == torch.float32 else 2.0 ** -7
        if not torch.allclose(out.float(), out_ref.float(), atol=1e-5,
                              rtol=rtol):
            raise AssertionError(f"decode_attention_paged over shared "
                                 f"tables ({q.dtype}): err {err}")
        for p in all_plans(S):
            got = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables,
                                              lengths, sm_scale=sm, tile=p)
            k4 = decode_attention_cuda(q, *lin_cache, lengths, sm_scale=sm,
                                       tile=p)
            if not (torch.equal(got, out) and torch.equal(k4, out)):
                raise AssertionError(
                    f"decode_attention_paged over shared tables ({q.dtype}, "
                    f"{p}): differs from K5 under its plan or from K4 on "
                    f"the linearized cache")
        errs.append(err)
    tokens = int(lengths.sum())
    b, o = bound(tokens * HKV * (2 * dh + 8) + B * maxP * 4
                 + 2 * B * H * dh * 2, 4 * tokens * H * dh, F32_FLOPS_PER_S)
    r = row("decode_attention_paged", [B, P, PAGE, HKV, dh, "shared"],
            max(errs), time_ms(lambda: decode_attention_paged_cuda(
                q, kq, ks, vq, vs, tables, lengths, sm_scale=sm)),
            time_ms(lambda: ref.ref_decode_attention_paged(
                q, kq, ks, vq, vs, tables, lengths, sm)), b, o, None)
    log(f"  shared tables: {sibling_pages} distinct pages over "
        f"{B // BEAM} groups' {B * maxP} table entries; max |K5 - K4 on the "
        f"linearized cache| = 0 under every plan (f32 and bf16)")
    if sibling_pages >= B * maxP:
        raise AssertionError("the reorders left no page shared")
    results["decode_attention_paged"].append(r)
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def calibrate(model, params, corpus):
    """KL calibration records from the held-out sentences of ``corpus``."""
    import numpy as np
    import torch
    from repro_torch.core import Calibrator, Taps

    cal = Calibrator()
    for s in corpus[N_REQUESTS:N_REQUESTS + N_CALIB]:
        taps = Taps()
        tgt = np.concatenate([[1], s.tgt, [2]])[None, :]
        model.forward(params, {
            "src_tokens": torch.as_tensor(s.src[None, :], device="cuda"),
            "tgt_tokens": torch.as_tensor(tgt, device="cuda")}, taps=taps)
        cal.observe_taps(taps)
    return cal.compute("symmetric")


def run_main_path(model, params, corpus):
    import torch
    from repro_torch.core import QuantPolicy, quantize_model
    from repro_torch.data import pad_batch
    from repro_torch.serving import ServingEngine

    requests = corpus[:N_REQUESTS]
    src, lens = pad_batch([s.src for s in requests])
    batch = {"src_tokens": src, "src_lengths": lens}

    t0 = time.perf_counter()
    recs = calibrate(model, params, corpus)
    qparams, qctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"))
    torch.cuda.synchronize()
    n_q = sum(r.quantize for r in recs.values())
    log(f"calibrate+quantize: {time.perf_counter() - t0:.3f} s, "
        f"{n_q}/{len(recs)} calibrated sites quantizable")

    runs = {}
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN)
    runs["greedy_static"] = engine.generate(batch, max_new_tokens=MAX_NEW)
    runs["beam4_static"] = engine.generate_beam(batch, beam=BEAM,
                                                max_new_tokens=MAX_NEW)
    dparams, dctx = quantize_model(params, {},
                                   QuantPolicy(act_quant="dynamic"))
    dengine = ServingEngine(model, dparams, quant=dctx, max_len=MAX_LEN)
    runs["greedy_dynamic"] = dengine.generate(batch, max_new_tokens=MAX_NEW)
    for name, r in runs.items():
        log(f"e2e {name}: tokens={r.n_tokens} steps={r.steps} "
            f"tokens_per_s={r.tokens_per_s:.1f} prefill_s={r.prefill_s:.4f} "
            f"decode_s={r.decode_s:.4f} host_syncs={r.host_syncs}")
        if len(r.tokens) != N_REQUESTS:
            raise AssertionError(f"{name}: {len(r.tokens)} outputs")
        for t in r.tokens:
            if len(t) > MAX_NEW or (len(t) and not (
                    0 <= t.min() and t.max() < model.cfg.vocab)):
                raise AssertionError(f"{name}: bad output {t}")
    return batch, qparams, qctx, recs, runs


def warm_up(model, params, corpus) -> None:
    """Two-token runs (dynamic scales) so that library handles and caches
    exist before the timed main path; their launches are not counted."""
    from repro_torch.core import QuantPolicy, quantize_model
    from repro_torch.data import pad_batch
    from repro_torch.serving import ServingEngine

    src, lens = pad_batch([s.src for s in corpus[:N_REQUESTS]])
    batch = {"src_tokens": src, "src_lengths": lens}
    qp, ctx = quantize_model(params, {}, QuantPolicy(act_quant="dynamic"))
    engine = ServingEngine(model, qp, quant=ctx, max_len=MAX_LEN)
    engine.generate(batch, max_new_tokens=2)
    engine.generate_beam(batch, beam=BEAM, max_new_tokens=2)


def check_against_plain(model, qparams, qctx, batch, steps: int = 3, *,
                        max_len: int = MAX_LEN) -> float:
    """The first decode steps with the kernels vs with the plain versions."""
    import torch
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    ctxs = {"cuda": qctx, "torch": dataclasses.replace(qctx, impl="torch")}
    states = {k: model.init_decode_state(N_REQUESTS, max_len, quantized=True)
              for k in ctxs}
    logits = {}
    for k, ctx in ctxs.items():
        logits[k], states[k] = model.prefill(qparams, b, states[k], quant=ctx)
    worst = 0.0
    for step in range(steps + 1):
        for k in ctxs:
            if not torch.isfinite(logits[k]).all():
                raise AssertionError(f"non-finite logits ({k}, step {step})")
        err = float((logits["cuda"] - logits["torch"]).abs().max())
        log(f"logits step {step}: max |kernel - plain| = {err:.3g} "
            f"(max |logit| {float(logits['torch'].abs().max()):.3g})")
        worst = max(worst, err)
        if step == steps:
            break
        tok = torch.argmax(logits["cuda"], dim=-1).to(torch.int32)
        for k, ctx in ctxs.items():
            logits[k], states[k] = model.decode_step(qparams, tok, states[k],
                                                     quant=ctx)
    # K1-K3 and K7 are exact; K4's bf16 output may round one ulp apart, and
    # that can flip an activation code downstream: a small, bounded drift
    if worst > LOGIT_ATOL:
        raise AssertionError(f"kernel and plain logits differ by {worst}")
    return worst


def device_rows(prof):
    """[(device ms, kernel name, count)] of a finished torch.profiler run,
    largest first: device-side events only (operator rows repeat their
    kernels' time); one stream, so kernels do not overlap and their sum is
    the busy time.  The rows are summed from the profiler's raw events, as
    ``key_averages`` sums them, without the event tree it builds first
    (10-30 s a profiled generate on a slow host)."""
    from torch.autograd import DeviceType
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_hidden_event():
            ms, n = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((ms, key, n) for key, (ms, n) in sums.items()),
                  reverse=True)


def profile(label: str, fn, cpu: bool = True):
    """Device busy time of one call of ``fn``, from torch.profiler.
    ``cpu=False`` records the device only: far fewer events to gather on a
    long call, and no host-side recording in the wall time.  Returns (busy
    ms, [(device ms, kernel name, count)] largest first, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with tprofile(activities=activities) as prof:
        t0 = time.perf_counter()
        steps = fn()
        torch.cuda.synchronize()
        t_stop = time.perf_counter()
        wall_ms = (t_stop - t0) * 1e3
    t_rows = time.perf_counter()
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile {label} (profiled{'' if cpu else ', device only'}): "
        f"wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.2f} "
        f"idle_share={1 - busy_ms / wall_ms:.3f} steps={steps} (the "
        f"profiler's start {t0 - t_all:.1f} s, stop {t_rows - t_stop:.1f} "
        f"s, summary {time.perf_counter() - t_rows:.1f} s)")
    for ms, key, count in rows[:8]:
        log(f"  device {ms:8.3f} ms  x{count:<5d} {key[:70]}")
    return busy_ms, rows, wall_ms


def attention_ms(rows) -> str:
    """K1's, K2's, K4's and K5's device ms and launches in a profile's
    rows."""
    out = []
    for name, key in (("K1", "quantize_static_kernel"),
                      ("K2", "quantize_rowwise"),
                      ("K4", "decode_attention_kernel"),
                      ("K5", "decode_attention_paged_kernel")):
        ms = sum(r[0] for r in rows if key in r[1])
        n = sum(r[2] for r in rows if key in r[1])
        out.append(f"{name} {ms:.2f} ms in {n} launches")
    return ", ".join(out)


def profile_greedy(model, qparams, qctx, batch) -> None:
    from repro_torch.serving import ServingEngine
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN)
    _, rows, _ = profile("greedy_static", lambda: engine.generate(
        batch, max_new_tokens=MAX_NEW).steps)
    log(f"  {attention_ms(rows)}")


# ---------------------------------------------------------------------------
# phase 5: continuous serving over the contiguous and the paged cache
# ---------------------------------------------------------------------------

SERVE_RUNS = (          # name, engine options, fused admission
    ("contiguous", dict(paged=False), True),
    ("paged", dict(paged=True, page_size=PAGE), True),
    ("paged_tight", dict(paged=True, page_size=PAGE, n_pages=TIGHT_PAGES),
     True),
    ("paged_unfused", dict(paged=True, page_size=PAGE), False),
)


def serve_requests(vocab: int):
    import numpy as np
    from repro_torch.data import make_corpus
    corpus = make_corpus(SERVE_REQUESTS, vocab, seed=11)
    budgets = np.random.default_rng(12).integers(4, 49, SERVE_REQUESTS)
    return corpus, [int(b) for b in budgets]


def run_serving(model, qparams, qctx):
    """Serve the requests once per run of ``SERVE_RUNS``; each run's launch
    counts are read from zero.  Returns (launch counts per run, results)."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServingEngine

    corpus, budgets = serve_requests(model.cfg.vocab)
    # warm-up: library handles and caches for the serve shapes (uncounted)
    for kw in (dict(paged=False), dict(paged=True, page_size=PAGE)):
        ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                      burst_len=SERVE_BURST, **kw).serve(
            corpus[:SERVE_SLOTS + 2], n_slots=SERVE_SLOTS, max_new_tokens=2)

    # count the plain paged version's calls: on the card it must run 0 times
    plain_paged = ref.ref_decode_attention_paged
    plain_calls = []

    def counted(*args, **kwargs):
        plain_calls.append(1)
        return plain_paged(*args, **kwargs)

    ref.ref_decode_attention_paged = counted
    counts, results = {}, {}
    for name, kw, fused in SERVE_RUNS:
        engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                               burst_len=SERVE_BURST, **kw)
        del plain_calls[:]
        ops.reset_launch_counts()
        res = engine.serve(corpus, n_slots=SERVE_SLOTS,
                           max_new_tokens=budgets, fused_admission=fused)
        counts[name] = ops.launch_counts()
        results[name] = res
        m = res.metrics()
        n_pages = kw.get("n_pages", SERVE_SLOTS * MAX_LEN // PAGE)
        log(f"serve {name}: tokens={res.n_tokens} "
            f"tokens_per_s={res.tokens_per_s:.1f} "
            f"decode_steps={res.decode_steps} host_syncs={res.host_syncs} "
            f"utilization={res.utilization:.3f} "
            f"admission_rounds={res.prefill_rounds} "
            f"prefill_dispatches={res.prefill_dispatches} "
            f"first_token_mean_s={m['first_token_latency_mean_s']:.4f} "
            f"first_token_p95_s={m['first_token_latency_p95_s']:.4f} "
            f"total_mean_s={m['total_latency_mean_s']:.4f} "
            f"total_p95_s={m['total_latency_p95_s']:.4f} "
            f"peak_running={res.peak_running} page_hwm={res.page_hwm}"
            + (f"/{n_pages}" if res.paged else ""))
        log(f"  launches: {json.dumps(counts[name])}; plain paged version "
            f"calls: {len(plain_calls)}")
        if len(res.requests) != SERVE_REQUESTS or any(
                r.status != "finished" for r in res.requests):
            raise AssertionError(f"serve {name}: not every request finished")
        for r, b in zip(res.requests, budgets):
            t = np.asarray(r.tokens)
            if len(t) > b or (len(t) and not (
                    0 <= t.min() and t.max() < model.cfg.vocab)):
                raise AssertionError(f"serve {name}: bad output {t}")
        paged_launches = counts[name]["decode_attention_paged"]
        if res.paged:
            if res.pages_in_use != 0 or not 0 < res.page_hwm <= n_pages:
                raise AssertionError(
                    f"serve {name}: pages_in_use={res.pages_in_use}, "
                    f"page_hwm={res.page_hwm} of {n_pages}")
            if paged_launches <= 0 or plain_calls:
                raise AssertionError(
                    f"serve {name}: K5 launched {paged_launches} times, its "
                    f"plain version {len(plain_calls)} times")
        elif paged_launches or counts[name]["decode_attention"] <= 0:
            raise AssertionError(f"serve {name}: launches {counts[name]}")
    ref.ref_decode_attention_paged = plain_paged

    toks = {name: [list(r.tokens) for r in res.requests]
            for name, res in results.items()}
    if toks["paged"] != toks["contiguous"]:
        bad = sum(a != b for a, b in zip(toks["paged"], toks["contiguous"]))
        raise AssertionError(f"paged and contiguous serving differ on {bad} "
                             f"of {SERVE_REQUESTS} requests")
    agree = lambda a, b: sum(x == y for x, y in zip(toks[a], toks[b]))
    log(f"serve agreement (of {SERVE_REQUESTS} requests): paged == "
        f"contiguous {agree('paged', 'contiguous')}, tight pool == "
        f"contiguous {agree('paged_tight', 'contiguous')}, fused == unfused "
        f"{agree('paged', 'paged_unfused')}")
    return counts, results, toks


GENERATE_CHECKS = 6            # served requests run again alone


def serve_vs_generate(model, qparams, qctx, toks) -> None:
    """Per-request ``generate`` of the first ``GENERATE_CHECKS`` served
    requests (batch width 1 against the serve grid's 16 rows)."""
    from repro_torch.data import pad_batch
    from repro_torch.serving import ServingEngine
    corpus, budgets = serve_requests(model.cfg.vocab)
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                           burst_len=SERVE_BURST)
    same = 0
    for s, b, served in list(zip(corpus, budgets,
                                 toks["contiguous"]))[:GENERATE_CHECKS]:
        src, lens = pad_batch([s.src])
        res = engine.generate({"src_tokens": src, "src_lengths": lens},
                              max_new_tokens=b)
        same += list(res.tokens[0]) == served
    log(f"serve agreement: serve == per-request generate {same} of "
        f"{GENERATE_CHECKS}")


# ---------------------------------------------------------------------------
# phase 5b: continuous beam serving over the contiguous and the paged cache
# ---------------------------------------------------------------------------

BEAM_REQUESTS = 24             # phase 5b: the first half of phase 5's
MIXED_WIDTHS = [1, 2, 3, 4] * (BEAM_REQUESTS // 4)
BEAM_SERVE_RUNS = (     # name, engine options, serve options, act scales
    ("beam_contiguous", dict(paged=False), dict(), "static"),
    ("beam_paged", dict(paged=True, page_size=PAGE), dict(), "static"),
    ("beam_paged_unfused", dict(paged=True, page_size=PAGE),
     dict(fused_admission=False), "static"),
    ("beam_paged_mixed", dict(paged=True, page_size=PAGE),
     dict(beam=MIXED_WIDTHS), "static"),
    ("beam_paged_auto", dict(paged=True, page_size=PAGE, burst_len="auto"),
     dict(), "static"),
    ("beam_paged_dynamic", dict(paged=True, page_size=PAGE), dict(),
     "dynamic"),
)


def reorder_bytes_formula(cfg, rows: int, enc_len: int, paged: bool) -> int:
    """Bytes one beam step's reorder moves, from the reference's formulas:
    contiguous, the INT8 slab and its scales (``KVCache.nbytes``) plus the
    cross K/V in the activation dtype; paged
    (``PagedKVCache.reorder_bytes_per_step``), one page of payload and
    scales a row, the block tables and the cursors."""
    L, HKV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    act = cfg.activation_dtype.itemsize
    if paged:
        maxP = MAX_LEN // PAGE
        return (L * rows * PAGE * HKV * (dh + 4) * 2 + rows * maxP * 4
                + rows * 4)
    return (L * rows * MAX_LEN * HKV * (dh + 4) * 2
            + 2 * L * rows * enc_len * HKV * dh * act)


def beam_requests(vocab: int):
    """Phase 5b's requests: the first ``BEAM_REQUESTS`` of phase 5's."""
    corpus, budgets = serve_requests(vocab)
    return corpus[:BEAM_REQUESTS], budgets[:BEAM_REQUESTS]


def run_beam_serving(model, params, qparams, qctx):
    """Serve phase 5b's requests at beam 4 once per run of
    ``BEAM_SERVE_RUNS`` (INT8 weights; static scales ``qparams``/``qctx``,
    dynamic ones quantized here from ``params``), each run's launch counts
    read from zero.  Neither plain attention may run.  Returns (launch
    counts per run, results)."""
    import numpy as np
    from repro_torch.core import QuantPolicy, quantize_model
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServingEngine

    weights = {"static": (qparams, qctx),
               "dynamic": quantize_model(params, {},
                                         QuantPolicy(act_quant="dynamic"))}
    corpus, budgets = beam_requests(model.cfg.vocab)
    # warm-up: the beam step's shapes (uncounted)
    for scales, kw in (("static", dict(paged=False)),
                       ("static", dict(paged=True, page_size=PAGE)),
                       ("dynamic", dict(paged=True, page_size=PAGE))):
        wparams, wctx = weights[scales]
        ServingEngine(model, wparams, quant=wctx, max_len=MAX_LEN,
                      burst_len=SERVE_BURST, **kw).serve(
            corpus[:6], n_slots=SERVE_SLOTS, max_new_tokens=3, beam=BEAM)

    plain = {"decode_attention": ref.ref_decode_attention,
             "decode_attention_paged": ref.ref_decode_attention_paged}
    plain_calls = []

    def counted(name):
        def fn(*args, **kwargs):
            plain_calls.append(name)
            return plain[name](*args, **kwargs)
        return fn

    ref.ref_decode_attention = counted("decode_attention")
    ref.ref_decode_attention_paged = counted("decode_attention_paged")
    counts, results = {}, {}
    try:
        for name, kw, serve_kw, scales in BEAM_SERVE_RUNS:
            kw = dict(dict(burst_len=SERVE_BURST), **kw)
            wparams, wctx = weights[scales]
            engine = ServingEngine(model, wparams, quant=wctx,
                                   max_len=MAX_LEN, **kw)
            del plain_calls[:]
            ops.reset_launch_counts()
            res = engine.serve(corpus, n_slots=SERVE_SLOTS,
                               max_new_tokens=budgets,
                               **dict(dict(beam=BEAM), **serve_kw))
            counts[name] = ops.launch_counts()
            results[name] = res
            m = res.metrics()
            per_step = res.reorder_bytes // max(res.decode_steps, 1)
            want = reorder_bytes_formula(model.cfg, res.n_slots,
                                         engine._enc_bucket_hwm, res.paged)
            log(f"serve {name}: tokens={res.n_tokens} "
                f"tokens_per_s={res.tokens_per_s:.1f} "
                f"decode_steps={res.decode_steps} "
                f"host_syncs={res.host_syncs} "
                f"utilization={res.utilization:.3f} "
                f"admission_rounds={res.prefill_rounds} "
                f"prefill_dispatches={res.prefill_dispatches} "
                f"encoder_tokens={res.encoder_tokens} "
                f"burst_len={res.burst_len}"
                + (" (auto)" if res.auto_burst else "")
                + f" reorder_bytes={res.reorder_bytes} "
                f"({per_step} a step; formula {want}) "
                f"first_token_mean_s={m['first_token_latency_mean_s']:.4f} "
                f"first_token_p95_s={m['first_token_latency_p95_s']:.4f} "
                f"total_mean_s={m['total_latency_mean_s']:.4f} "
                f"total_p95_s={m['total_latency_p95_s']:.4f} "
                f"peak_running={res.peak_running} page_hwm={res.page_hwm}")
            log(f"  launches: {json.dumps(counts[name])}; plain attention "
                f"calls: {len(plain_calls)}")
            if len(res.requests) != BEAM_REQUESTS or any(
                    r.status != "finished" for r in res.requests):
                raise AssertionError(f"serve {name}: not every request "
                                     f"finished")
            for r, b in zip(res.requests, budgets):
                t = np.asarray(r.tokens)
                if len(t) > b or r.score is None or (len(t) and not (
                        0 <= t.min() and t.max() < model.cfg.vocab)):
                    raise AssertionError(f"serve {name}: bad output {t}")
            if per_step != want or res.reorder_bytes != want * \
                    res.decode_steps:
                raise AssertionError(f"serve {name}: reorder bytes "
                                     f"{res.reorder_bytes}, formula {want} "
                                     f"a step")
            if plain_calls:
                raise AssertionError(f"serve {name}: plain attention ran "
                                     f"{len(plain_calls)} times")
            k4 = counts[name]["decode_attention"]
            k5 = counts[name]["decode_attention_paged"]
            if res.paged:
                if res.pages_in_use != 0 or k5 <= 0:
                    raise AssertionError(
                        f"serve {name}: pages_in_use={res.pages_in_use}, "
                        f"K5 launched {k5} times")
            elif k5 or k4 <= 0:
                raise AssertionError(f"serve {name}: launches "
                                     f"{counts[name]}")
            if scales == "dynamic" and counts[name]["quantize_rowwise"] <= 0:
                raise AssertionError(f"serve {name}: K2 never launched")
    finally:
        ref.ref_decode_attention = plain["decode_attention"]
        ref.ref_decode_attention_paged = plain["decode_attention_paged"]

    toks = {name: [list(r.tokens) for r in res.requests]
            for name, res in results.items()}
    if toks["beam_paged"] != toks["beam_contiguous"]:
        bad = sum(a != b for a, b in zip(toks["beam_paged"],
                                         toks["beam_contiguous"]))
        raise AssertionError(f"paged and contiguous beam serving differ on "
                             f"{bad} of {BEAM_REQUESTS} requests")
    agree = lambda a, b: sum(x == y for x, y in zip(toks[a], toks[b]))
    log(f"beam serve agreement (of {BEAM_REQUESTS} requests): paged == "
        f"contiguous {agree('beam_paged', 'beam_contiguous')}, fused == "
        f"unfused {agree('beam_paged', 'beam_paged_unfused')}, auto burst "
        f"== burst {SERVE_BURST} {agree('beam_paged', 'beam_paged_auto')}, "
        f"dynamic == static scales "
        f"{agree('beam_paged', 'beam_paged_dynamic')}")
    return counts, results, toks


GENERATE_BEAM_CHECKS = 6       # beam-served requests run again alone


def beam_serve_vs_generate_beam(model, qparams, qctx, toks) -> None:
    """Per-request ``generate_beam(beam=4)`` of the first
    ``GENERATE_BEAM_CHECKS`` served requests, logged, not asserted: a
    batch of one request reaches the f32 unembed at another M than the
    serve grid's 16 rows."""
    from repro_torch.data import pad_batch
    from repro_torch.serving import ServingEngine
    corpus, budgets = beam_requests(model.cfg.vocab)
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                           burst_len=SERVE_BURST)
    same = 0
    for s, b, served in list(zip(corpus, budgets, toks["beam_contiguous"])
                             )[:GENERATE_BEAM_CHECKS]:
        src, lens = pad_batch([s.src])
        res = engine.generate_beam({"src_tokens": src, "src_lengths": lens},
                                   beam=BEAM, max_new_tokens=b)
        same += list(res.tokens[0]) == served
    log(f"beam serve agreement: serve == per-request generate_beam {same} "
        f"of {GENERATE_BEAM_CHECKS}")


# ---------------------------------------------------------------------------
# phase 5c: the prefix cache and overload
# ---------------------------------------------------------------------------

PREFIX_SOURCES = 12            # phase 5's first 12 sources, each twice
OVERCOMMIT = 1.5


def prefix_requests(vocab: int):
    """Phase 5c's 24 requests: the first ``PREFIX_SOURCES`` of phase 5's,
    each twice, with their phase-5 budgets; request ``i + 12`` repeats
    request ``i``."""
    corpus, budgets = serve_requests(vocab)
    return (corpus[:PREFIX_SOURCES] * 2, budgets[:PREFIX_SOURCES] * 2)


def equal_count(a, b) -> int:
    return sum(list(x.tokens) == list(y.tokens)
               for x, y in zip(a.requests, b.requests))


def check_serve(name, res, budgets, vocab, beam=False) -> None:
    """Every request finished inside its budget with ids in the vocabulary
    (and a score on beam serves), every page back in the pool, every spill
    restored."""
    import numpy as np
    if any(r.status != "finished" for r in res.requests):
        raise AssertionError(f"serve {name}: not every request finished")
    for r, b in zip(res.requests, budgets):
        t = np.asarray(r.tokens)
        if len(t) > b or (beam and r.score is None) or (len(t) and not (
                0 <= t.min() and t.max() < vocab)):
            raise AssertionError(f"serve {name}: bad output {t}")
    if res.pages_in_use or res.spill_events != res.restore_events:
        raise AssertionError(
            f"serve {name}: pages_in_use={res.pages_in_use}, "
            f"{res.spill_events} spills, {res.restore_events} restores")


def log_serve(name, res) -> None:
    log(f"serve {name}: tokens={res.n_tokens} "
        f"tokens_per_s={res.tokens_per_s:.1f} "
        f"decode_steps={res.decode_steps} host_syncs={res.host_syncs} "
        f"admission_rounds={res.prefill_rounds} "
        f"encoder_tokens={res.encoder_tokens} "
        f"prefix_hits={res.prefix_hits} prefix_misses={res.prefix_misses} "
        f"prefix_hit_pages={res.prefix_hit_pages} "
        f"prefix_pages_allocated={res.prefix_pages_allocated} "
        f"preemptions={res.preemptions} spill_events={res.spill_events} "
        f"restore_events={res.restore_events} "
        f"spilled_bytes={res.spilled_bytes} "
        f"chunked_admissions={res.chunked_admissions} "
        f"chunk_rounds={res.chunk_rounds} "
        f"speculative_k={res.speculative_k} "
        f"draft_tokens={res.draft_tokens} "
        f"accepted_tokens={res.accepted_tokens} "
        f"acceptance_rate={res.acceptance_rate:.4f} "
        f"peak_running={res.peak_running} page_hwm={res.page_hwm}")


# the plain versions that no run of phases 5c, 5d, 5e and 4t may call on
# the card
PLAIN_VERSIONS = ("ref_quantize_static", "ref_quantize_rowwise",
                  "ref_int8_matmul", "ref_int8_matmul_accumulate",
                  "ref_int8_matmul_epilogue", "ref_int8_matmul_batched",
                  "ref_int4_matmul", "ref_decode_attention",
                  "ref_decode_attention_paged")


def run_counted(name: str, counts: dict, fn):
    """``fn()`` (a serve or a generate) with the launch counts read from
    zero into ``counts[name]`` and the calls of the plain versions
    counted; any such call fails the run: shared, spilled, resumed, grown,
    staged, speculative and Table-1 rows must all go through the
    kernels."""
    from repro_torch.kernels import ops, ref
    plain = {n: getattr(ref, n) for n in PLAIN_VERSIONS}
    calls = []

    def counted(n):
        def call(*args, **kwargs):
            calls.append(n)
            return plain[n](*args, **kwargs)
        return call

    for n in plain:
        setattr(ref, n, counted(n))
    try:
        ops.reset_launch_counts()
        out = fn()
        counts[name] = ops.launch_counts()
    finally:
        for n, f in plain.items():
            setattr(ref, n, f)
    log(f"  {name} launches: {json.dumps(counts[name])}; plain-version "
        f"calls: {len(calls)}")
    if calls:
        raise AssertionError(f"{name}: plain versions ran {len(calls)} "
                             f"times ({sorted(set(calls))})")
    return out


def run_prefix_and_overload(model, qparams, qctx, q4params, q4ctx,
                            beam_paged, int4_paged):
    """Phase 5c, each run's launch counts read from zero.

    The prefix cache: a cold paged greedy serve of the 24 requests, then a
    warm one (``prefix_cache=True``; at least the 12 repeats hit), a
    re-serve on the same engine (all 24 hit, no chain page allocated) and
    a second cold serve (the spread of the tokens/s);
    with the cache also a contiguous (K4), an unfused, a beam-4 paged and
    an INT4 paged (K6) serve.  Overload: a paged pool of half the pages
    the unloaded serve's high-water mark needs, at ``overcommit=1.5`` with
    a chaos schedule, greedy (against the cold serve) and at beam 4 (against
    phase 5b's paged serve of 24 requests, ``beam_paged``).  Equal-token
    counts are logged, not asserted: the cold and warm serves encode a
    source in different rounds at different widths.  ``int4_paged`` is
    phase 6's INT4 paged serve, whose first 12 requests are these sources
    with these budgets.  Returns the launch counts per run."""
    from repro_torch.serving import ServingEngine, make_chaos

    vocab = model.cfg.vocab
    corpus, budgets = prefix_requests(vocab)
    beam_corpus, beam_budgets = beam_requests(vocab)
    weights = {"int8": (qparams, qctx), "int4": (q4params, q4ctx)}

    def engine(weights_of="int8", **kw):
        wparams, wctx = weights[weights_of]
        return ServingEngine(model, wparams, quant=wctx, max_len=MAX_LEN,
                             burst_len=SERVE_BURST, **kw)

    paged = dict(paged=True, page_size=PAGE)
    # warm-up of the spill, resume and growth paths (uncounted)
    engine(**paged, n_pages=8).serve(
        corpus[:8], n_slots=SERVE_SLOTS, max_new_tokens=12,
        overcommit=OVERCOMMIT, chaos=make_chaos(5, n_rounds=64,
                                                preempt_every=1))

    counts, results = {}, {}

    def run(name, eng, reqs=corpus, want=budgets, **kw):
        res = results[name] = run_counted(name, counts, lambda: eng.serve(
            reqs, n_slots=SERVE_SLOTS, max_new_tokens=want, **kw))
        log_serve(name, res)
        check_serve(name, res, want, vocab, beam="beam" in kw)
        return res

    cold = run("prefix_cold_paged", engine(**paged))
    warm_engine = engine(**paged, prefix_cache=True)
    warm = run("prefix_warm_paged", warm_engine)
    again = run("prefix_again_paged", warm_engine)
    # a second cold serve: the spread of a one-second serve on this host
    cold2 = run("prefix_cold_paged_2", engine(**paged))
    if warm.prefix_hits < PREFIX_SOURCES:
        raise AssertionError(f"warm serve: {warm.prefix_hits} hits")
    if again.prefix_hits != 2 * PREFIX_SOURCES or \
            again.prefix_pages_allocated or again.encoder_tokens:
        raise AssertionError(
            f"re-serve: {again.prefix_hits} hits, "
            f"{again.prefix_pages_allocated} chain pages allocated, "
            f"{again.encoder_tokens} encoder tokens")
    contiguous = run("prefix_contiguous", engine(prefix_cache=True))
    unfused = run("prefix_unfused_paged", engine(**paged, prefix_cache=True),
                  fused_admission=False)
    beam = run("prefix_beam_paged", engine(**paged, prefix_cache=True),
               beam=BEAM)
    int4 = run("prefix_int4_paged", engine("int4", **paged,
                                           prefix_cache=True))
    for name in ("prefix_warm_paged", "prefix_contiguous",
                 "prefix_unfused_paged", "prefix_beam_paged",
                 "prefix_int4_paged"):
        if results[name].prefix_hits < PREFIX_SOURCES:
            raise AssertionError(f"serve {name}: "
                                 f"{results[name].prefix_hits} hits")
    if counts["prefix_contiguous"]["decode_attention"] <= 0 or \
            counts["prefix_int4_paged"]["int4_matmul"] <= 0:
        raise AssertionError("K4 or K6 never launched under the cache")

    # request i + 12 repeats request i: the first 12 of a 48- or 24-request
    # serve of phase 5, 5b or 6 are the same requests
    def vs_first(res, tokens):
        return sum(list(r.tokens) == list(tokens[i % PREFIX_SOURCES])
                   for i, r in enumerate(res.requests))

    log(f"prefix agreement (of {2 * PREFIX_SOURCES} requests): warm == "
        f"cold {equal_count(warm, cold)}, re-serve == warm "
        f"{equal_count(again, warm)}, cold == cold again "
        f"{equal_count(cold2, cold)}, contiguous == cold paged "
        f"{equal_count(contiguous, cold)}, unfused == cold "
        f"{equal_count(unfused, cold)}, beam-4 warm == phase 5b's paged "
        f"{vs_first(beam, [r.tokens for r in beam_paged.requests])}, "
        f"INT4 warm == phase 6's INT4 paged "
        f"{vs_first(int4, [r.tokens for r in int4_paged.requests])}")
    log(f"prefix tokens/s: cold {cold.tokens_per_s:.1f}, warm "
        f"{warm.tokens_per_s:.1f}, re-serve {again.tokens_per_s:.1f}, cold "
        f"again {cold2.tokens_per_s:.1f}; hit "
        f"rate warm {warm.metrics()['prefix_hit_rate']:.3f}, re-serve "
        f"{again.metrics()['prefix_hit_rate']:.3f}")

    # overload: half the unloaded high-water mark, overcommit and chaos
    chaos = lambda: make_chaos(5, n_rounds=256, preempt_every=2)
    for name, base, reqs, want, kw in (
            ("overload_paged", cold, corpus, budgets, {}),
            ("overload_beam_paged", beam_paged, beam_corpus, beam_budgets,
             dict(beam=BEAM))):
        n_pages = max(base.page_hwm // 2, 1)
        res = run(name, engine(**paged, n_pages=n_pages), reqs, want,
                  overcommit=OVERCOMMIT, chaos=chaos(), **kw)
        if res.preemptions <= 0:
            raise AssertionError(f"serve {name}: no preemption")
        log(f"{name}: pool {n_pages} pages (unloaded page_hwm "
            f"{base.page_hwm}), equal to the unloaded serve "
            f"{equal_count(res, base)} of {len(reqs)}, "
            f"preemptions={res.preemptions} "
            f"spilled_bytes={res.spilled_bytes} "
            f"peak_running={res.peak_running} (unloaded "
            f"{base.peak_running}) tokens_per_s={res.tokens_per_s:.1f} "
            f"(unloaded {base.tokens_per_s:.1f}) "
            f"straggler_rounds={res.straggler_rounds}")
    return counts


SPILL_REPS = 20                # phase 5c: calls timed of each spill/resume
# the runtime's launch and copy calls, against which the profiler's device
# events are counted
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def spill_resume_ms(model, qparams, qctx) -> None:
    """One spill and one resume of a greedy row and of a beam-4 group of a
    full paged decode state (16 rows, every row 48 positions in, cross K/V
    of the 64-token bucket), each called ``SPILL_REPS`` times: the median
    device span between CUDA events recorded around the call (the stream's
    time from before its first launch to after its last copy, the gaps
    while the host enqueues included), the median host ms around the call
    ending in a synchronise, and the profiler's device busy time a call
    over as many calls, with its device events counted against the
    runtime's launch and copy calls (when it drops events, its busy time
    is a lower bound); and the bytes moved (the spill's host payload,
    which the resume uploads again)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.models import kv_cache as kvc
    from repro_torch.serving import ServingEngine, SpilledRequest
    R, maxP = SERVE_SLOTS, MAX_LEN // PAGE
    eng = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                        paged=True, page_size=PAGE)
    state = model.init_decode_state(R, MAX_LEN, quantized=True, enc_len=64,
                                    paged=True, page_size=PAGE)
    state["cache"] = kvc.with_lengths(
        kvc.assign_pages(state["cache"], np.arange(R), np.arange(
            R * maxP, dtype=np.int32).reshape(R, maxP)),
        torch.full((R,), 48, dtype=torch.int32, device="cuda"))
    tokens = torch.ones((R,), dtype=torch.int32, device="cuda")
    for rows in (np.arange(1, dtype=np.int32),
                 np.arange(BEAM, dtype=np.int32)):
        # the resume scatters into other pages than the rows' own
        pages = np.arange(len(rows) * maxP, dtype=np.int32).reshape(
            len(rows), maxP)[::-1].copy()
        sp = SpilledRequest(0, len(rows), *eng._spill(state, tokens, rows),
                            n_pages=0)
        for what, fn in (
                ("spill", lambda: eng._spill(state, tokens, rows)),
                ("resume", lambda: eng._resume(state, tokens, rows, pages,
                                               sp))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            span, host = [], []
            for _ in range(SPILL_REPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                span.append(e0.elapsed_time(e1))
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                for _ in range(SPILL_REPS):
                    fn()
                torch.cuda.synchronize()
            dev = device_rows(prof)
            busy = sum(r[0] for r in dev) / SPILL_REPS
            n_dev = sum(r[2] for r in dev)
            n_api = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CPU
                        and e.key in LAUNCH_CALLS)
            log(f"{what} of {len(rows)} rows: device span "
                f"{float(np.median(span)):.4f} ms (CUDA events, median of "
                f"{SPILL_REPS}; min {min(span):.4f}), host "
                f"{float(np.median(host)):.3f} ms; profiler busy "
                f"{busy:.4f} ms a call from {n_dev} device events for "
                f"{n_api} launch and copy calls over {SPILL_REPS} calls"
                + ("" if n_dev >= n_api else
                   " (events dropped: the busy time is a lower bound)")
                + f"; {sp.n_bytes} bytes of host payload")


# ---------------------------------------------------------------------------
# phase 5d: chunked prefill and self-speculative decoding
# ---------------------------------------------------------------------------

CHUNK_REQUESTS = 24            # phase 5's first 24 requests
PREFILL_CHUNK = 24             # sources of more tokens stage (13 of the 24)
SPEC_K = 4                     # draft window of the speculative serves


def run_chunked_and_speculative(model, qparams, qctx, batch, plain_generate,
                                serve_toks, beam_paged):
    """Phase 5d, each run's launch counts read from zero and its plain
    attention and INT4 calls counted (none may run).

    Chunked prefill: the first 24 requests of phase 5 with
    ``prefill_chunk=24`` (13 sources are longer and stage, one encoder layer
    a round): a paged greedy serve, a paged beam-4 serve, and a greedy one
    at ``overcommit=1.5`` with a chaos schedule on half its page
    high-water mark; ``chunked_admissions`` must be 13 and, where nothing
    was preempted, ``chunk_rounds`` 13 × the encoder depth.  Speculation:
    ``generate(speculative_k=2 and 4)`` on phase 4's batch, then
    ``serve(speculative_k=4)`` of the 24 requests, contiguous (K4) and
    paged (K5) with the self-draft, and paged with a dynamic (K2) draft
    under the static (K1) verifier.  Equal-token counts against the plain
    serves of the same requests (phase 5's, 5b's and this phase's) and
    the acceptance rates are logged.  Returns the launch counts per run."""
    import dataclasses
    from repro_torch.core.ptq import QuantContext
    from repro_torch.serving import ServingEngine, make_chaos

    vocab, n_enc = model.cfg.vocab, model.cfg.n_enc_layers
    corpus, budgets = serve_requests(vocab)
    reqs, want = corpus[:CHUNK_REQUESTS], budgets[:CHUNK_REQUESTS]
    n_long = sum(len(s.src) > PREFILL_CHUNK for s in reqs)
    paged = dict(paged=True, page_size=PAGE)

    def engine(**kw):
        return ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                             burst_len=SERVE_BURST, **kw)

    # warm-up of the staged encode and the verify shapes (uncounted)
    engine(**paged).serve(reqs[:8], n_slots=SERVE_SLOTS, max_new_tokens=4,
                          prefill_chunk=PREFILL_CHUNK, speculative_k=SPEC_K)

    counts = {}

    def run(name, eng, **kw):
        res = run_counted(name, counts, lambda: eng.serve(
            reqs, n_slots=SERVE_SLOTS, max_new_tokens=want, **kw))
        log_serve(name, res)
        check_serve(name, res, want, vocab, beam="beam" in kw)
        return res

    def same(res, tokens) -> int:
        return sum(list(r.tokens) == list(t)
                   for r, t in zip(res.requests, tokens))

    def check_staged(name, res):
        if res.chunked_admissions != n_long or (
                not res.preemptions and res.chunk_rounds != n_long * n_enc):
            raise AssertionError(
                f"serve {name}: {res.chunked_admissions} chunked admissions "
                f"({n_long} long sources), {res.chunk_rounds} chunk rounds")

    # -- chunked prefill
    plain = run("5d_plain_paged", engine(**paged))
    chunked = run("chunked_paged", engine(**paged),
                  prefill_chunk=PREFILL_CHUNK)
    check_staged("chunked_paged", chunked)
    chunked_beam = run("chunked_beam_paged", engine(**paged), beam=BEAM,
                       prefill_chunk=PREFILL_CHUNK)
    check_staged("chunked_beam_paged", chunked_beam)
    n_pages = max(chunked.page_hwm // 2, 1)
    over = run("chunked_overload_paged", engine(**paged, n_pages=n_pages),
               prefill_chunk=PREFILL_CHUNK, overcommit=OVERCOMMIT,
               chaos=make_chaos(5, n_rounds=256, preempt_every=2))
    if over.preemptions <= 0 or over.chunked_admissions < n_long:
        raise AssertionError(f"chunked overload: {over.preemptions} "
                             f"preemptions, {over.chunked_admissions} "
                             "chunked admissions")
    first = lambda name: serve_toks[name][:CHUNK_REQUESTS]
    log(f"chunked agreement (of {CHUNK_REQUESTS} requests, {n_long} staged): "
        f"chunked == plain {same(chunked, [r.tokens for r in plain.requests])}"
        f", chunked == phase 5's paged {same(chunked, first('paged'))}, "
        f"beam-4 chunked == phase 5b's paged "
        f"{same(chunked_beam, [r.tokens for r in beam_paged.requests])}, "
        f"overloaded chunked (pool {n_pages} pages) == chunked "
        f"{same(over, [r.tokens for r in chunked.requests])}; tokens/s "
        f"chunked {chunked.tokens_per_s:.1f}, plain {plain.tokens_per_s:.1f}"
        f", beam-4 chunked {chunked_beam.tokens_per_s:.1f}")

    # -- speculative generate on phase 4's batch
    gen_engine = engine()
    for k in (2, 4):
        g = run_counted(f"generate_spec_k{k}", counts,
                        lambda: gen_engine.generate(
                            batch, max_new_tokens=MAX_NEW, speculative_k=k))
        equal = sum(list(a) == list(b)
                    for a, b in zip(g.tokens, plain_generate.tokens))
        log(f"generate speculative_k={k}: equal to plain generate {equal} of "
            f"{len(g.tokens)}, acceptance_rate={g.acceptance_rate:.4f} "
            f"(draft {g.draft_tokens}, accepted {g.accepted_tokens}), "
            f"steps={g.steps} host_syncs={g.host_syncs} tokens_per_s="
            f"{g.tokens_per_s:.1f} (plain {plain_generate.tokens_per_s:.1f})")

    # -- speculative serves
    plain_contig = run("5d_plain_contiguous", engine())
    spec_contig = run("spec_contiguous", engine(), speculative_k=SPEC_K)
    spec_paged = run("spec_paged", engine(**paged), speculative_k=SPEC_K)
    draft = QuantContext(policy=dataclasses.replace(qctx.policy,
                                                    act_quant="dynamic"),
                         impl=qctx.impl)
    spec_draft = run("spec_paged_dynamic_draft",
                     engine(**paged, draft_quant=draft),
                     speculative_k=SPEC_K)
    for name, kernel in (("spec_contiguous", "decode_attention"),
                         ("spec_paged", "decode_attention_paged"),
                         ("spec_paged_dynamic_draft", "quantize_rowwise"),
                         ("spec_paged_dynamic_draft", "quantize_static")):
        if counts[name][kernel] <= 0:
            raise AssertionError(f"serve {name}: {kernel} never launched")
    log(f"speculative agreement (of {CHUNK_REQUESTS} requests, k={SPEC_K}): "
        f"contiguous == plain contiguous "
        f"{same(spec_contig, [r.tokens for r in plain_contig.requests])}, "
        f"paged == plain paged "
        f"{same(spec_paged, [r.tokens for r in plain.requests])}, "
        f"dynamic draft == plain paged "
        f"{same(spec_draft, [r.tokens for r in plain.requests])}, "
        f"contiguous == phase 5's contiguous "
        f"{same(spec_contig, first('contiguous'))}; acceptance_rate "
        f"self-draft contiguous {spec_contig.acceptance_rate:.4f}, paged "
        f"{spec_paged.acceptance_rate:.4f}, dynamic draft "
        f"{spec_draft.acceptance_rate:.4f}; tokens/s contiguous "
        f"{spec_contig.tokens_per_s:.1f} (plain "
        f"{plain_contig.tokens_per_s:.1f}), paged "
        f"{spec_paged.tokens_per_s:.1f} (plain {plain.tokens_per_s:.1f}), "
        f"dynamic draft {spec_draft.tokens_per_s:.1f}; K4 launches "
        f"{counts['spec_contiguous']['decode_attention']} (plain "
        f"{counts['5d_plain_contiguous']['decode_attention']}), K5 "
        f"{counts['spec_paged']['decode_attention_paged']} (plain "
        f"{counts['5d_plain_paged']['decode_attention_paged']})")
    verify_vs_sequential(model, qparams, qctx, batch)
    return counts


def verify_vs_sequential(model, qparams, qctx, batch, k: int = SPEC_K,
                         warm: int = 3) -> None:
    """One macro-step's verify against sequential decode: after ``warm``
    plain steps, ``k + 1`` sequential ``decode_step``s (each fed the last
    one's argmax), then one ``decode_step_multi`` over the same ``k + 1``
    tokens from the same cursors; the largest |Δ| between the verify's
    logits at position j and the j-th sequential step's, per position."""
    import torch
    dev = {n: torch.as_tensor(v, device=model.device)
           for n, v in batch.items()}
    state = model.init_decode_state(dev["src_tokens"].shape[0], MAX_LEN,
                                    quantized=qctx.quantize_kv)
    lg, state = model.prefill(qparams, dev, state, quant=qctx)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)
    for _ in range(warm):
        lg, state = model.decode_step(qparams, tok, state, quant=qctx)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    feed, seq_logits, st = [tok], [], state
    for j in range(k + 1):
        lg, st = model.decode_step(qparams, feed[-1], st, quant=qctx)
        seq_logits.append(lg.float())
        feed.append(torch.argmax(lg, dim=-1).to(torch.int32))
    vlg, _ = model.decode_step_multi(qparams, torch.stack(feed[:k + 1], 1),
                                     state, quant=qctx)
    deltas = [float((vlg[:, j].float() - seq_logits[j]).abs().max())
              for j in range(k + 1)]
    agree = [int((vlg[:, j].argmax(-1) == seq_logits[j].argmax(-1)).sum())
             for j in range(k + 1)]
    log(f"verify vs sequential decode (k={k}, {vlg.shape[0]} rows): max |dlogit| by position {deltas}; argmax equal by position "
        f"{agree}")


# ---------------------------------------------------------------------------
# phase 5e: tensor-parallel serving on two ranks of the card, and the router
# ---------------------------------------------------------------------------

TP = 2                         # phase 5e: ranks of the "model" axis
TP_SPEC_K = 2                  # draft window of its speculative serve
TP_TIMEOUT_S = 600             # the ranks' whole run
TP_LOGIT_STEPS = 3             # decode steps whose logits are compared
# every rank must launch these on its runs (static INT8: K1; K3 at the
# column-parallel linears and its two halves at the row-parallel ones)
TP_KERNELS = {"generate": ("quantize_static", "int8_matmul",
                           "int8_matmul_accumulate", "int8_matmul_epilogue",
                           "decode_attention"),
              "paged": ("quantize_static", "int8_matmul",
                        "int8_matmul_accumulate", "int8_matmul_epilogue",
                        "decode_attention_paged")}


def first_logits(engine, qctx, batch, steps: int = TP_LOGIT_STEPS):
    """The prefill's and ``steps`` greedy decode steps' logits (on the
    host) through ``engine``'s model, weights and decode state (a rank's
    shard of them on a mesh)."""
    import torch
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    state = engine._new_state(N_REQUESTS)
    logits, state = engine.model.prefill(engine.params, b, state, quant=qctx)
    out = [logits.cpu()]
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, state = engine.model.decode_step(engine.params, tok, state,
                                                 quant=qctx)
        out.append(logits.cpu())
    return out


TP_COUNTERS = ("host_syncs", "decode_steps", "busy_slot_steps",
               "prefill_rounds", "page_hwm", "pages_in_use", "peak_running",
               "draft_tokens", "accepted_tokens")


def outcome(res) -> dict:
    """What phase 5e compares of a ``GenerationResult`` or ``ServeResult``."""
    if not hasattr(res, "requests"):
        return dict(tokens=[list(map(int, t)) for t in res.tokens],
                    host_syncs=res.host_syncs, steps=res.steps,
                    tokens_per_s=res.tokens_per_s)
    return dict(tokens=[list(map(int, r.tokens)) for r in res.requests],
                tokens_per_s=res.tokens_per_s,
                **{k: getattr(res, k) for k in TP_COUNTERS},
                mesh_shape=tuple(res.mesh_shape), tp_degree=res.tp_degree,
                collective_bytes_per_step=res.collective_bytes_per_step)


def tp_runs(model, qparams, qctx, batch, mesh, only=None) -> dict:
    """Phase 5e's runs on one engine setup (``mesh``: a rank's, or None),
    each with its launches read from zero and no plain version allowed:
    greedy ``generate`` of phase 4's batch, phase 5's 48 requests through a
    paged ``serve`` (16 slots, burst 8, pages of 16), and a paged
    ``serve(speculative_k=2)`` of phase 5d's 24; then the first decode
    steps' logits.  ``only``: the names to run."""
    from repro_torch.serving import ServingEngine

    corpus, budgets = serve_requests(model.cfg.vocab)
    spec = (corpus[:CHUNK_REQUESTS], budgets[:CHUNK_REQUESTS])
    paged = dict(paged=True, page_size=PAGE)

    def engine(**kw):
        return ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                             burst_len=SERVE_BURST, mesh=mesh, **kw)

    runs = {"generate": lambda: engine().generate(batch,
                                                  max_new_tokens=MAX_NEW),
            "paged": lambda: engine(**paged).serve(
                corpus, n_slots=SERVE_SLOTS, max_new_tokens=budgets),
            f"speculative_k={TP_SPEC_K}": lambda: engine(**paged).serve(
                spec[0], n_slots=SERVE_SLOTS, max_new_tokens=spec[1],
                speculative_k=TP_SPEC_K)}
    # warm-up of the serve and verify shapes (uncounted)
    engine(**paged).serve(corpus[:SERVE_SLOTS + 2], n_slots=SERVE_SLOTS,
                          max_new_tokens=4, speculative_k=TP_SPEC_K)
    out, counts = {}, {}
    for name, fn in runs.items():
        if only is None or name in only:
            out[name] = outcome(run_counted(name, counts, fn))
            out[name]["launches"] = counts[name]
    if only is None or "logits" in only:
        out["logits"] = first_logits(engine(), qctx, batch)
    return out


def save_atomic(obj, path: str) -> None:
    """``torch.save`` to ``path`` through a rename, so a reader polling for
    ``path`` never loads half a file."""
    import torch
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def wait_for_file(path: str, deadline: float, what: str) -> None:
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{what} never came")
        time.sleep(0.05)


def tp_rank(rank: int, world: int, rdzv: str, paths: dict) -> None:
    """One rank of phases 5e and 5f on ``cuda:0``: joins a gloo group of
    ``world`` ranks and waits (at most ``TP_TIMEOUT_S``) for phase 5e's
    state (``paths["state"]`` and its ``.ready`` mark); then the ``(1,
    world)`` mesh, phase 4's weights cut to this rank's shard,
    :func:`tp_runs`, its results to ``paths["outs"][rank]``; then phase
    5f's :func:`decoder_tp_runs` on the same mesh, to
    ``paths["outs_5f"][rank]`` (phase 5g's :func:`train_tp_first` in its
    wait for this process's thresholds); then phase 5g's
    :func:`train_tp_runs`, to ``paths["outs_5g"][rank]``.  A traceback
    goes to ``paths["errs"][rank]``."""
    import traceback
    import torch
    import torch.distributed as dist

    sys.stdout = open(os.devnull, "w")
    try:
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import EncDecLM
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            t0 = time.perf_counter()
            wait_for_file(paths["state"] + ".ready", t0 + TP_TIMEOUT_S,
                          "phase 5e's state")
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            saved = torch.load(paths["state"], weights_only=False)
            model = EncDecLM(get_config("transformer-base"), device="cuda")
            mesh = make_host_mesh(1, world)
            out = tp_runs(model, saved["qparams"], saved["qctx"],
                          saved["batch"], mesh)
            save_atomic(out, paths["outs"][rank])
            del saved, model, out
            torch.cuda.empty_cache()
            first = {}
            save_atomic(decoder_tp_runs(
                mesh, rank, paths, t0,
                idle=lambda: first.update(train_tp_first(rank))),
                paths["outs_5f"][rank])
            torch.cuda.empty_cache()
            save_atomic(train_tp_runs(rank, paths, first),
                        paths["outs_5g"][rank])
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(paths["errs"][rank], "w") as f:
            f.write(traceback.format_exc())
        raise


def start_tp_ranks() -> dict:
    """Spawn phase 5e's ranks ahead of it (daemons, so they end with this
    process): they import and join their group while phase 5d runs, and
    touch the card only once :func:`run_tensor_parallel` hands them the
    weights.  They go on to phase 5f (:func:`decoder_tp_runs`) after it,
    beside this process's phases."""
    import atexit
    import shutil
    import tempfile
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    ranks = dict(tmp=tmp, state=os.path.join(tmp, "state.pt"),
                 outs=[os.path.join(tmp, f"rank{r}.pt") for r in range(TP)],
                 outs_5f=[os.path.join(tmp, f"rank{r}-5f.pt")
                          for r in range(TP)],
                 outs_5g=[os.path.join(tmp, f"rank{r}-5g.pt")
                          for r in range(TP)],
                 ckpt_5g=os.path.join(tmp, "ckpt-5g"),
                 card_5g=os.path.join(tmp, "card-5g"),
                 errs=[os.path.join(tmp, f"rank{r}.err")
                       for r in range(TP)],
                 recs={m: os.path.join(tmp, f"recs-{m}.pt")
                       for m in TP_DECODERS},
                 go=os.path.join(tmp, "go-5f"),
                 dynamic_done=[os.path.join(tmp, f"rank{r}-5f-dynamic")
                               for r in range(TP)])
    paths = {k: v for k, v in ranks.items() if k != "tmp"}
    ctx = mp.get_context("spawn")
    ranks["procs"] = [ctx.Process(target=tp_rank, daemon=True, args=(
        r, TP, f"file://{tmp}/rdzv", paths)) for r in range(TP)]
    for p in ranks["procs"]:
        p.start()
    return ranks


def wait_for_ranks(tp_ranks: dict, outs, timeout_s: float, what: str,
                   load: bool = True):
    """Every rank's results (``outs[r]``, loaded unless ``load`` is
    False: a mark), waiting at most ``timeout_s``; a rank's traceback, its
    exit without results, or the timeout fails ``what``."""
    import torch
    procs, errs = tp_ranks["procs"], tp_ranks["errs"]
    deadline = time.perf_counter() + timeout_s

    def failed():
        for r, e in enumerate(errs):
            if os.path.exists(e):
                with open(e) as f:
                    raise AssertionError(f"{what} rank {r} failed:\n"
                                         f"{f.read()}")

    while not all(os.path.exists(o) for o in outs):
        failed()
        dead = [r for r, (p, o) in enumerate(zip(procs, outs))
                if not p.is_alive() and not os.path.exists(o)]
        if dead:
            time.sleep(0.5)
            failed()
            raise AssertionError(f"{what}: ranks {dead} exited "
                                 f"({[p.exitcode for p in procs]}) without "
                                 "results")
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: the ranks did not finish in "
                                 f"{timeout_s} s")
        time.sleep(0.05)
    return [torch.load(o, weights_only=False) for o in outs] if load else None


def compare_logits(name: str, got, want) -> None:
    """Bit for bit, or else within ``LOGIT_ATOL`` with the largest
    difference and the count of differing elements logged."""
    for step, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        n = int((diff != 0).sum())
        log(f"  {name} logits step {step}: "
            + ("bit for bit" if n == 0 else
               f"max |Δ| {float(diff.max()):.3g} on {n} of {diff.numel()} "
               f"elements"))
        if not bool(g.isfinite().all()) or float(diff.max()) > LOGIT_ATOL:
            raise AssertionError(f"{name} logits step {step} differ by "
                                 f"{float(diff.max())}")


def run_mesh_one_and_router(model, qparams, qctx, batch, want,
                            counts) -> None:
    """Phase 5e in this process: a ``(1, 1)`` mesh (a world-size-1 gloo
    group) equal to phase 5's paged serve bit for bit, and two replicas
    behind a ``ReplicaRouter``, threaded and serial, with phase 5's paged
    tokens and an even split."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ReplicaRouter, ServingEngine

    one = tp_runs(model, qparams, qctx, batch, make_host_mesh(1, 1),
                  only=("paged",))["paged"]
    counts["mesh (1,1) paged"] = one["launches"]
    bad = [k for k in ("tokens",) + TP_COUNTERS
           if one[k] != want["paged"][k]]
    log(f"5e (1, 1) mesh paged serve: tokens/s {one['tokens_per_s']:.1f}, "
        f"mesh {one['mesh_shape']}, differs in {bad or 'nothing'}")
    if bad or one["mesh_shape"] != (1, 1):
        raise AssertionError(f"5e (1, 1) mesh differs in {bad}")

    corpus, budgets = serve_requests(model.cfg.vocab)
    for parallel in (True, False):
        name = f"router x2 parallel={parallel}"
        engines = [ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                                 burst_len=SERVE_BURST, paged=True,
                                 page_size=PAGE) for _ in range(2)]
        res = run_counted(name, counts, lambda: ReplicaRouter(engines).serve(
            corpus, n_slots=SERVE_SLOTS, max_new_tokens=budgets,
            parallel=parallel))
        got = [list(map(int, res.tokens_for(i))) for i in range(len(corpus))]
        n_eq = sum(a == b for a, b in zip(got, want["paged"]["tokens"]))
        split = [res.assignment.count(i) for i in range(2)]
        log(f"5e {name}: tokens/s {res.tokens_per_s:.1f} (one engine "
            f"{want['paged']['tokens_per_s']:.1f}), assignment {split}, "
            f"{n_eq} of {len(corpus)} token lists equal phase 5's paged")
        if n_eq != len(corpus) or abs(split[0] - split[1]) > 1:
            raise AssertionError(f"5e {name}: {n_eq} equal, assignment "
                                 f"{split}")


def run_tensor_parallel(tp_ranks: dict, model, qparams, qctx, batch,
                        plain_generate, paged_serve) -> dict:
    """Phase 5e: ``TP`` ranks on the one card over gloo (NCCL cannot put
    two ranks of a communicator on one device; :func:`start_tp_ranks`
    spawned them), each running :func:`tp_runs` on its shard of phase 4's
    weights; every rank's tokens and counters must equal the unsharded
    runs' (phase 4's greedy ``generate``, phase 5's paged serve, and a
    speculative serve run here), the ranks' logits must agree with each
    other bit for bit and with the unsharded ones as
    :func:`compare_logits` says, and every rank must launch
    ``TP_KERNELS``.  While the ranks run, this process runs the unsharded
    references and :func:`run_mesh_one_and_router`, so the tokens/s of
    those runs and of the ranks (logged) are taken beside each other; and
    the ranks' collectives go through the host: none of them measures
    multi-GPU speed.  The ranks go on to phase 5f; their results are read
    here without waiting for them to end.  Returns the launch counts of
    every run."""
    import torch

    counts = {}
    t0 = time.perf_counter()
    save_atomic({"qparams": qparams, "qctx": qctx, "batch": batch},
                tp_ranks["state"])
    open(tp_ranks["state"] + ".ready", "w").close()
    # while the ranks run: the unsharded references they are held to, the
    # (1, 1) mesh and the router
    want = tp_runs(model, qparams, qctx, batch, None,
                   only=(f"speculative_k={TP_SPEC_K}", "logits"))
    want["generate"] = outcome(plain_generate)
    want["paged"] = outcome(paged_serve)
    run_mesh_one_and_router(model, qparams, qctx, batch, want, counts)
    log(f"5e: this process's runs {time.perf_counter() - t0:.1f} s")
    ranks = wait_for_ranks(tp_ranks, tp_ranks["outs"],
                           TP_TIMEOUT_S - (time.perf_counter() - t0), "5e")
    os.remove(tp_ranks["state"])
    log(f"5e: {TP} ranks on one card over gloo, from their weights to "
        f"their results: {time.perf_counter() - t0:.1f} s (they go on "
        "to phase 5f)")

    for r, got in enumerate(ranks):
        for name in ("generate", "paged", f"speculative_k={TP_SPEC_K}"):
            g, w = got[name], want[name]
            counts[f"rank{r} {name}"] = g["launches"]
            fields = [k for k in w if k not in ("tokens_per_s", "launches",
                                                "mesh_shape", "tp_degree",
                                                "collective_bytes_per_step")]
            bad = [k for k in fields if g[k] != w[k]]
            log(f"5e rank {r} {name}: tokens/s {g['tokens_per_s']:.1f} "
                f"(unsharded {w['tokens_per_s']:.1f}), host_syncs "
                f"{g['host_syncs']}, launches "
                + json.dumps({k: v for k, v in g["launches"].items() if v})
                + ("" if "mesh_shape" not in g else
                   f", mesh {g['mesh_shape']}, predicted collective bytes "
                   f"a step {g['collective_bytes_per_step']}"))
            if bad:
                n_eq = sum(a == b for a, b in zip(g["tokens"], w["tokens"]))
                raise AssertionError(
                    f"5e rank {r} {name} differs from the unsharded run in "
                    f"{bad} ({n_eq} of {len(w['tokens'])} token lists "
                    f"equal)")
            for k in TP_KERNELS.get(name, ()):
                if g["launches"][k] <= 0:
                    raise AssertionError(f"5e rank {r} {name}: {k} never "
                                         "launched")
        compare_logits(f"5e rank {r} vs unsharded", got["logits"],
                       want["logits"])
    for a, b in zip(ranks[0]["logits"], ranks[1]["logits"]):
        if not torch.equal(a, b):
            raise AssertionError("5e: the ranks' logits differ")

    return counts


# ---------------------------------------------------------------------------
# phase 5f: the decoder-only families on phase 5e's two ranks
# ---------------------------------------------------------------------------

# model -> (arch, layers): phases 7's and 7b's trees
TP_DECODERS = {"moe": (MOE_ARCH, MOE_LAYERS),
               "dense": (DENSE_ARCH, DENSE_LAYERS)}
# a rank's runs in order: (model, activation scales, calls).  The dynamic
# ones start when this process starts phase 4t's Table 1 (after the timed
# training steps) and end before its MoE step; the static ones wait for
# this process's thresholds, which it hands over after phase 7c.  So the
# ranks run beside no timed run but Table 1's 500 training steps, whose
# seconds then include the ranks' share of the card and the host
TP_DECODER_RUNS = (("moe", "dynamic", ("greedy", "beam4")),
                   ("dense", "dynamic", ("greedy",)),
                   ("moe", "static", ("greedy",)),
                   ("dense", "static", ("greedy",)))
TP_DECODER_TIMEOUT_S = 1200    # a rank's whole run, from its start
# kernels whose launches a rank's run must equal the unsharded run's: the
# quantizers, K4 and K7 (over the rank's experts) run once where the
# unsharded run runs them; K3 at a row-parallel linear runs as its halves
TP_EQUAL_LAUNCHES = ("quantize_static", "quantize_rowwise",
                     "decode_attention", "int8_matmul_batched")


def decoder_tree(model, recs):
    """Phase 7's or 7b's whole INT8 tree and context: float32 weights from
    ``torch.Generator`` seed 0 on the card (as phases 7 and 7b make them),
    quantized with dynamic scales (``recs`` None) or static ones, the
    float tree freed."""
    import torch
    from repro_torch.core import QuantPolicy, quantize_model
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    act = "dynamic" if recs is None else "static"
    out = quantize_model(params, recs or {}, QuantPolicy(act_quant=act))
    del params
    return out


def decoder_run(engine, batch, call: str, new: int = MAX_NEW):
    """Greedy ``generate`` or beam-4 ``generate_beam`` of ``new`` tokens."""
    return (engine.generate(batch, max_new_tokens=new)
            if call == "greedy" else
            engine.generate_beam(batch, beam=BEAM, max_new_tokens=new))


def decoder_tp_runs(mesh, rank: int, paths: dict, t_start: float,
                    idle=None) -> dict:
    """Phase 5f on one rank (after 5e, on its mesh): ``TP_DECODER_RUNS``
    at the published widths and phases 7's and 7b's depths.  Each tree is
    remade here from seed 0 and quantized whole (per-channel scales span
    the whole input dimension), then the engine cuts this rank's shard;
    the dynamic runs wait for ``paths["go"]`` and mark their end
    (``paths["dynamic_done"][rank]``), the static ones wait for this
    process's thresholds (``paths["recs"]``), after ``idle()`` (other
    work for the wait).  Each run is counted with no plain version
    allowed; then the prefill's and the first decode steps' logits.
    Returns the outcomes, launches, logits, seconds and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    out, counts = {"seconds": {}}, {}
    deadline = t_start + TP_DECODER_TIMEOUT_S
    wait_for_file(paths["go"], deadline, "phase 5f's start")
    t0 = time.perf_counter()
    for m, act, calls in TP_DECODER_RUNS:
        arch, layers = TP_DECODERS[m]
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        model = DecoderLM(cfg, device="cuda")
        batch = moe_prompts(cfg.vocab)[0]
        recs = None
        if act == "static":
            if not os.path.exists(paths["dynamic_done"][rank]):
                open(paths["dynamic_done"][rank], "w").close()
            if idle is not None:
                t = time.perf_counter()
                idle()
                idle = None
                out["seconds"]["idle work"] = time.perf_counter() - t
            t = time.perf_counter()
            wait_for_file(paths["recs"][m] + ".ready", deadline,
                          f"phase 5f's {m} thresholds")
            recs = torch.load(paths["recs"][m], weights_only=False)
            out["seconds"][f"{m} {act} wait"] = time.perf_counter() - t
        t = time.perf_counter()
        qparams, qctx = decoder_tree(model, recs)
        engine = ServingEngine(model, qparams, quant=qctx,
                               max_len=MOE_MAX_LEN, mesh=mesh)
        del qparams
        torch.cuda.empty_cache()
        if m == "moe":
            out["experts a rank"] = int(engine.params["blocks.0"]["moe"][
                "experts"]["gate"]["w"].data.shape[0])
        for call in calls:                   # warm-up, uncounted
            decoder_run(engine, batch, call, new=2)
        out["seconds"][f"{m} {act} build"] = time.perf_counter() - t
        for call in calls:
            name = f"{m} {call} {act}"
            res = run_counted(name, counts, lambda: decoder_run(
                engine, batch, call))
            out[name] = dict(outcome(res), launches=counts[name])
        out[f"{m} {act} logits"] = first_logits(engine, qctx, batch)
        del engine, model
        torch.cuda.empty_cache()
    out["seconds"]["all"] = time.perf_counter() - t0
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def start_decoder_tp(tp_ranks: dict) -> None:
    """Start phase 5f's dynamic runs on the ranks."""
    open(tp_ranks["go"], "w").close()


def end_decoder_tp_dynamic(tp_ranks: dict) -> None:
    """Wait for the ranks' dynamic runs to end."""
    t0 = time.perf_counter()
    wait_for_ranks(tp_ranks, tp_ranks["dynamic_done"], TP_DECODER_TIMEOUT_S,
                   "5f", load=False)
    log(f"5f: waited {time.perf_counter() - t0:.1f} s for the ranks' "
        "dynamic runs")


def hand_recs(tp_ranks: dict, recs: dict) -> None:
    """Give phase 5f's ranks each model's calibrated thresholds."""
    for m, r in recs.items():
        save_atomic(r, tp_ranks["recs"][m])
        open(tp_ranks["recs"][m] + ".ready", "w").close()


def check_decoder_tp(tp_ranks: dict, want: dict, moe_cfg) -> dict:
    """Phase 5f's results against phases 7's and 7b's unsharded runs of
    the same trees (``want``: outcome, launches and logits by run name):
    every rank's tokens, steps and host syncs equal, its logits equal the
    other rank's bit for bit and the unsharded ones as
    :func:`compare_logits` says, its launches of ``TP_EQUAL_LAUNCHES``
    equal the unsharded run's, K3 fused plus its accumulate half equal to
    the unsharded K3, both halves launched, and K7 run over ``E / TP``
    experts.  The ranks have freed their trees by then (before phase 7d)
    and go on to phase 5g.  Returns the launch counts of every run."""
    import torch

    t0 = time.perf_counter()
    ranks = wait_for_ranks(tp_ranks, tp_ranks["outs_5f"],
                           TP_DECODER_TIMEOUT_S, "5f")
    log(f"5f: waited {time.perf_counter() - t0:.1f} s for the ranks")
    E, D = moe_cfg.moe.n_experts, moe_cfg.d_model
    act_bytes = moe_cfg.activation_dtype.itemsize
    gather = {k: E * moe_expert_rows(moe_cfg, n) * D * act_bytes
              for k, n in (("decode", N_REQUESTS),
                           ("prefill", N_REQUESTS * moe_prompts(
                               moe_cfg.vocab)[0]["tokens"].shape[1]))}
    log(f"5f: the expert gather moves E·G·C·D activations a layer: "
        f"{gather['decode']} B a greedy decode step, {gather['prefill']} B "
        "a prefill")
    counts = {}
    shown = ("quantize_static", "quantize_rowwise", "int8_matmul",
             "int8_matmul_accumulate", "int8_matmul_epilogue",
             "decode_attention", "int8_matmul_batched")
    for r, got in enumerate(ranks):
        log(f"5f rank {r}: seconds "
            + json.dumps({k: round(v, 2) for k, v in got["seconds"].items()})
            + f", max_memory_allocated {got['max_memory_allocated']} B, "
            f"experts a rank {got['experts a rank']}")
        if got["experts a rank"] != E // TP:
            raise AssertionError(f"5f rank {r} holds "
                                 f"{got['experts a rank']} experts")
        for name, w in want.items():
            if name.endswith("logits"):
                compare_logits(f"5f rank {r} {name[:-len(' logits')]}",
                               got[name], w)
                continue
            g = got[name]
            gl, wl = g["launches"], w["launches"]
            counts[f"rank{r} {name}"] = gl
            bad = [k for k in ("tokens", "steps", "host_syncs")
                   if g[k] != w[k]]
            log(f"5f rank {r} {name}: tokens/s {g['tokens_per_s']:.1f} "
                f"(unsharded {w['tokens_per_s']:.1f}), steps {g['steps']}, "
                f"host_syncs {g['host_syncs']}, launches "
                + json.dumps({k: gl[k] for k in shown})
                + " (unsharded " + json.dumps({k: wl[k] for k in shown})
                + ")")
            if bad:
                n_eq = sum(a == b for a, b in zip(g["tokens"], w["tokens"]))
                raise AssertionError(
                    f"5f rank {r} {name} differs from the unsharded run in "
                    f"{bad} ({n_eq} of {len(w['tokens'])} token lists "
                    "equal)")
            off = [k for k in TP_EQUAL_LAUNCHES if gl[k] != wl[k]]
            if off or gl["int8_matmul"] + gl["int8_matmul_accumulate"] != \
                    wl["int8_matmul"] or gl["int8_matmul_accumulate"] <= 0 \
                    or gl["int8_matmul_epilogue"] != \
                    gl["int8_matmul_accumulate"] or (
                        name.startswith("moe")
                        and gl["int8_matmul_batched"] <= 0):
                raise AssertionError(f"5f rank {r} {name}: launches {gl} "
                                     f"against the unsharded {wl}")
    for name in want:
        if name.endswith("logits"):
            for a, b in zip(ranks[0][name], ranks[1][name]):
                if not torch.equal(a, b):
                    raise AssertionError(f"5f: the ranks' {name} differ")
    return counts


# ---------------------------------------------------------------------------
# phase 5g: training on a mesh, on phase 5e's two ranks
# ---------------------------------------------------------------------------

# model -> (arch, config overrides): phase 4t's transformer-base with
# float32 activations (the parity runs) and as phase 4t runs it (bf16
# activations, the timed runs), mistral-nemo-12b at its published widths
# and 2 of its 40 layers, and phase 7's granite-moe-1b-a400m at its
# published widths and 2 of its 24 layers (float32 activations); every
# config has the reference's remat=True
TRAIN_TP_MODELS = {"encdec": ("transformer-base", dict(dtype="float32")),
                   "encdec bf16": ("transformer-base", {}),
                   "dense": (DENSE_ARCH, dict(n_layers=2, dtype="float32")),
                   "moe": (MOE_ARCH, dict(n_layers=MOE_LAYERS,
                                          dtype="float32"))}
TRAIN_TP_MESHES = ((2, 1), (1, 2))     # every model's meshes
# transformer-base's parity steps on each mesh (the unsharded run takes
# one more: the checkpointed loop's restored step is held to it)
TRAIN_TP_STEPS = 2
TRAIN_TP_TIMED = 2                     # bf16 steps timed, after a warm-up
CKPT_STEPS = 2                         # the checkpointed (2, 1) loop's
# mistral-nemo-12b's mesh steps: the gather a layer (remat) on each mesh,
# and on (2, 1), where FSDP gathers, remat off beside it (every gathered
# leaf kept for the backward); (1, 2) beside the drivers, (2, 1) last,
# with the card to itself
DENSE_TRAIN_RUNS = {(1, 2): ("remat",), (2, 1): ("plain", "remat")}
DENSE_TRAIN_STEPS = 1
DENSE_TRAIN_BATCH = (8, 64)            # LMBatches rows, sequence length
# 1024 tokens a data rank of (2, 1): whole routing groups of 1024
MOE_TP_BATCH = (8, 256)
# tests/test_torch_train.py's tolerances: metrics 1e-5 relative; every
# gradient leaf |Δ| ≤ 1e-4·max|g| + 1e-8·‖g‖; the parameters within
# 1e-2·Σlr where the first moment has been 100 times its tolerance at
# every step so far, 2.5·Σlr elsewhere, 1e-6·max|p| on top
TRAIN_TP_RTOL = 1e-5
TRAIN_TP_GRAD_REL = 1e-4
TRAIN_TP_TIMEOUT_S = 1500              # a rank's whole run, from its start
COMPARE_CHUNK = 1 << 26                # elements compared at a time


def tp_train_model(name: str, device: str = "cuda"):
    """One of ``TRAIN_TP_MODELS``: (model, a function that makes its
    float32 weights from ``torch.Generator`` seed 0, the optimizer, the
    global batches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import LMBatches, TranslationBatches, make_corpus
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    arch, over = TRAIN_TP_MODELS[name]
    cfg = dataclasses.replace(get_config(arch), **over)
    model = build_model(cfg, device=device)

    def make():
        return model.init(torch.Generator(device=device).manual_seed(0))

    if cfg.enc_dec:
        # phase 4t's batch, every step
        batch = TranslationBatches(make_corpus(800, cfg.vocab, seed=0),
                                   TRAIN_BATCH,
                                   sort_mode="tokens").next_batch()
        n = TRAIN_TP_TIMED + 1 if name.endswith("bf16") else CKPT_STEPS + 1
        batches = [batch] * n
    else:
        src = LMBatches(cfg.vocab, *(MOE_TP_BATCH if cfg.moe else
                                     DENSE_TRAIN_BATCH))
        batches = [src.next_batch() for _ in range(DENSE_TRAIN_STEPS)]
    return model, make, AdamW(lr=warmup_cosine(2e-3, 2, 20)), batches


def grad_peak_adamw(opt):
    """``opt`` (an ``AdamW``) that appends the card's peak memory so far to
    its ``peaks`` as each update starts: the peak of a step's forward and
    backward, where the gathered leaves live (the whole step's peak is the
    update's, its scratch trees)."""
    import torch
    from repro_torch.optim import AdamW

    @dataclasses.dataclass(frozen=True)
    class GradPeakAdamW(AdamW):
        peaks: list = dataclasses.field(default_factory=list, compare=False)

        def update(self, *args, **kw):
            self.peaks.append(torch.cuda.max_memory_allocated())
            return super().update(*args, **kw)

    return GradPeakAdamW(**{f.name: getattr(opt, f.name)
                            for f in dataclasses.fields(opt)})


class RepeatBatches:
    """One batch every step, with the iterator state ``train_loop``
    checkpoints (phase 4t's batch for the checkpointed loop)."""

    def __init__(self, batch):
        self.batch, self.n = batch, 0

    def next_batch(self):
        self.n += 1
        return self.batch

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, state):
        self.n = state["n"]


def unsharded_train(model, params, opt, batches, ms=None, keep=None
                    ) -> list:
    """The unsharded step over ``batches``: each step's metrics (floats),
    parameters, first moment (copied to ``keep``, a device, where given)
    and the first moment's norm; ``ms``, a list, gets each step's host ms
    (a synchronise before and after)."""
    import torch
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    step = make_train_step(model, opt)
    p, s, out = params, opt.init(params), []
    del params                   # a caller's temporary goes after step 1
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        (p, s), m = step(p, s, b)
        metrics = {k: float(v) for k, v in m.items()}
        if ms is not None:
            ms.append((time.perf_counter() - t) * 1e3)
        m_norm = float(torch.linalg.vector_norm(torch.stack(
            [x.norm() for x in tree_leaves(s.m)]).double()))
        moved = (p, s.m) if keep is None else tree_map(
            lambda x: x.to(keep), (p, s.m))
        out.append((metrics, *moved, m_norm))
    return out


def worst_ratio(tree, leaf_specs, mesh, rank: int, check,
                gather: bool = True) -> float:
    """The largest ratio ``check(path, x, view)`` returns on rank 0 over
    the leaves of this rank's shard ``tree`` (0 on the other ranks):
    ``x`` the leaf made whole (``uncut``, one leaf at a time, every rank
    taking part) and ``view`` the identity, or with ``gather`` False
    rank 0's own block and ``view`` the cut of a whole leaf to it."""
    from repro_torch.distributed.sharding import cut, uncut
    from repro_torch.tree import leaves_with_paths
    worst = 0.0
    for (path, x), spec in zip(leaves_with_paths(tree), leaf_specs):
        if gather:
            x = uncut(x, spec, mesh, mesh.coords)
            view = (lambda t: t)
        else:
            view = (lambda t, spec=spec: cut(t, spec, mesh, mesh.coords))
        if rank == 0:
            worst = max(worst, check(path, x, view))
        del x
    return worst


def cut_tree(model, params, batch, mesh):
    """(``train_arg_specs``' parameter specs on ``mesh``, this rank's
    shard of the whole tree ``params``)."""
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch.specs import train_arg_specs
    specs = train_arg_specs(model.cfg, params, batch, mesh)[0]
    return specs, shard_params(params, specs, mesh, mesh.coords)


def sharded_train(model, opt, batches, mesh, specs, p, rank: int,
                  want=None, gather: bool = True, s=None,
                  keep_final: bool = False) -> dict:
    """``make_train_step(grad_shardings=...)`` on ``mesh`` over
    ``batches`` from this rank's shard ``p`` (:func:`cut_tree`) and ``s``
    (by default a fresh state): each step's metrics and host ms (a
    synchronise before and after).  With ``want`` (:func:`unsharded_train`,
    rank 0's; None on the others; False for a timed run), the gathered
    parameters after each step and the gathered first moment after the
    first (``0.1 ×`` the clipped gradient) against it leaf by leaf: the
    worst ratios of each difference to its bound (``"params"``:
    everywhere, where sure; ``"grads"``).  ``gather`` False holds rank
    0's own shard to its cut of ``want`` instead of the gathered trees
    (:func:`worst_ratio`).  ``keep_final``: this rank's final parameters
    and first moment, on the host (``"final"``)."""
    import torch
    from repro_torch.distributed.sharding import TreeSharding, spec_leaves
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves_with_paths, tree_map
    step = make_train_step(model, opt,
                           grad_shardings=TreeSharding(mesh, specs))
    s = opt.init(p) if s is None else s
    leaf_specs = spec_leaves(p, specs)
    out = {"metrics": [], "ms": [], "params": [0.0, 0.0], "grads": 0.0}
    lr = 0.0
    # an element is sure while its first moment has been 100 times its
    # tolerance at every step so far: one that was not may have stepped
    # either way then
    sure_so_far = {}
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        (p, s), m = step(p, s, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["ms"].append((time.perf_counter() - t) * 1e3)
        if want is False:                    # a timed run: no comparison
            continue
        lr += out["metrics"][-1]["lr"]
        ref = m_ref = {}
        m_norm = 0.0
        if rank == 0:
            ref = dict(leaves_with_paths(want[i][1]))
            m_ref = dict(leaves_with_paths(want[i][2]))
            m_norm = want[i][3]

        def param_ratio(path, whole, view):
            g = whole.reshape(-1)
            w = view(ref[path]).reshape(-1)
            mw = view(m_ref[path]).reshape(-1)
            pad = 1e-6 * float(w.abs().max())
            floor = 100 * (TRAIN_TP_GRAD_REL * float(mw.abs().max())
                           + 1e-8 * m_norm)
            before = sure_so_far.get(path)
            sure_now = torch.empty(g.numel(), dtype=torch.bool,
                                   device=g.device)
            worst = worst_sure = 0.0
            for lo in range(0, g.numel(), COMPARE_CHUNK):
                hi = lo + COMPARE_CHUNK
                err = (g[lo:hi] - w[lo:hi].to(g.device)).abs()
                sure = mw[lo:hi].to(g.device).abs() > floor
                if before is not None:
                    sure &= before[lo:hi]
                sure_now[lo:hi] = sure
                worst = max(worst, float(err.max()))
                if bool(sure.any()):
                    worst_sure = max(worst_sure, float(err[sure].max()))
            sure_so_far[path] = sure_now
            out["params"][1] = max(out["params"][1],
                                   worst_sure / (1e-2 * lr + pad))
            return worst / (2.5 * lr + pad)

        def grad_ratio(path, whole, view):
            g, w = whole.reshape(-1), view(m_ref[path]).reshape(-1)
            tol = TRAIN_TP_GRAD_REL * float(w.abs().max()) + 1e-8 * m_norm
            worst = max(float((g[lo:lo + COMPARE_CHUNK] - w[
                lo:lo + COMPARE_CHUNK].to(g.device)).abs().max())
                for lo in range(0, g.numel(), COMPARE_CHUNK))
            return worst / max(tol, 1e-30)

        out["params"][0] = max(out["params"][0], worst_ratio(
            p, leaf_specs, mesh, rank, param_ratio, gather))
        if i == 0:
            out["grads"] = worst_ratio(s.m, leaf_specs, mesh, rank,
                                       grad_ratio, gather)
    if keep_final:
        out["final"] = tree_map(lambda x: x.to("cpu"), (p, s.m))
    return out


def fsdp_bytes(params, specs, mesh) -> dict:
    """A step's FSDP traffic on ``mesh``, counted as whole float32
    leaves: gathered (the leaves split over the data axis), reduce-
    scattered (their gradients) and all-reduced (the gradients of the
    leaves the data group holds whole)."""
    from repro_torch.distributed.sharding import axis_dim, spec_leaves
    from repro_torch.tree import tree_leaves
    out = dict(gathered=0, reduce_scattered=0, all_reduced=0)
    if int(mesh.shape["data"]) == 1:
        return out
    for x, spec in zip(tree_leaves(params), spec_leaves(params, specs)):
        b = x.numel() * 4
        if axis_dim(spec, "data") is None:
            out["all_reduced"] += b
        else:
            out["gathered"] += b
            out["reduce_scattered"] += b
    return out


def compress_on_ranks(model, params, batch, rank: int, counts: dict
                      ) -> dict:
    """``tree_ef_compressed_mean`` of the ranks' float32 gradients (each
    rank's half of ``batch`` through the unsharded loss), counted, against
    the plain version's means and residuals bit for bit; then every
    leaf's codes from K1 and from the plain version at the shared
    threshold (counted differences, and those against the reference's
    division ``round(c / scale)``), and the two wire formulas."""
    import torch
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed.collectives import TPGroup
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten
    half = TRAIN_BATCH // 2
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    rows = {k: torch.as_tensor(v[rank * half:(rank + 1) * half],
                               device=leaves[0].device)
            for k, v in batch.items()}
    with torch.enable_grad():
        loss, _ = make_loss_fn(model)(tree_unflatten(params, leaves), rows)
        grads = tree_unflatten(params, [
            g.float() for g in torch.autograd.grad(loss, leaves)])
    del leaves
    group, n = TPGroup(rank, TP), TP
    err = comp.init_error_state(grads)
    mean, new_err = run_counted("5g compress", counts, lambda: (
        comp.tree_ef_compressed_mean(grads, err, group, n)))
    pmean, perr = comp.tree_ef_compressed_mean(grads, err, group, n,
                                               impl="torch")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((mean, new_err)), tree_leaves((pmean, perr))))
    cs = tree_leaves(grads)
    amaxes = comp.shared_amaxes(cs, group)
    differ = divided = divided_max = total = 0
    for c, a in zip(cs, amaxes):
        q = comp.compress(c, a)
        differ += int((q != comp.compress(c, a, impl="torch")).sum())
        scale = torch.full((), comp.scale_of(a), device=c.device)
        dq = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
        divided += int((q != dq).sum())
        divided_max = max(divided_max,
                          int((q.int() - dq.int()).abs().max()))
        total += c.numel()
    n_params = sum(c.numel() for c in cs)
    return {"same": same, "differ": differ, "divided": divided,
            "divided_max": divided_max,
            "codes": total, "leaves": len(cs),
            "fp32_allreduce": comp.wire_bytes_fp32_allreduce(n_params, n),
            "int8_gather": comp.wire_bytes_int8_gather(n_params, n),
            "launches": counts["5g compress"]}


def dense_unsharded(rank: int, out: dict) -> dict:
    """mistral-nemo-12b at 2 layers: rank 0's unsharded step, its trees
    kept on the host.  Returns the model, its weights' maker, the
    optimizer, the batches and that run (None on the other ranks), for
    :func:`dense_mesh_runs`."""
    import torch
    t = time.perf_counter()
    model, make, opt, batches = tp_train_model("dense")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    want = unsharded_train(model, make(), opt, batches, keep="cpu") \
        if rank == 0 else None
    torch.cuda.empty_cache()
    out["seconds"]["dense unsharded"] = time.perf_counter() - t
    if rank == 0:
        out["dense unsharded"] = [w[0] for w in want]
    out["dense unsharded peak"] = torch.cuda.max_memory_allocated()
    return dict(model=model, make=make, opt=opt, batches=batches, want=want)


def dense_mesh_runs(rank: int, meshes: dict, out: dict, shape,
                    dense: dict) -> None:
    """mistral-nemo-12b at 2 layers on ``shape``: the mesh step of each
    of ``DENSE_TRAIN_RUNS[shape]``, ``"remat"`` (a gather a layer) and
    ``"plain"`` (remat off: autograd keeps every gathered leaf, as a
    gather of the whole tree at the step's start did), each held to the
    unsharded step of ``dense`` (:func:`dense_unsharded`; rank 0's own
    shard), the two to each other bit for bit (every rank's shard), each
    one's memory at the loss, peak and ms.  The vocab-parallel
    cross-entropy's calls are counted into ``out``."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.tree import tree_leaves
    calls, at_loss = out.setdefault("dense ce calls", []), []
    real = step_mod.vocab_parallel_cross_entropy
    real_ce = step_mod.softmax_cross_entropy

    def counted(shard, *args):
        calls.append(tuple(shard.logits.shape))
        return real(shard, *args)

    def noted(*args):
        # the forward's end: what autograd holds for the backward (every
        # gathered leaf without remat), and the peak so far
        at_loss.append((torch.cuda.memory_allocated(),
                        torch.cuda.max_memory_allocated()))
        return real_ce(*args)

    model, make, opt, batches, want = (dense[k] for k in (
        "model", "make", "opt", "batches", "want"))
    models = {"remat": model,
              "plain": build_model(dataclasses.replace(model.cfg,
                                                       remat=False),
                                   device="cuda")}
    names = DENSE_TRAIN_RUNS[shape]
    step_mod.vocab_parallel_cross_entropy = counted
    step_mod.softmax_cross_entropy = noted
    try:
        t = time.perf_counter()
        specs, p = cut_tree(model, make(), batches[0], meshes[shape])
        finals = []
        for name in names:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            peaked = grad_peak_adamw(opt)
            at_loss.clear()
            # rank 0's half is held to the unsharded run: gathering the
            # tree through gloo's host path takes tens of seconds
            res = sharded_train(models[name], peaked, batches,
                                meshes[shape], specs, p, rank, want,
                                gather=False, keep_final=len(names) > 1)
            res["peak"] = torch.cuda.max_memory_allocated()
            res["grad peak"] = peaked.peaks[0]
            res["at loss"] = at_loss[0]
            if "final" in res:
                finals.append(res.pop("final"))
            out[f"dense {shape} {name}"] = res
        if finals:
            out[f"dense {shape} same bits"] = all(
                torch.equal(x, y) for x, y in zip(tree_leaves(finals[0]),
                                                  tree_leaves(finals[1])))
        del p, finals
        torch.cuda.empty_cache()
        out["seconds"][f"dense {shape}"] = time.perf_counter() - t
    finally:
        step_mod.vocab_parallel_cross_entropy = real
        step_mod.softmax_cross_entropy = real_ce


def ckpt_runs(rank: int, model, params, opt, batches, want, meshes: dict,
              directory: str, out: dict) -> None:
    """Phase 5g (a): ``train_loop`` with a ``Checkpointer`` on (2, 1) for
    ``CKPT_STEPS`` steps of phase 4t's batch, saved (whole arrays, one
    writer); restored onto (1, 2) on the ranks and onto the unsharded
    model on rank 0, one more step on each.  Records every step's
    metrics, the save's and restores' seconds and (rank 0) the saved
    keys, shapes and dtypes against the unsharded tree's."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.sharding import (TreeSharding,
                                                  shard_opt_state,
                                                  shard_params)
    from repro_torch.train import make_train_step, train_loop
    from repro_torch.tree import leaves_with_paths
    mesh = meshes[(2, 1)]
    specs, p = cut_tree(model, params, batches[0], mesh)
    ck = Checkpointer(directory)
    secs = {}
    real = ck.save

    def timed_save(*args, **kw):
        t = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            secs["save"] = time.perf_counter() - t

    ck.save = timed_save
    step = make_train_step(model, opt,
                           grad_shardings=TreeSharding(mesh, specs))
    res = train_loop(train_step=step, params=p, opt_state=shard_opt_state(
        opt.init(params), specs, mesh, mesh.coords),
        batches=RepeatBatches(batches[0]), steps=CKPT_STEPS, checkpointer=ck,
        log_every=1)
    out["ckpt loop"] = [{k: v for k, v in h.items() if k != "step"}
                        for h in res["history"]]
    del res, p
    if rank == 0:
        with np.load(os.path.join(directory, f"step_{CKPT_STEPS:08d}",
                                  "arrays.npz")) as data:
            saved = {k: (tuple(data[k].shape), str(data[k].dtype))
                     for k in data.files}
        whole = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                 for k, v in leaves_with_paths((params, opt.init(params)))}
        out["ckpt layout"] = (saved == whole, len(saved),
                              sum(int(np.prod(x[0])) for x in
                                  saved.values()))
    mesh = meshes[(1, 2)]
    specs = cut_tree(model, params, batches[0], mesh)[0]
    state = shard_opt_state(opt.init(params), specs, mesh, mesh.coords)
    t = time.perf_counter()
    p, s = Checkpointer(directory).restore(
        (shard_params(params, specs, mesh, mesh.coords), state),
        shardings=TreeSharding(mesh, (specs, state._replace(
            step=(), m=specs, v=specs))))
    secs["restore (1, 2)"] = time.perf_counter() - t
    out["ckpt (1, 2)"] = sharded_train(model, opt, batches[CKPT_STEPS:],
                                       mesh, specs, p, rank, want=False,
                                       s=s)["metrics"]
    del p, s
    if rank == 0:
        t = time.perf_counter()
        p, s = Checkpointer(directory).restore((params, opt.init(params)))
        secs["restore unsharded"] = time.perf_counter() - t
        step = make_train_step(model, opt)
        (_, _), m = step(p, s, batches[CKPT_STEPS])
        out["ckpt unsharded"] = [{k: float(v) for k, v in m.items()}]
        del p, s, m
    out["ckpt seconds"] = secs
    torch.cuda.empty_cache()


def moe_mesh_runs(rank: int, meshes: dict, out: dict) -> None:
    """Phase 5g (c): granite-moe-1b-a400m at 2 layers (32 experts top-8):
    rank 0's unsharded step, then the mesh step on each of
    ``TRAIN_TP_MESHES`` (16 experts a rank on (1, 2)), each step's
    metrics and every MoE layer's dropped fraction as the forward and
    remat's recomputation compute it."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.train import make_train_step
    model, make, opt, batches = tp_train_model("moe")
    real = transformer.moe_ffn
    dropped = []

    def record(*args, **kw):
        y, aux = real(*args, **kw)
        dropped.append(float(aux["dropped_fraction"]))
        return y, aux

    transformer.moe_ffn = record
    try:
        params = make()
        if rank == 0:
            step = make_train_step(model, opt)
            (_, _), m = step(params, opt.init(params), batches[0])
            out["moe unsharded"] = ([{k: float(v) for k, v in m.items()}],
                                    list(dropped))
            del m
        for shape in TRAIN_TP_MESHES:
            dropped.clear()
            specs, p = cut_tree(model, params, batches[0], meshes[shape])
            res = sharded_train(model, opt, batches, meshes[shape], specs,
                                p, rank, want=False)
            out[f"moe {shape}"] = (res["metrics"], list(dropped))
            del p
    finally:
        transformer.moe_ffn = real
    del params
    torch.cuda.empty_cache()


def train_tp_first(rank: int) -> dict:
    """Phase 5g's first runs on one rank (in 5f's wait for this process's
    thresholds, beside phases 7 and 7b): transformer-base's parity runs
    (float32 activations, ``TRAIN_TP_STEPS`` steps on each of
    ``TRAIN_TP_MESHES``, rank 0 holding the unsharded run), (c) the MoE
    runs (:func:`moe_mesh_runs`) and (b)'s unsharded mistral-nemo-12b
    step (:func:`dense_unsharded`).  Returns the state
    :func:`train_tp_runs` goes on from."""
    from repro_torch.distributed.context import prepare_remat
    from repro_torch.launch.mesh import make_host_mesh
    out = {"seconds": {}}
    meshes = {s: make_host_mesh(*s) for s in TRAIN_TP_MESHES}
    prepare_remat()            # on every rank before any timed step
    t = time.perf_counter()
    model, make, opt, batches = tp_train_model("encdec")
    params = make()
    want = unsharded_train(model, params, opt, batches) if rank == 0 \
        else None
    if rank == 0:
        out["encdec unsharded"] = [w[0] for w in want]
    for shape in TRAIN_TP_MESHES:
        out[f"encdec {shape}"] = sharded_train(
            model, opt, batches[:TRAIN_TP_STEPS], meshes[shape],
            *cut_tree(model, params, batches[0], meshes[shape]), rank, want)
    out["seconds"]["encdec parity"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_mesh_runs(rank, meshes, out)
    out["seconds"]["moe"] = time.perf_counter() - t
    dense = dense_unsharded(rank, out)
    return {"out": out, "meshes": meshes, "dense": dense,
            "encdec": (model, params, opt, batches, want)}


def train_tp_runs(rank: int, paths: dict, first=None) -> dict:
    """Phase 5g on one rank, after 5f (and :func:`train_tp_first`, run
    here where ``first`` is empty): (a) transformer-base's checkpointed
    loop and its restores (:func:`ckpt_runs`, in ``paths["ckpt_5g"]``), the
    compressor on the ranks' gradients and transformer-base's timed runs
    (bf16 activations: the unsharded step on rank 0 alone, then each
    mesh) and (b) mistral-nemo-12b at 2 layers on (1, 2), beside phase 7d
    and the drivers; then, once ``paths["card_5g"]`` marks the card free,
    (b) on (2, 1) (:func:`dense_mesh_runs`).  Returns the metrics,
    ratios, ms, bytes, launches, seconds and peak memory."""
    import torch
    import torch.distributed as dist
    first = first or train_tp_first(rank)
    out, meshes, counts = first["out"], first["meshes"], {}
    model, params, opt, batches, want = first.pop("encdec")
    t0 = t = time.perf_counter()
    ckpt_runs(rank, model, params, opt, batches, want, meshes,
              paths["ckpt_5g"], out)
    out["seconds"]["encdec checkpoint"] = time.perf_counter() - t
    del want
    out["compress"] = compress_on_ranks(model, params, batches[0], rank,
                                        counts)
    del model, params

    t = time.perf_counter()
    model, make, opt, batches = tp_train_model("encdec bf16")
    params = make()
    if rank == 0:
        ms = []
        unsharded_train(model, params, opt, batches, ms)
        out["encdec bf16 unsharded ms"] = ms[1:]
    dist.barrier()
    for shape in TRAIN_TP_MESHES:
        mesh = meshes[shape]
        specs, p = cut_tree(model, params, batches[0], mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = sharded_train(model, opt, batches, mesh, specs, p, rank,
                            want=False)
        res["ms"] = res["ms"][1:]
        res["peak"] = torch.cuda.max_memory_allocated()
        res["bytes"] = fsdp_bytes(params, specs, mesh)
        out[f"encdec bf16 {shape}"] = res
        del p
    del model, params
    torch.cuda.empty_cache()
    out["seconds"]["encdec timed"] = time.perf_counter() - t
    dense = first.pop("dense")
    dense_mesh_runs(rank, meshes, out, (1, 2), dense)
    # the (2, 1) ranks (the tied table whole on each) need the card to
    # themselves: the main process marks it free once its phases are done
    t = time.perf_counter()
    wait_for_file(paths["card_5g"], t + TRAIN_TP_TIMEOUT_S,
                  "the card to itself")
    out["seconds"]["card wait"] = time.perf_counter() - t
    dense_mesh_runs(rank, meshes, out, (2, 1), dense)
    out["seconds"]["after 5f"] = time.perf_counter() - t0
    return out


def check_train_tp(tp_ranks: dict) -> dict:
    """Phase 5g's results: every rank's metrics equal the other's bit for
    bit and, on rank 0, the unsharded runs' within ``TRAIN_TP_RTOL``; the
    gradients and parameters within their bounds (every ratio ≤ 1);
    mistral's remat and plain mesh steps the same bits on every rank, its
    loss vocab-parallel on (1, 2); the checkpointed loop's checkpoint an
    unsharded run's layout and its restored steps within
    ``TRAIN_TP_RTOL``; the MoE's metrics and dropped fractions; the
    compressor's means equal the plain version's and K1 launched.  Then
    the ranks are joined.  Logs ms a step against the unsharded step, the
    FSDP bytes, peak memory and seconds.  Returns the compressor's launch
    counts."""
    import shutil
    import statistics
    t0 = time.perf_counter()
    open(tp_ranks["card_5g"], "w").close()   # the (2, 1) runs may start
    try:
        ranks = wait_for_ranks(tp_ranks, tp_ranks["outs_5g"],
                               TRAIN_TP_TIMEOUT_S, "5g")
        for p in tp_ranks["procs"]:
            p.join(timeout=60)
        codes = [p.exitcode for p in tp_ranks["procs"]]
        if any(c != 0 for c in codes):
            raise AssertionError(f"5g ranks' exit codes {codes}")
    finally:
        shutil.rmtree(tp_ranks["tmp"], ignore_errors=True)
    log(f"5g: waited {time.perf_counter() - t0:.1f} s for the ranks")
    r0 = ranks[0]

    def same_on_ranks(key, part=lambda x: x["metrics"]):
        for r, other in enumerate(ranks[1:], 1):
            if part(other[key]) != part(r0[key]):
                raise AssertionError(f"5g {key}: rank {r}'s metrics "
                                     "differ from rank 0's")

    def worst_rel(got, want, keys=("loss", "ce_loss", "grad_norm", "lr")):
        if len(got) != len(want):
            raise AssertionError(f"5g: {len(got)} steps against "
                                 f"{len(want)}")
        return max(rel(g[k], w[k]) for g, w in zip(got, want) for k in keys)

    runs = [(f"encdec {shape}", r0["encdec unsharded"][:TRAIN_TP_STEPS])
            for shape in TRAIN_TP_MESHES] + [
        (f"dense {shape} {v}", r0["dense unsharded"])
        for shape, names in DENSE_TRAIN_RUNS.items() for v in names]
    for key, want in runs:
        got = r0[key]
        same_on_ranks(key)
        worst = worst_rel(got["metrics"], want)
        log(f"5g {key}: loss "
            + ", ".join(f"{g['loss']:.6f}" for g in got["metrics"])
            + " (unsharded " + ", ".join(f"{w['loss']:.6f}" for w in want)
            + f"), grad_norm {got['metrics'][0]['grad_norm']:.6f}; "
            f"largest relative metric difference {worst:.2e} "
            f"(bound {TRAIN_TP_RTOL}); "
            + ("gathered" if key.startswith("encdec") else
               "rank 0's half of the")
            + f" gradients at {got['grads']:.3f} of their bound, "
            f"parameters at {got['params'][0]:.3f} (everywhere) and "
            f"{got['params'][1]:.3f} (where sure) of theirs; ms a step "
            + ", ".join(f"{x:.1f}" for x in got["ms"])
            + (f"; max_memory_allocated "
               + ", ".join(f"rank {r} {x[key]['grad peak']} B to the "
                           f"update, {x[key]['peak']} B in all"
                           for r, x in enumerate(ranks))
               if "peak" in got else ""))
        if worst > TRAIN_TP_RTOL or got["grads"] > 1 or \
                max(got["params"]) > 1:
            raise AssertionError(f"5g {key} differs from the unsharded "
                                 "step")
    for shape in [s for s, v in DENSE_TRAIN_RUNS.items() if len(v) > 1]:
        plain, remat = (r0[f"dense {shape} {v}"] for v in ("plain",
                                                            "remat"))
        bits = [x[f"dense {shape} same bits"] for x in ranks]
        log(f"5g dense {shape}: remat against remat off: metrics "
            + ("bit for bit" if plain["metrics"] == remat["metrics"]
               else "differ")
            + f", every rank's parameters and first moment the same bits: "
            f"{bits}; a rank's memory at the loss (allocated, peak so "
            "far), remat off (every gathered leaf kept for the backward, "
            "as a gather of the whole tree at the step's start kept it) "
            + ", ".join(f"{x[f'dense {shape} plain']['at loss']} B"
                        for x in ranks)
            + ", remat on (a gather a layer) "
            + ", ".join(f"{x[f'dense {shape} remat']['at loss']} B"
                        for x in ranks))
        if plain["metrics"] != remat["metrics"] or not all(bits):
            raise AssertionError(f"5g dense {shape}: remat changed the "
                                 "step")
    calls = r0["dense ce calls"]
    log(f"5g dense: vocab-parallel cross-entropy calls {len(calls)}, "
        f"logits {calls[0] if calls else None} a rank; rank 0's unsharded "
        f"run {r0['dense unsharded peak']} B at peak; seconds "
        + json.dumps({k: round(v, 2) for k, v in r0["seconds"].items()
                      if k.startswith("dense")}))
    if len(calls) != DENSE_TRAIN_STEPS:
        raise AssertionError(f"5g dense: {len(calls)} vocab-parallel "
                             f"losses in {DENSE_TRAIN_STEPS} steps on "
                             "(1, 2)")
    # (a) the checkpointed loop and its restores
    want = r0["encdec unsharded"]
    for key, steps in (("ckpt loop", want[:CKPT_STEPS]),
                       ("ckpt (1, 2)", want[CKPT_STEPS:CKPT_STEPS + 1]),
                       ("ckpt unsharded", want[CKPT_STEPS:CKPT_STEPS + 1])):
        if key != "ckpt unsharded":
            same_on_ranks(key, part=lambda x: x)
        worst = worst_rel(r0[key], steps)
        log(f"5g encdec {key}: loss "
            + ", ".join(f"{g['loss']:.6f}" for g in r0[key])
            + f", largest relative metric difference to the unsharded "
            f"run's steps {worst:.2e} (bound {TRAIN_TP_RTOL})")
        if worst > TRAIN_TP_RTOL:
            raise AssertionError(f"5g encdec {key} differs from the "
                                 "unsharded run")
    same, n_keys, n_elems = r0["ckpt layout"]
    log(f"5g encdec checkpoint of (2, 1): {n_keys} arrays, {n_elems} "
        f"elements, keys, shapes and dtypes those of the unsharded tree: "
        f"{same}; seconds " + json.dumps(
            {f"rank {r} {k}": round(v, 3) for r, x in enumerate(ranks)
             for k, v in x["ckpt seconds"].items()}))
    if not same:
        raise AssertionError("5g: the mesh checkpoint's layout is not the "
                             "unsharded tree's")
    # (c) MoE
    want, want_dropped = r0["moe unsharded"]
    for shape in TRAIN_TP_MESHES:
        key = f"moe {shape}"
        same_on_ranks(key, part=lambda x: x)
        got, dropped = r0[key]
        worst = worst_rel(got, want, ("loss", "ce_loss",
                                      "load_balance_loss", "grad_norm"))
        dd = max(abs(a - b) for a, b in zip(dropped, want_dropped))
        log(f"5g {key}: loss {got[0]['loss']:.6f} (unsharded "
            f"{want[0]['loss']:.6f}), load_balance_loss "
            f"{got[0]['load_balance_loss']:.6f} "
            f"({want[0]['load_balance_loss']:.6f}); largest relative "
            f"metric difference {worst:.2e} (bound {TRAIN_TP_RTOL}); "
            f"dropped fractions " + ", ".join(f"{x:.6f}" for x in dropped)
            + f", largest |Δ| {dd:.2e}")
        if worst > TRAIN_TP_RTOL or len(dropped) != len(want_dropped) \
                or dd > 1e-6:
            raise AssertionError(f"5g {key} differs from the unsharded "
                                 "step")
    base = statistics.median(r0["encdec bf16 unsharded ms"])
    for shape in TRAIN_TP_MESHES:
        for r, got in enumerate(ranks):
            res = got[f"encdec bf16 {shape}"]
            med = statistics.median(res["ms"])
            log(f"5g encdec bf16 {shape} rank {r}: ms a step median "
                f"{med:.1f} ({', '.join(f'{x:.1f}' for x in res['ms'])}; "
                f"unsharded {base:.1f}, {med / base:.2f}×); FSDP bytes a "
                f"step {json.dumps(res['bytes'])}; "
                f"max_memory_allocated {res['peak']} B")
    counts = {}
    for r, got in enumerate(ranks):
        c = got["compress"]
        counts[f"rank{r} compress"] = c["launches"]
        log(f"5g compress rank {r}: {c['leaves']} leaves, K1 launches "
            f"{c['launches']['quantize_static']}; means and residuals "
            f"equal the plain version's: {c['same']}; codes differing from "
            f"the plain version's {c['differ']} of {c['codes']}, from the "
            f"reference's division {c['divided']} (by at most "
            f"{c['divided_max']}); wire bytes a step: "
            f"float32 all-reduce {c['fp32_allreduce']}, int8 gather "
            f"{c['int8_gather']}")
        if not c["same"] or c["differ"] or \
                c["launches"]["quantize_static"] != c["leaves"]:
            raise AssertionError(f"5g compress rank {r}: {c}")
        log(f"5g rank {r}: seconds "
            + json.dumps({k: round(v, 2) for k, v in
                          got["seconds"].items()}))
    return counts


# ---------------------------------------------------------------------------
# phase 6: INT4 weights through generate and serve
# ---------------------------------------------------------------------------

def run_int4(model, params, recs, batch, int8_greedy):
    """The INT4-weight path with the launch counts read from zero; the plain
    INT4 matmul must not run.  Returns (launch counts, quantized params and
    context, the greedy paged serve's result)."""
    import numpy as np
    import torch
    from repro_torch.core import QuantPolicy, count_quantized, quantize_model
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    qparams, qctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"),
                                   weight_bits=4, weight_group_size=INT4_GROUP)
    torch.cuda.synchronize()
    stats = count_quantized(qparams)
    log(f"quantize (weight_bits=4): {time.perf_counter() - t0:.3f} s, "
        f"INT4 weights: {stats['int4_linears']} decoder linears, "
        f"{stats['int4_bytes']} bytes (group_size={INT4_GROUP}); "
        f"INT8 elsewhere: {stats['int8_bytes']} bytes")
    if stats["int4_linears"] != 4 * model.cfg.n_layers:
        raise AssertionError(f"INT4 linears: {stats}")

    plain = ref.ref_int4_matmul
    plain_calls = []

    def counted(*args, **kwargs):
        plain_calls.append(1)
        return plain(*args, **kwargs)

    ref.ref_int4_matmul = counted
    corpus, budgets = serve_requests(model.cfg.vocab)
    try:
        ops.reset_launch_counts()
        engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN)
        runs = {"int4_greedy_static": engine.generate(
                    batch, max_new_tokens=MAX_NEW),
                "int4_beam4_static": engine.generate_beam(
                    batch, beam=BEAM, max_new_tokens=MAX_NEW)}
        paged_engine = ServingEngine(
            model, qparams, quant=qctx, max_len=MAX_LEN,
            burst_len=SERVE_BURST, paged=True, page_size=PAGE)
        served = paged_engine.serve(corpus, n_slots=SERVE_SLOTS,
                                    max_new_tokens=budgets)
        served_beam = paged_engine.serve(
            corpus[:BEAM_REQUESTS], n_slots=SERVE_SLOTS,
            max_new_tokens=budgets[:BEAM_REQUESTS], beam=BEAM)
        counts = ops.launch_counts()
    finally:
        ref.ref_int4_matmul = plain
    for name, r in runs.items():
        log(f"e2e {name}: tokens={r.n_tokens} steps={r.steps} "
            f"tokens_per_s={r.tokens_per_s:.1f} prefill_s={r.prefill_s:.4f} "
            f"decode_s={r.decode_s:.4f} host_syncs={r.host_syncs}")
        if len(r.tokens) != N_REQUESTS or any(
                len(t) > MAX_NEW for t in r.tokens):
            raise AssertionError(f"{name}: bad outputs")
    m = served.metrics()
    log(f"serve int4_paged: tokens={served.n_tokens} "
        f"tokens_per_s={served.tokens_per_s:.1f} "
        f"decode_steps={served.decode_steps} "
        f"host_syncs={served.host_syncs} "
        f"utilization={served.utilization:.3f} "
        f"first_token_mean_s={m['first_token_latency_mean_s']:.4f} "
        f"total_mean_s={m['total_latency_mean_s']:.4f} "
        f"page_hwm={served.page_hwm}")
    ratio = runs["int4_greedy_static"].tokens_per_s / int8_greedy.tokens_per_s
    log(f"INT4 / INT8 greedy static tokens/s: {ratio:.3f}")
    log(f"  launches: {json.dumps(counts)}; plain INT4 matmul calls: "
        f"{len(plain_calls)}")
    if counts["int4_matmul"] <= 0 or plain_calls:
        raise AssertionError(f"K6 launched {counts['int4_matmul']} times, "
                             f"its plain version {len(plain_calls)} times")
    m = served_beam.metrics()
    log(f"serve int4_paged_beam4: tokens={served_beam.n_tokens} "
        f"tokens_per_s={served_beam.tokens_per_s:.1f} "
        f"decode_steps={served_beam.decode_steps} "
        f"host_syncs={served_beam.host_syncs} "
        f"utilization={served_beam.utilization:.3f} "
        f"reorder_bytes={served_beam.reorder_bytes} "
        f"first_token_mean_s={m['first_token_latency_mean_s']:.4f} "
        f"total_mean_s={m['total_latency_mean_s']:.4f} "
        f"page_hwm={served_beam.page_hwm}")
    for label, res in (("INT4 serve", served),
                       ("INT4 beam serve", served_beam)):
        if res.pages_in_use or any(r.status != "finished"
                                   for r in res.requests):
            raise AssertionError(f"{label}: unfinished requests or pages "
                                 f"held")
        for r, b in zip(res.requests, budgets):
            t = np.asarray(r.tokens)
            if len(t) > b or (len(t) and not (
                    0 <= t.min() and t.max() < model.cfg.vocab)):
                raise AssertionError(f"{label}: bad output {t}")
    return counts, qparams, qctx, served


def profile_int4(model, qparams, qctx, batch) -> None:
    """A profiled INT4 greedy generate: busy time, idle share and K6's
    device time and launches (K6's kernel and its split's reduction)."""
    from repro_torch.serving import ServingEngine
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN)
    busy, rows, _ = profile("int4_greedy_static", lambda: engine.generate(
        batch, max_new_tokens=MAX_NEW).steps)
    k6 = [(ms, n) for ms, key, n in rows if "int4_matmul" in key]
    k3 = sum(ms for ms, key, _ in rows if "int8_matmul_kernel" in key
             or "int8_matmul_reduce_kernel" in key)
    k6_ms = sum(ms for ms, _ in k6)
    k6_kernels = sum(n for ms, n in k6)
    log(f"  K6 device time {k6_ms:.2f} ms in {k6_kernels} kernels (tile + "
        f"reduction) = {k6_ms / busy:.3f} of busy; K3 {k3:.2f} ms = "
        f"{k3 / busy:.3f}; {attention_ms(rows)}")
    if not k6_kernels:
        raise AssertionError("the profiled INT4 generate ran no K6 kernel")


# ---------------------------------------------------------------------------
# phase 4t: train → calibrate → quantize → translate
# ---------------------------------------------------------------------------

TRAIN_BATCH = 32               # transformer-base step: 32 sentences
TRAIN_STEPS = 20               # on one repeated batch
TRAIN_TIMED = slice(4, 20)     # steps 5-20 give the median step time
TRAIN_CPU_ROWS = 8             # the card-against-CPU step's rows
# relative bounds, bf16 activations, a few times the gaps measured on an
# H100: the card against the CPU, loss 6.9e-6 and gradient norm 9.7e-4;
# accum_steps=2 against the halves' mean, loss 0 and norm 9.9e-9 (the same
# kernels, summed in another order); mixed_precision against the plain
# step, loss 2.3e-6 and norm 2.4e-4 (bf16 leaves, the tied table's
# gradient among them)
TRAIN_LOSS_RTOL = 1e-4         # card vs CPU, and mixed vs plain
TRAIN_NORM_RTOL = 5e-3         # card vs CPU
ACCUM_RTOL = 1e-5              # loss and norm vs the halves' mean
MIXED_NORM_RTOL = 2e-3
MOE_TRAIN_BATCH = (8, 64)      # LMBatches rows, sequence length
# benchmarks/common.py:trained_tiny_nmt trains 900 steps; at 38 ms a step
# (host-bound) they took 35.5 s, over this phase's 40 s, so the run takes
# tests/conftest.py:trained_nmt's 500 (the issue's fallback)
TABLE1_STEPS = 500
# trained_tiny_nmt's reduced transformer-base and corpus
TABLE1_DIMS = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2,
                   d_ff=256, n_heads=4, n_kv_heads=4, head_dim=32)
TABLE1_CORPUS = dict(n_sentences=600, vocab=64, max_words=6, seed=0)
TABLE1_TEST = 96               # corpus[:96], as bench_calibration_modes
TABLE1_CALIB = slice(200, 260)
TABLE1_MAX_LEN = 64
REL_DROP = 0.005               # the paper's < 0.5% relative BLEU bar
# the paper's Table 1 (BLEU, drop against FP32 27.68)
PAPER_TABLE1 = {"naive": "n/a", "symmetric": "27.30 (-0.38)",
                "independent": "27.33 (-0.35)",
                "conjugate": "27.26 (-0.42)"}


def table1_rows():
    """The rows Table 1's linears and K4 see: greedy and beam-4 decode
    over the test sentences, and their sources' prefill."""
    from repro_torch.data import make_corpus, pad_batch
    test = make_corpus(**TABLE1_CORPUS)[:TABLE1_TEST]
    s_src = pad_batch([x.src for x in test])[0].shape[1]
    return TABLE1_TEST, TABLE1_TEST * BEAM, TABLE1_TEST * s_src


def step_ms(fn, n: int):
    """Run ``fn`` ``n`` times, each between two CUDA events: device-clock
    milliseconds of each call, host launch gaps included (a training step
    reads nothing back, so the host runs ahead unless it is the
    bottleneck)."""
    import torch
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    outs = []
    for start, end in events:
        start.record()
        outs.append(fn())
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], outs


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_transformer_base(model, params) -> None:
    """A full-width training step (bf16 activations, the phase-4 weights):
    the card against the CPU on 8 rows, 20 steps on one batch (the loss
    must fall; ms a step, target tokens/s, peak memory) with ``remat``
    on (the config's) and off, one step with
    ``accum_steps=2`` against the mean of the two halves' gradients taken
    outside the step, one with ``mixed_precision`` against the plain step,
    and a profiled step."""
    import statistics
    import torch
    from repro_torch.data import TranslationBatches, make_corpus
    from repro_torch.models import EncDecLM
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_loss_fn, make_train_step
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg = model.cfg
    opt = AdamW(lr=warmup_cosine(2e-3, 2, 20))
    host_batch = TranslationBatches(make_corpus(800, cfg.vocab, seed=0),
                                    TRAIN_BATCH,
                                    sort_mode="tokens").next_batch()
    # on the card once: a pageable upload each step would wait for the
    # card and keep the host from running ahead
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in host_batch.items()}
    state = opt.init(params)
    step = make_train_step(model, opt)
    n_leaves = len(tree_leaves(params))

    # the card against the CPU: the same step on the batch's first rows
    small = {k: v[:TRAIN_CPU_ROWS] for k, v in host_batch.items()}
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_step = make_train_step(EncDecLM(cfg, device="cpu"), opt)
    _, cpu_m = cpu_step(cpu_params, opt.init(cpu_params), small)
    cpu_s = time.perf_counter() - t0
    _, card_m = step(params, state, small)
    errs = {k: rel(float(card_m[k]), float(cpu_m[k]))
            for k in ("loss", "grad_norm")}
    log(f"train step, card vs CPU ({TRAIN_CPU_ROWS} rows, bf16 "
        f"activations): loss {float(card_m['loss']):.6f} vs "
        f"{float(cpu_m['loss']):.6f}, grad_norm "
        f"{float(card_m['grad_norm']):.6f} vs "
        f"{float(cpu_m['grad_norm']):.6f}; relative {errs['loss']:.2e} "
        f"(bound {TRAIN_LOSS_RTOL}), {errs['grad_norm']:.2e} (bound "
        f"{TRAIN_NORM_RTOL}); CPU step {cpu_s:.2f} s")
    if errs["loss"] > TRAIN_LOSS_RTOL or errs["grad_norm"] > TRAIN_NORM_RTOL:
        raise AssertionError(f"train step card vs CPU: {errs}")
    del cpu_params

    # learning: 20 steps on one batch, timed
    tgt_tokens = int(host_batch["tgt_lengths"].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, s = params, state

    def one():
        nonlocal p, s
        (p, s), m = step(p, s, batch)
        return m

    ms, metrics = step_ms(one, TRAIN_STEPS)
    losses = [float(m["loss"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(ms[TRAIN_TIMED])
    log(f"train transformer-base: {n_leaves} leaves, batch "
        f"{TRAIN_BATCH}x{batch['src_tokens'].shape[1]} src, "
        f"{batch['tgt_tokens'].shape[1]} tgt ({tgt_tokens} target tokens); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {TRAIN_STEPS} "
        f"steps; step_ms median(5-20)={med:.2f} (min {min(ms[TRAIN_TIMED]):.2f}"
        f", max {max(ms[TRAIN_TIMED]):.2f}, first {ms[0]:.2f}); "
        f"target_tokens_per_s={tgt_tokens / med * 1e3:.0f}; "
        f"max_memory_allocated={peak} B")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    plain = {k: float(metrics[0][k]) for k in ("loss", "grad_norm")}
    del p, s, metrics

    # the same 20 steps with remat off (the config's remat=True is the
    # reference's default): what recomputing each block costs this step
    off = make_train_step(EncDecLM(dataclasses.replace(cfg, remat=False),
                                   device="cuda"), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, s = params, state

    def one_off():
        nonlocal p, s
        (p, s), m = off(p, s, batch)
        return m

    ms_off, metrics = step_ms(one_off, TRAIN_STEPS)
    med_off = statistics.median(ms_off[TRAIN_TIMED])
    log(f"  remat off: step_ms median(5-20)={med_off:.2f} (min "
        f"{min(ms_off[TRAIN_TIMED]):.2f}, max {max(ms_off[TRAIN_TIMED]):.2f}"
        f"); target_tokens_per_s={tgt_tokens / med_off * 1e3:.0f}; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
        f"remat on/off {med / med_off:.3f}; losses the same bits: "
        f"{[float(m['loss']) for m in metrics] == losses}")
    del p, s, metrics, off

    # accum_steps=2 against the mean of the halves' losses and gradients,
    # each half's taken here with torch.autograd outside the step
    loss_fn = make_loss_fn(model)

    def loss_and_grads(rows):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        half = {k: v[rows] for k, v in batch.items()}
        with torch.enable_grad():
            loss, _ = loss_fn(tree_unflatten(params, leaves), half)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [
            torch.zeros_like(x) if g is None else g.float()
                             for x, g in zip(leaves, grads)]

    mid = TRAIN_BATCH // 2
    (l1, g1), (l2, g2) = (loss_and_grads(slice(0, mid)),
                          loss_and_grads(slice(mid, None)))
    accum_want = {"loss": (l1 + l2) / 2, "grad_norm": math.sqrt(sum(
        float(((a.double() + b.double()) / 2).square().sum())
        for a, b in zip(g1, g2)))}
    del g1, g2
    # name, options, the values it must match, their bounds
    for name, kw, want, bounds in (
            ("accum_steps=2", dict(accum_steps=2), accum_want,
             {"loss": ACCUM_RTOL, "grad_norm": ACCUM_RTOL}),
            ("mixed_precision", dict(mixed_precision=True), plain,
             {"loss": TRAIN_LOSS_RTOL, "grad_norm": MIXED_NORM_RTOL})):
        _, m = make_train_step(model, opt, **kw)(params, state, batch)
        got = {k: float(m[k]) for k in want}
        errs = {k: rel(got[k], want[k]) for k in want}
        log(f"  {name}: " + ", ".join(
            f"{k} {got[k]:.6f} vs {want[k]:.6f} (relative {errs[k]:.2e}, "
            f"bound {bounds[k]})" for k in want))
        if not all(math.isfinite(v) for v in got.values()) or any(
                errs[k] > bounds[k] for k in want):
            raise AssertionError(f"{name} step: {got} vs {want}")

    # one profiled step, and the optimizer's update profiled alone
    def profiled_step():
        step(params, state, batch)
        return 1

    busy, rows, _ = profile("train_step transformer-base", profiled_step)
    launches = sum(r[2] for r in rows)
    (_, s1), _ = step(params, state, batch)

    def profiled_update():
        opt.update(s1.m, state, params)
        return 1

    _, opt_rows, _ = profile("optimizer update alone", profiled_update)
    opt_launches = sum(r[2] for r in opt_rows)
    log(f"  device launches: step {launches}, optimizer update alone "
        f"{opt_launches} = {opt_launches / launches:.3f} of the step's "
        f"({n_leaves} leaves)")


def train_moe_step(model, params) -> None:
    """One training step of the full-width MoE model on its float32
    weights (phase 7 quantizes the same tree afterwards), timed on its
    second call: the loss finite, the load-balance loss positive, every
    leaf moved, and the weights passed in left as they were (held to a
    copy: with it the step takes some 53 GB of the card's 80)."""
    import torch
    from repro_torch.data import LMBatches
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves

    rows, seq = MOE_TRAIN_BATCH
    batch = LMBatches(model.cfg.vocab, rows, seq).next_batch()
    opt = AdamW(lr=warmup_cosine(2e-3, 2, 20))
    step = make_train_step(model, opt)
    before = [t.clone() for t in tree_leaves(params)]
    state = opt.init(params)
    step(params, state, batch)                  # warm-up, dropped
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, outs = step_ms(lambda: step(params, state, batch), 1)
    peak = torch.cuda.max_memory_allocated()
    (new, _), m = outs[0]
    loss, lb = float(m["loss"]), float(m["load_balance_loss"])
    moved = sum(not torch.equal(a, b) for a, b in
                zip(tree_leaves(new), before))
    intact = all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(params), before))
    log(f"train {model.cfg.name}: batch {rows}x{seq}, loss {loss:.4f} "
        f"(ce {float(m['ce_loss']):.4f}, load_balance {lb:.4f}), grad_norm "
        f"{float(m['grad_norm']):.4f}; step_ms {ms[0]:.1f} (second call); "
        f"max_memory_allocated={peak} B; {moved}/{len(before)} leaves "
        f"moved; weights passed in intact: {intact}")
    n_leaves = len(before)
    del outs, new, state, before
    torch.cuda.empty_cache()
    if not math.isfinite(loss) or lb <= 0 or moved != n_leaves or \
            not intact:
        raise AssertionError(f"MoE train step: loss {loss}, lb {lb}, moved "
                             f"{moved}/{n_leaves}, intact {intact}")


def run_table1():
    """The paper's Table 1 on a model the port trains here:
    ``benchmarks/common.py:trained_tiny_nmt``'s recipe (reduced
    transformer-base, inverse-sqrt warmup 200, Adam b2 0.98, batches of
    32), for ``TABLE1_STEPS`` steps, KL calibration on
    ``corpus[200:260]`` one sentence at a time
    (``bench_calibration_modes.py``), then each mode with static
    activation scales, greedy over ``corpus[:96]`` (24 new tokens), and
    beam 4 for FP and symmetric.  Returns the quantized runs' launch
    counts."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (FP_CONTEXT, Calibrator, QuantMode,
                                  QuantPolicy, Taps, quantize_model)
    from repro_torch.data import (TranslationBatches, corpus_bleu,
                                  make_corpus, pad_batch)
    from repro_torch.models import EncDecLM
    from repro_torch.optim import AdamW, inverse_sqrt
    from repro_torch.serving import ServingEngine
    from repro_torch.train import make_train_step

    cfg = get_config("transformer-base").reduced(**TABLE1_DIMS)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = AdamW(lr=inverse_sqrt(cfg.d_model, warmup=200), b2=0.98)
    state = opt.init(params)
    step = make_train_step(model, opt)
    corpus = make_corpus(**TABLE1_CORPUS)
    data = TranslationBatches(corpus, 32, sort_mode="tokens", seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in data.next_batch().items()}
               for _ in range(TABLE1_STEPS)]
    p, s = params, state

    def one(b):
        nonlocal p, s
        (p, s), m = step(p, s, b)
        return m["loss"]

    t0 = time.perf_counter()
    it = iter(batches)
    ms, losses = step_ms(lambda: one(next(it)), TABLE1_STEPS)
    train_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    params = p
    log(f"table1 training: {TABLE1_STEPS} steps in {train_s:.2f} s "
        f"(step_ms median {statistics.median(ms):.2f}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the last 50 "
        f"{float(np.mean(losses[-50:])):.4f})")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"table1 training did not lower the loss")

    cal = Calibrator()
    for sent in corpus[TABLE1_CALIB]:
        taps = Taps()
        tgt = np.concatenate([[1], sent.tgt, [2]])[None, :]
        model.forward(params, {
            "src_tokens": torch.as_tensor(sent.src[None, :], device="cuda"),
            "tgt_tokens": torch.as_tensor(tgt, device="cuda")}, taps=taps)
        cal.observe_taps(taps)
    test_set = corpus[:TABLE1_TEST]
    src, lens = pad_batch([s_.src for s_ in test_set])
    batch = {"src_tokens": src, "src_lengths": lens}
    src16, lens16 = pad_batch([s_.src for s_ in test_set[:N_REQUESTS]])
    batch16 = {"src_tokens": src16, "src_lengths": lens16}
    refs = [list(s_.tgt) for s_ in test_set]

    def translate(qparams, qctx, beam: int = 1):
        engine = ServingEngine(model, qparams, quant=qctx,
                               max_len=TABLE1_MAX_LEN)
        if beam == 1:
            res = engine.generate(batch, max_new_tokens=MAX_NEW)
        else:
            res = engine.generate_beam(batch, beam=beam,
                                       max_new_tokens=MAX_NEW)
        toks = [[int(t) for t in row] for row in res.tokens]
        if len(toks) != TABLE1_TEST or any(
                not 0 <= t < cfg.vocab for row in toks for t in row):
            raise AssertionError("table1: bad translation output")
        return corpus_bleu(toks, refs)

    bleu = {("fp", 1): translate(params, FP_CONTEXT),
            ("fp", BEAM): translate(params, FP_CONTEXT, BEAM)}
    counts = {}
    for mode in ("naive", "symmetric", "independent", "conjugate"):
        qparams, qctx = quantize_model(
            params, cal.compute(mode),
            QuantPolicy(mode=QuantMode(mode), act_quant="static"))
        # the kernels against their plain versions at this model's shapes
        # (the affine modes' zero point through K3's epilogue)
        log(f"table1 {mode}: kernels vs impl=\"torch\" on "
            f"{N_REQUESTS} sentences")
        check_against_plain(model, qparams, qctx, batch16,
                            max_len=TABLE1_MAX_LEN)
        beams = (1, BEAM) if mode == "symmetric" else (1,)
        for beam in beams:
            name = f"table1 {mode}" + (f" beam{beam}" if beam > 1 else "")
            bleu[(mode, beam)] = run_counted(
                name, counts, lambda: translate(qparams, qctx, beam))
            c = counts[name]
            # K1 quantizes where the thresholds are symmetric (symmetric,
            # conjugate); naive and independent thresholds are affine
            # (zero-point folded into K3's epilogue, as in the reference)
            need = ["int8_matmul", "decode_attention"] + (
                ["quantize_static"] if mode in ("symmetric", "conjugate")
                else [])
            if any(c[k] <= 0 for k in need):
                raise AssertionError(f"{name}: kernels {need} must launch, "
                                     f"got {c}")
    fp = bleu[("fp", 1)]
    if fp <= 10.0:
        raise AssertionError(f"table1: FP BLEU {fp} <= 10 ({bleu})")
    log(f"table1 (greedy, {TABLE1_TEST} sentences, {MAX_NEW} new tokens): "
        f"FP32 BLEU {fp:.2f}; beam {BEAM}: FP32 {bleu[('fp', BEAM)]:.2f}, "
        f"symmetric {bleu[('symmetric', BEAM)]:.2f}")
    for mode in ("naive", "symmetric", "independent", "conjugate"):
        b = bleu[(mode, 1)]
        log(f"  {mode:11s} BLEU {b:6.2f}  drop {b - fp:+.2f}  relative "
            f"{(fp - b) / fp:+.4f} (bar {REL_DROP}: "
            f"{'within' if b >= fp * (1 - REL_DROP) else 'past'})  paper: "
            f"{PAPER_TABLE1[mode]} from 27.68")
    return counts


# ---------------------------------------------------------------------------
# phase 7: the decoder-only MoE family through generate
# ---------------------------------------------------------------------------

def moe_prompts(vocab: int):
    """16 prompts and 16 held-out calibration prompts: the NMT corpus's
    sources drawn at the model's vocabulary.  The prompts are one
    right-padded batch with their lengths."""
    from repro_torch.data import make_corpus, pad_batch
    corpus = make_corpus(2 * N_REQUESTS, vocab, seed=11)
    toks, lens = pad_batch([s.src for s in corpus[:N_REQUESTS]])
    return ({"tokens": toks, "lengths": lens},
            [s.src for s in corpus[N_REQUESTS:]])


def run_moe(model, params):
    """granite-moe-1b-a400m at its published widths and ``MOE_LAYERS`` of
    its 24 layers (``model``, its random float32 weights ``params``), bf16
    activations: INT8 with
    dynamic activation scales (greedy and beam-4 ``generate``) and, after
    KL calibration on the held-out prompts, with static scales (greedy).
    Launch counts are read from zero over the three runs; K7's plain
    version must not run.  Returns (launch counts, static params and
    context, dynamic params and context, the prompt batch, and for phase
    5f each run's outcome, launches and first logits, and the
    thresholds)."""
    import torch
    from repro_torch.core import (Calibrator, QuantPolicy, Taps,
                                  count_quantized, quantize_model)
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServingEngine

    cfg, device = model.cfg, "cuda"
    t0 = time.perf_counter()
    batch, held_out = moe_prompts(cfg.vocab)
    dparams, dctx = quantize_model(params, {},
                                   QuantPolicy(act_quant="dynamic"),
                                   device=device)
    stats = count_quantized(dparams)
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, vocab "
        f"{cfg.vocab}; {N_REQUESTS} prompts padded to "
        f"{batch['tokens'].shape[1]}, max_len={MOE_MAX_LEN}, "
        f"max_new_tokens={MAX_NEW}; quantize "
        f"{time.perf_counter() - t0:.2f} s: {stats['quantized_linears']} "
        f"INT8 linears, {stats['int8_bytes']} bytes, "
        f"{stats['fp_linears']} fp linears (routers)")
    engine = ServingEngine(model, dparams, quant=dctx, max_len=MOE_MAX_LEN,
                           device=device)
    # warm-up: library handles and caches for these shapes (uncounted)
    engine.generate(batch, max_new_tokens=2)
    engine.generate_beam(batch, beam=BEAM, max_new_tokens=2)
    phase("MoE: counted runs")

    # the plain K7 and the plain quantizers are counted: on the card they
    # must not run
    plains = {(ref, "ref_int8_matmul_batched"): "K7",
              (ref, "ref_quantize_static"): "quantize",
              (ref, "ref_quantize_rowwise"): "quantize"}
    plain_calls = {"K7": 0, "quantize": 0}
    saved = {key: getattr(*key) for key in plains}

    def counted(fn, kind):
        def call(*args, **kwargs):
            plain_calls[kind] += 1
            return fn(*args, **kwargs)
        return call

    for (mod, name), kind in plains.items():
        setattr(mod, name, counted(saved[(mod, name)], kind))
    runs = {}
    try:
        ops.reset_launch_counts()
        runs["moe_greedy_dynamic"] = engine.generate(batch,
                                                     max_new_tokens=MAX_NEW)
        greedy_counts = ops.launch_counts()
        greedy_k7 = greedy_counts["int8_matmul_batched"]
        ops.reset_launch_counts()
        runs["moe_beam4_dynamic"] = engine.generate_beam(
            batch, beam=BEAM, max_new_tokens=MAX_NEW)
        beam_counts = ops.launch_counts()
        t0 = time.perf_counter()
        cal = Calibrator()
        for src in held_out:
            taps = Taps()
            model.forward(params, {"tokens": torch.as_tensor(
                src[None, :], device=device)}, taps=taps)
            cal.observe_taps(taps)
        recs = cal.compute("symmetric")
        sparams, sctx = quantize_model(params, recs,
                                       QuantPolicy(act_quant="static"),
                                       device=device)
        n_q = sum(r.quantize for r in recs.values())
        log(f"calibrate+quantize (static): "
            f"{time.perf_counter() - t0:.3f} s, {n_q}/{len(recs)} "
            f"calibrated sites quantizable")
        before_static = ops.launch_counts()
        static_engine = ServingEngine(model, sparams, quant=sctx,
                                      max_len=MOE_MAX_LEN, device=device)
        runs["moe_greedy_static"] = static_engine.generate(
            batch, max_new_tokens=MAX_NEW)
        after = ops.launch_counts()
        static_counts = {k: after[k] - before_static[k] for k in after}
        counts = {k: greedy_counts[k] + after[k] for k in after}
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
    for name, r in runs.items():
        log(f"e2e {name}: tokens={r.n_tokens} steps={r.steps} "
            f"tokens_per_s={r.tokens_per_s:.1f} prefill_s={r.prefill_s:.4f} "
            f"decode_s={r.decode_s:.4f} host_syncs={r.host_syncs}")
        if len(r.tokens) != N_REQUESTS:
            raise AssertionError(f"{name}: {len(r.tokens)} outputs")
        for t in r.tokens:
            if len(t) > MAX_NEW or (len(t) and not (
                    0 <= t.min() and t.max() < cfg.vocab)):
                raise AssertionError(f"{name}: bad output {t}")
    # three K7 launches a layer in each forward pass: the prefill and the
    # decode steps (all MAX_NEW - 1 of them while any row runs)
    per_pass = 3 * cfg.n_layers
    greedy = runs["moe_greedy_dynamic"]
    # one quantizer launch a quantized site and forward pass: q, k, v and o
    # of the attention and the three expert sites, K2 with dynamic scales,
    # K1 (or K2 where a site has no symmetric threshold) with static ones
    quant_pass = (4 + 3) * cfg.n_layers
    static = runs["moe_greedy_static"]
    k2 = greedy_counts["quantize_rowwise"]
    k1k2_static = (static_counts["quantize_static"]
                   + static_counts["quantize_rowwise"])
    log(f"  launches: {json.dumps(counts)}; K7 in the greedy dynamic run: "
        f"{greedy_k7} ({per_pass} a forward pass, {greedy.steps} passes); "
        f"K2 {k2} and K1 {greedy_counts['quantize_static']} ({quant_pass} a "
        f"pass); greedy static: K1 {static_counts['quantize_static']}, K2 "
        f"{static_counts['quantize_rowwise']} ({static.steps} passes); plain "
        f"K7 calls: {plain_calls['K7']}, plain (eager) quantizer calls: "
        f"{plain_calls['quantize']}")
    if plain_calls["K7"] or greedy_k7 < per_pass * greedy.steps or (
            greedy.steps == MAX_NEW and greedy_k7 != per_pass * MAX_NEW):
        raise AssertionError(f"K7 launched {greedy_k7} times in the greedy "
                             f"run, its plain version {plain_calls['K7']} "
                             "times")
    def per_pass_ok(n, r):   # as K7: every pass ran, all MAX_NEW of them
        return n >= quant_pass * r.steps and (
            r.steps != MAX_NEW or n == quant_pass * MAX_NEW)

    if plain_calls["quantize"] or greedy_counts["quantize_static"] or \
            not per_pass_ok(k2, greedy) or \
            not per_pass_ok(k1k2_static, static) or \
            static_counts["quantize_static"] <= 0:
        raise AssertionError(
            f"MoE quantizers: K2 {k2} in the greedy dynamic run, K1 + K2 "
            f"{k1k2_static} in the greedy static run, against {quant_pass} a "
            f"forward pass; eager quantizer calls {plain_calls['quantize']}")
    path = ("int8_matmul_batched", "int8_matmul", "quantize_static",
            "quantize_rowwise", "decode_attention")
    if any(counts[k] <= 0 for k in path) or counts["int4_matmul"] or \
            counts["decode_attention_paged"]:
        raise AssertionError(f"MoE path launches: {counts}")
    want = {"moe greedy dynamic": dict(outcome(greedy),
                                       launches=greedy_counts),
            "moe beam4 dynamic": dict(outcome(runs["moe_beam4_dynamic"]),
                                      launches=beam_counts),
            "moe greedy static": dict(outcome(static),
                                      launches=static_counts),
            "moe dynamic logits": first_logits(engine, dctx, batch),
            "moe static logits": first_logits(static_engine, sctx, batch),
            "recs": recs}
    return counts, (sparams, sctx), (dparams, dctx), batch, want


def profile_moe(model, qparams, qctx, batch) -> None:
    """A profiled greedy MoE generate: busy time, idle share and K7's
    share of the device time."""
    from repro_torch.serving import ServingEngine
    engine = ServingEngine(model, qparams, quant=qctx, max_len=MOE_MAX_LEN)
    busy, rows, _ = profile("moe_greedy_dynamic", lambda: engine.generate(
        batch, max_new_tokens=MAX_NEW).steps)
    # K7: int8_matmul_batched_kernel (+ _reduce_kernel); K3: int8_matmul_
    # kernel and int8_matmul_reduce_kernel
    k7 = sum(ms for ms, key, _ in rows if "int8_matmul_batched" in key)
    k3 = sum(ms for ms, key, _ in rows if "int8_matmul_kernel" in key
             or "int8_matmul_reduce_kernel" in key)
    log(f"  K7 device time {k7:.2f} ms = {k7 / busy:.3f} of busy; "
        f"K3 {k3:.2f} ms = {k3 / busy:.3f}; {attention_ms(rows)}")


# ---------------------------------------------------------------------------
# phase 7b: the dense SwiGLU family at full width
# phase 7c: the audio stub's src_embeds input at full width
# ---------------------------------------------------------------------------

DENSE_CALIB = 8                # held-out prompts for its KL calibration
DENSE_PROFILE_NEW = 8          # new tokens of the profiled greedy call
AUDIO_ARCH = "whisper-base"
AUDIO_ROWS, AUDIO_FRAMES = 4, 1500
AUDIO_STEPS = 8                # decode steps held against impl="torch"
AUDIO_MAX_LEN = 16


def dense_kernel_shapes(s_prompt: int, cfg):
    """(K1/K2 (M, K) list, K3 (M, K, N) list, K4 (B, S, H, HKV, dh)) of
    the dense phase: greedy decode (16 rows) and the prefill over the 16
    prompts padded to ``s_prompt``; q/k/v/gate/up read d_model, o reads
    H·hd, down d_ff."""
    d, qd, kvd, ff = (cfg.d_model, cfg.n_heads * cfg.hd,
                      cfg.n_kv_heads * cfg.hd, cfg.d_ff)
    rows = (N_REQUESTS, N_REQUESTS * s_prompt)
    quant = [(M, K) for M in rows for K in (d, qd, ff)]
    gemms = [(M, K, N) for M in rows
             for K, N in ((d, qd), (d, kvd), (d, ff), (qd, d), (ff, d))]
    attn = (N_REQUESTS, MOE_MAX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    return quant, gemms, attn


def tp_dense_gemms(cfg, tp: int = TP):
    """Phase 5f's K3 shapes of the dense model on ``tp`` ranks at 16 rows:
    (the column-parallel linears, fused: q, k/v, gate/up at N / tp; the
    row-parallel ones, K3's halves: o and down at K / tp)."""
    d, qd, kvd, ff = (cfg.d_model, cfg.n_heads * cfg.hd,
                      cfg.n_kv_heads * cfg.hd, cfg.d_ff)
    col = [(N_REQUESTS, d, n // tp) for n in (qd, kvd, ff)]
    row = [(N_REQUESTS, k // tp, d) for k in (qd, ff)]
    return col, row


def check_deep_against_plain(model, qparams, qctx, batch, steps: int = 3, *,
                             max_len: int = MOE_MAX_LEN):
    """A path's kernels against their plain versions, over the prefill and
    the first ``steps`` decode steps, every comparison bit for bit:

    * K1-K3: the same run with ``impl="torch"`` but K4's kernel in both
      paths gives the same logits;
    * K4: each call of the kernel path held on the spot against its plain
      version on the same inputs, within phase 3's tolerance (one bf16
      ulp); the outputs that differ are recorded, call by call;
    * every plain version, K4's too: where no K4 output differed, the
      all-plain run gives the same logits; else the all-plain run with
      each K4 output moved by the kernel's recorded differences at the
      same call and position (the witness) gives the K4-kernel run's
      logits, so the all-plain drift, which is logged, comes from those
      ulps alone: a bf16 ulp of K4's output flips activation codes
      downstream, and over tens of random-weight layers that can move the
      logits by whole units."""
    import torch
    from repro_torch.kernels import ops, ref

    real = ops.decode_attention
    k4 = {"calls": 0, "outputs": 0, "differ": 0, "max": 0.0}
    moves = []                    # (flat positions, kernel - plain) a call

    def k4_checked(q, kq, ks, vq, vs, lengths, *, sm_scale, impl="auto"):
        out = real(q, kq, ks, vq, vs, lengths, sm_scale=sm_scale,
                   impl="cuda")
        want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths,
                                        sm_scale)
        if not torch.allclose(out.float(), want.float(), atol=1e-5,
                              rtol=2.0 ** -7):
            raise AssertionError("decode_attention on the path is more "
                                 "than a bf16 ulp from its plain version")
        d = (out.float() - want.float()).flatten()
        at = torch.nonzero(d).flatten()
        moves.append((at, d[at]))
        k4["calls"] += 1
        k4["outputs"] += d.numel()
        k4["differ"] += at.numel()
        k4["max"] = max(k4["max"], float(d.abs().max()))
        return out

    def k4_kernel(q, kq, ks, vq, vs, lengths, *, sm_scale, impl="auto"):
        return real(q, kq, ks, vq, vs, lengths, sm_scale=sm_scale,
                    impl="cuda")

    replayed = iter(moves)

    def k4_plain_moved(q, kq, ks, vq, vs, lengths, *, sm_scale,
                       impl="auto"):
        want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths,
                                        sm_scale)
        at, d = next(replayed)
        moved = want.float().flatten()
        moved[at] += d
        return moved.view(want.shape).to(want.dtype)

    def run(ctx, attention):
        ops.decode_attention = attention
        try:
            b = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch.items()}
            rows = next(iter(b.values())).shape[0]
            st = model.init_decode_state(rows, max_len, quantized=True)
            logits, st = model.prefill(qparams, b, st, quant=ctx)
            out = [logits]
            for _ in range(steps):
                tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
                logits, st = model.decode_step(qparams, tok, st, quant=ctx)
                out.append(logits)
            return out
        finally:
            ops.decode_attention = real

    plain_ctx = dataclasses.replace(qctx, impl="torch")
    kern = run(qctx, k4_checked)
    k13 = run(plain_ctx, k4_kernel)
    plain = run(plain_ctx, real)
    witness = run(plain_ctx, k4_plain_moved) if k4["differ"] else plain
    for step, (a, b, c, w) in enumerate(zip(kern, k13, plain, witness)):
        for x in (a, b, c, w):
            if not torch.isfinite(x).all():
                raise AssertionError(f"non-finite logits at step {step}")
        drift = float((a - c).abs().max())
        agree = float((a.argmax(-1) == c.argmax(-1)).float().mean())
        log(f"logits step {step}: K1-K3 vs plain (K4's kernel in both) "
            f"{'equal' if torch.equal(a, b) else 'DIFFER'}; every plain "
            f"version {drift:.3g} (argmax agreement {agree:.3f}), with K4's "
            f"recorded ulps {'equal' if torch.equal(b, w) else 'DIFFER'}; "
            f"max |logit| {float(c.abs().max()):.3g}")
        if not torch.equal(a, b):
            raise AssertionError(f"step {step}: K1-K3 and their plain "
                                 f"versions differ by "
                                 f"{float((a - b).abs().max())}")
        if not torch.equal(b, w):
            raise AssertionError(
                f"step {step}: the all-plain path with K4's recorded ulps "
                f"differs from the K4-kernel path by "
                f"{float((b - w).abs().max())}")
    log(f"  K4 on the path's inputs: {k4['calls']} calls, {k4['differ']} "
        f"of {k4['outputs']} outputs differ from its plain version, at "
        f"most by {k4['max']:.3g} (one bf16 ulp allowed); "
        + ("the all-plain path moved by them equals the kernel path"
           if k4["differ"] else "the all-plain path equals the kernel "
           "path"))


def run_dense():
    """mistral-nemo-12b at its published widths and ``DENSE_LAYERS`` of its
    40 layers (d_model 5120, 32 heads of 128 over 8, d_ff 14336, vocab
    131072),
    random float32 weights from ``torch.Generator`` seed 0, bf16
    activations, on phase 7's 16 right-padded prompts: INT8 greedy
    ``generate`` with dynamic scales, then, after KL calibration on 8
    held-out prompts, with static scales; a prefill from ``embeds`` equal
    to the prompts' embedding rows against the token prefill (bit for
    bit); each run's kernels against their plain versions; a profiled
    greedy call.  Returns the launch counts of the two generate runs, and
    for phase 5f each run's outcome, launches and first logits, and the
    thresholds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (Calibrator, QuantPolicy, Taps,
                                  count_quantized, quantize_model)
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(DENSE_ARCH), n_layers=DENSE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    log(f"{cfg.name}: memory allocated before the phase "
        f"{torch.cuda.memory_allocated()} B")
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_el = sum(p.numel() for p in tree_leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, rope theta {cfg.rope_theta:g}; "
        f"init {time.perf_counter() - t0:.2f} s: {n_el} float32 elements "
        f"({4 * n_el} B; one table embeds and unembeds), the reference "
        f"formula's n_params {cfg.n_params}")
    batch, held_out = moe_prompts(cfg.vocab)
    counts = {}
    pass_sites = 7 * cfg.n_layers        # q, k, v, o, gate, up, down

    def check_counts(name, r, quantizer):
        c = counts[name]
        passes = r.steps                 # the prefill and each decode step
        want = {quantizer: pass_sites * passes,
                "int8_matmul": pass_sites * passes,
                "decode_attention": cfg.n_layers * (passes - 1)}
        bad = {k: (c[k], n) for k, n in want.items() if c[k] != n}
        others = [k for k in c if k not in want and c[k]]
        if bad or others or r.steps != MAX_NEW:
            raise AssertionError(f"{name}: launches {c} against {want} "
                                 f"({r.steps} passes)")

    def log_run(name, r):
        log(f"e2e {name}: tokens={r.n_tokens} steps={r.steps} "
            f"tokens_per_s={r.tokens_per_s:.1f} prefill_s={r.prefill_s:.4f} "
            f"decode_s={r.decode_s:.4f} host_syncs={r.host_syncs}")
        if len(r.tokens) != N_REQUESTS or any(
                len(t) > MAX_NEW or (len(t) and not (
                    0 <= t.min() and t.max() < cfg.vocab)) for t in r.tokens):
            raise AssertionError(f"{name}: bad outputs")

    # dynamic scales: no calibration needed
    t0 = time.perf_counter()
    dparams, dctx = quantize_model(params, {},
                                   QuantPolicy(act_quant="dynamic"))
    torch.cuda.synchronize()
    stats = count_quantized(dparams)
    log(f"quantize (dynamic) {time.perf_counter() - t0:.2f} s: "
        f"{stats['quantized_linears']} INT8 linears, {stats['int8_bytes']} "
        f"B; float tensors {stats['fp_bytes']} B; {N_REQUESTS} prompts "
        f"padded to {batch['tokens'].shape[1]}, max_len={MOE_MAX_LEN}, "
        f"max_new_tokens={MAX_NEW}")
    engine = ServingEngine(model, dparams, quant=dctx, max_len=MOE_MAX_LEN)
    engine.generate(batch, max_new_tokens=2)          # warm-up, uncounted
    r = run_counted("dense greedy dynamic", counts, lambda: engine.generate(
        batch, max_new_tokens=MAX_NEW))
    log_run("dense greedy dynamic", r)
    check_counts("dense greedy dynamic", r, "quantize_rowwise")
    want = {"dense greedy dynamic": dict(
                outcome(r), launches=counts["dense greedy dynamic"]),
            "dense dynamic logits": first_logits(engine, dctx, batch)}
    phase("7b: against the plain versions, dynamic scales")
    check_deep_against_plain(model, dparams, dctx, batch)
    del engine, dparams
    torch.cuda.empty_cache()

    phase("7b: calibrate, static scales")
    t0 = time.perf_counter()
    cal = Calibrator()
    t_fwd = 0.0
    for src in held_out[:DENSE_CALIB]:
        t1 = time.perf_counter()
        taps = Taps()
        model.forward(params, {"tokens": torch.as_tensor(
            src[None, :], device="cuda")}, taps=taps)
        t_fwd += time.perf_counter() - t1
        cal.observe_taps(taps)
    t1 = time.perf_counter()
    recs = cal.compute("symmetric")
    t_kl = time.perf_counter() - t1
    t1 = time.perf_counter()
    sparams, sctx = quantize_model(params, recs,
                                   QuantPolicy(act_quant="static"))
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t1
    n_q = sum(rec.quantize for rec in recs.values())
    log(f"calibrate ({DENSE_CALIB} held-out prompts, {len(recs)} sites: "
        f"forwards with taps {t_fwd:.2f} s, KL search {t_kl:.2f} s) "
        f"{time.perf_counter() - t0 - t_q:.2f} s; quantize (static) "
        f"{t_q:.2f} s; {n_q}/{len(recs)} sites quantizable")
    if n_q != len(recs) or len(recs) != pass_sites:
        raise AssertionError(f"{n_q} of {len(recs)} sites quantizable")
    want["recs"] = recs
    del params, recs, cal
    torch.cuda.empty_cache()
    log(f"float32 tree freed: {torch.cuda.memory_allocated()} B allocated")
    engine = ServingEngine(model, sparams, quant=sctx, max_len=MOE_MAX_LEN)
    engine.generate(batch, max_new_tokens=2)          # warm-up, uncounted
    r = run_counted("dense greedy static", counts, lambda: engine.generate(
        batch, max_new_tokens=MAX_NEW))
    log_run("dense greedy static", r)
    check_counts("dense greedy static", r, "quantize_static")
    want["dense greedy static"] = dict(
        outcome(r), launches=counts["dense greedy static"])
    want["dense static logits"] = first_logits(engine, sctx, batch)
    log(f"  launch counts met: K1 or K2 and K3 {pass_sites} a forward "
        f"pass, K4 {cfg.n_layers} a decode step, no other kernel, no plain "
        "version")

    # the VLM path: embeds equal to the prompts' embedding rows
    tok = torch.as_tensor(batch["tokens"], device="cuda")
    lens = torch.as_tensor(batch["lengths"], device="cuda")
    embeds = sparams["embed"]["table"][tok.long()]
    outs = []
    for b in ({"tokens": tok, "lengths": lens},
              {"embeds": embeds, "lengths": lens}):
        st = model.init_decode_state(N_REQUESTS, MOE_MAX_LEN, quantized=True)
        logits, st = model.prefill(sparams, b, st, quant=sctx)
        outs.append((logits, st["cache"]))
    (l0, c0), (l1, c1) = outs
    same = {"logits": torch.equal(l0, l1)}
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        same[name] = torch.equal(getattr(c0, name), getattr(c1, name))
    log(f"embeds prefill == token prefill, bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"the embeds prefill differs: {same}")
    del outs, l0, l1, c0, c1, embeds, st

    phase("7b: against the plain versions, static scales")
    check_deep_against_plain(model, sparams, sctx, batch)
    phase("7b: profile")
    busy, rows, _ = profile("dense greedy static", lambda: engine.generate(
        batch, max_new_tokens=DENSE_PROFILE_NEW).steps, cpu=False)
    k3 = sum(ms for ms, key, _ in rows if "int8_matmul_kernel" in key
             or "int8_matmul_reduce_kernel" in key)
    log(f"  K3 device time {k3:.2f} ms = {k3 / busy:.3f} of busy; "
        f"{attention_ms(rows)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{cfg.name}: max_memory_allocated={peak} B over the phase "
        f"(at {time.perf_counter() - T_START:.1f} s)")
    del engine, sparams
    torch.cuda.empty_cache()
    return counts, want


def run_audio():
    """whisper-base at its published widths (6+6 layers, d_model 512,
    vocab 51865), random float32 weights from ``torch.Generator`` seed 0,
    bf16 activations, INT8 with dynamic scales, fed the audio stub's
    ``src_embeds``: 4 × 1500 random frames (lengths 1500 down to 751).
    Greedy ``generate`` of 8 tokens (K2, K3, K4 launched, no plain
    version), then the prefill and 8 decode steps against their plain
    versions (:func:`check_deep_against_plain`).  Returns the generate
    run's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy, quantize_model
    from repro_torch.models import EncDecLM
    from repro_torch.serving import ServingEngine

    cfg = get_config(AUDIO_ARCH)
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    qparams, qctx = quantize_model(params, {},
                                   QuantPolicy(act_quant="dynamic"))
    del params
    # the frames are made on the card from a seed; the engine takes host
    # arrays, as a caller's batch
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((AUDIO_ROWS, AUDIO_FRAMES, cfg.d_model),
                         generator=gen, device="cuda") * 0.5
    lens = torch.linspace(AUDIO_FRAMES, AUDIO_FRAMES // 2 + 1, AUDIO_ROWS)
    batch = {"src_embeds": frames.cpu().numpy(),
             "src_lengths": lens.round().to(torch.int32).numpy()}
    log(f"{cfg.name}: {cfg.n_enc_layers}+{cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}; src_embeds "
        f"{tuple(frames.shape)}, lengths {batch['src_lengths'].tolist()}")
    engine = ServingEngine(model, qparams, quant=qctx,
                           max_len=AUDIO_MAX_LEN)
    engine.generate(batch, max_new_tokens=2)          # warm-up, uncounted
    counts = {}
    r = run_counted("whisper greedy dynamic", counts, lambda: engine.generate(
        batch, max_new_tokens=AUDIO_STEPS))
    log(f"e2e whisper greedy dynamic: tokens={r.n_tokens} steps={r.steps} "
        f"tokens_per_s={r.tokens_per_s:.1f} prefill_s={r.prefill_s:.4f} "
        f"decode_s={r.decode_s:.4f} host_syncs={r.host_syncs}")
    c = counts["whisper greedy dynamic"]
    if any(c[k] <= 0 for k in ("quantize_rowwise", "int8_matmul",
                               "decode_attention")) or len(r.tokens) != \
            AUDIO_ROWS:
        raise AssertionError(f"whisper: launches {c}, {len(r.tokens)} rows")
    check_deep_against_plain(model, qparams, qctx, batch, steps=AUDIO_STEPS,
                             max_len=AUDIO_MAX_LEN)
    del engine, qparams
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 7d: the recurrent families at full width
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
# phase 7d runs both models at their published widths, which give every
# kernel shape: zamba2-2.7b at 13 of its 54 layers (2 applications of the
# shared attention block) and xlstm-1.3b at 8 of its 48 (its pattern
# kept: the depth must divide by its sLSTM period of 8), to pay for phases
# 5f (xlstm 48 -> 24) and 5g (zamba2 54 -> 27 -> 13, xlstm 24 -> 16 -> 8)
RECURRENT_LAYERS = {"zamba2-2.7b": 13, "xlstm-1.3b": 8}
RECURRENT_CALIB = 8            # held-out prompts for the KL calibration
RECURRENT_PROFILE_NEW = 8      # new tokens of the profiled greedy call


def linears_a_pass(model, qparams) -> int:
    """INT8 linears a forward pass runs: each quantized linear of the tree
    once, the hybrid's shared block once an application."""
    from repro_torch.core import count_quantized
    return sum(count_quantized(node)["quantized_linears"]
               * (model.n_apps if key == "shared" else 1)
               for key, node in qparams.items() if isinstance(node, dict))


def run_recurrent(arch: str):
    """One recurrent arch at its published widths and depth (xlstm-1.3b
    at ``RECURRENT_LAYERS``): random
    float32 weights from ``torch.Generator`` seed 0, bf16 activations, KL
    calibration on ``RECURRENT_CALIB`` held-out prompts, then INT8 greedy
    ``generate`` on phase 7's 16 prompts with dynamic and with static
    scales, each run's launches held to its tree, each run's kernels
    against their plain versions (exactly), a profiled dynamic call and
    the peak memory.  Returns the launch counts of the two runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (Calibrator, QuantPolicy, Taps,
                                  count_quantized, quantize_model)
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=RECURRENT_LAYERS.get(
        arch, cfg.n_layers))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_el = sum(p.numel() for p in tree_leaves(params))
    log(f"{cfg.name} ({type(model).__name__}): {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}; init "
        f"{time.perf_counter() - t0:.2f} s: {n_el} float32 elements "
        f"({4 * n_el} B), the reference formula's n_params {cfg.n_params}")
    batch, held_out = moe_prompts(cfg.vocab)

    t0 = time.perf_counter()
    cal = Calibrator()
    for src in held_out[:RECURRENT_CALIB]:
        taps = Taps()
        model.forward(params, {"tokens": torch.as_tensor(
            src[None, :], device="cuda")}, taps=taps)
        cal.observe_taps(taps)
    recs = cal.compute("symmetric")
    t_cal = time.perf_counter() - t0
    trees = {}
    for act, calibs in (("dynamic", {}), ("static", recs)):
        t0 = time.perf_counter()
        trees[act] = quantize_model(params, calibs,
                                    QuantPolicy(act_quant=act))
        torch.cuda.synchronize()
        stats = count_quantized(trees[act][0])
        log(f"quantize ({act}) {time.perf_counter() - t0:.2f} s: "
            f"{stats['quantized_linears']} INT8 linears "
            f"({linears_a_pass(model, trees[act][0])} a forward pass), "
            f"{stats['int8_bytes']} B; float tensors {stats['fp_bytes']} B")
    log(f"calibrate ({RECURRENT_CALIB} held-out prompts) {t_cal:.2f} s: "
        f"{len(recs)} sites, "
        f"{sum(r.quantize for r in recs.values())} quantizable")

    counts = {}
    apps = getattr(model, "n_apps", 0)
    for act, quantizer in (("dynamic", "quantize_rowwise"),
                           ("static", "quantize_static")):
        qparams, qctx = trees[act]
        name = f"{cfg.name} greedy {act}"
        engine = ServingEngine(model, qparams, quant=qctx,
                               max_len=MOE_MAX_LEN)
        engine.generate(batch, max_new_tokens=2)       # warm-up, uncounted
        r = run_counted(name, counts, lambda: engine.generate(
            batch, max_new_tokens=MAX_NEW))
        log(f"e2e {name}: tokens={r.n_tokens} steps={r.steps} "
            f"tokens_per_s={r.tokens_per_s:.1f} prefill_s={r.prefill_s:.4f} "
            f"decode_s={r.decode_s:.4f} host_syncs={r.host_syncs}")
        if len(r.tokens) != N_REQUESTS or any(
                len(t) > MAX_NEW or (len(t) and not (
                    0 <= t.min() and t.max() < cfg.vocab)) for t in r.tokens):
            raise AssertionError(f"{name}: bad outputs")
        sites = linears_a_pass(model, qparams)
        want = {quantizer: sites * r.steps, "int8_matmul": sites * r.steps,
                "decode_attention": apps * (r.steps - 1)}
        c = counts[name]
        bad = {k: (c[k], n) for k, n in want.items() if c[k] != n}
        others = [k for k in c if k not in want and c[k]]
        if bad or others or r.steps != MAX_NEW:
            raise AssertionError(f"{name}: launches {c} against {want} "
                                 f"({r.steps} passes)")
        log(f"  launch counts met: {want}, no other kernel, no plain "
            "version")
        phase(f"7d: {cfg.name} against the plain versions, {act} scales")
        check_deep_against_plain(model, qparams, qctx, batch)
        if act == "dynamic":
            phase(f"7d: {cfg.name} profile")
            busy, rows, wall = profile(f"{name}", lambda: engine.generate(
                batch, max_new_tokens=RECURRENT_PROFILE_NEW).steps, cpu=False)
            k3 = sum(ms for ms, key, _ in rows
                     if "int8_matmul_kernel" in key
                     or "int8_matmul_reduce_kernel" in key)
            log(f"  {N_REQUESTS * RECURRENT_PROFILE_NEW} tokens in "
                f"{wall:.1f} ms profiled; K3 device time {k3:.2f} ms = "
                f"{k3 / busy:.3f} of busy; {attention_ms(rows)}")
        del engine
    peak = torch.cuda.max_memory_allocated()
    log(f"{cfg.name}: max_memory_allocated={peak} B over the model's phase "
        f"(at {time.perf_counter() - T_START:.1f} s)")
    del model, params, trees, qparams, qctx, recs, cal
    torch.cuda.empty_cache()
    return counts



# ---------------------------------------------------------------------------
# phase 8: the serving driver, once per mode
# ---------------------------------------------------------------------------

DRIVER_RUNS = (
    ["--mode", "continuous", "--paged", "--requests", "16", "--slots", "4",
     "--max-new-tokens", "8"],
    ["--mode", "static", "--streams", "2", "--requests", "16",
     "--max-new-tokens", "8"],
    ["--weight-bits", "4", "--mode", "continuous", "--paged", "--requests",
     "16", "--slots", "4", "--max-new-tokens", "8"],
    ["--mode", "continuous", "--paged", "--beam", "4", "--burst-len", "auto",
     "--requests", "16", "--slots", "16", "--max-new-tokens", "8"],
    ["--mode", "continuous", "--paged", "--mesh", "1,2", "--backend", "gloo",
     "--requests", "16", "--slots", "4", "--max-new-tokens", "8"],
    ["--mode", "continuous", "--paged", "--replicas", "2", "--requests", "16",
     "--slots", "4", "--max-new-tokens", "8"],
)


TRAIN_DRIVER = ["-m", "repro_torch.launch.train"]


def driver_chains(ckpt_dir: str):
    """(label, [argv, ...]) of each driver chain: the commands of a chain
    run one after another, the chains at once.  The serving driver once
    per ``DRIVER_RUNS`` mode; the training driver 20 steps with a
    checkpoint every 10, then 30 steps from the same directory (it must
    restore step 20); and the reduced MoE model for 10 steps."""
    py = [sys.executable]
    chains = [(f"serve {' '.join(argv[:4])}",
               [py + ["-m", "repro_torch.launch.serve", *argv]])
              for argv in DRIVER_RUNS]
    resume = ["--ckpt-dir", ckpt_dir, "--save-every", "10"]
    chains.append(("train --steps 20, then 30 (resume)",
                   [py + TRAIN_DRIVER + ["--steps", "20", *resume],
                    py + TRAIN_DRIVER + ["--steps", "30", *resume]]))
    chains.append((f"train --arch {MOE_ARCH} --steps 10",
                   [py + TRAIN_DRIVER + ["--arch", MOE_ARCH, "--steps",
                                         "10"]]))
    return chains


def run_driver() -> None:
    """Every driver chain at once, one thread each running its commands in
    turn as subprocesses (their times share the card and the host, so they
    are not kept); each command must exit 0, and the training driver's
    second run must restore the first's last checkpoint."""
    import tempfile
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        chains = driver_chains(ckpt)
        results = [[] for _ in chains]

        def run_chain(cmds, out):
            for argv in cmds:
                proc = subprocess.run(argv, cwd=ROOT, env=env,
                                      capture_output=True, text=True,
                                      timeout=600)
                out.append((argv, proc, time.perf_counter() - t0))
                if proc.returncode:
                    return

        threads = [threading.Thread(target=run_chain, args=(cmds, out))
                   for (_, cmds), out in zip(chains, results)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for (label, cmds), out in zip(chains, results):
        for argv, proc, at in out:
            log(f"driver {label}: {' '.join(argv[1:])[-60:]} exit "
                f"{proc.returncode} at {at:.1f} s")
            for line in proc.stdout.strip().splitlines():
                log(f"  | {line}")
            if proc.returncode:
                raise AssertionError(f"{' '.join(argv)} failed:\n"
                                     f"{proc.stderr[-4000:]}")
            if "launch.train" in argv[2]:
                for line in proc.stderr.splitlines():
                    if "restored checkpoint" in line:
                        log(f"  | {line}")
                if "final loss:" not in proc.stdout:
                    raise AssertionError(f"{label}: no final loss line")
        if len(out) != len(cmds):
            raise AssertionError(f"{label}: {len(out)} of {len(cmds)} "
                                 "commands ran")
    resumed = results[-2][-1][1].stderr
    if "restored checkpoint at step 20" not in resumed:
        raise AssertionError("the training driver's second run did not "
                             "restore step 20")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import make_corpus
    from repro_torch.kernels import build, ops
    from repro_torch.models import DecoderLM, EncDecLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)

    # 2. build
    phase("build")
    secs = build.build_seconds()
    log(f"build: {secs:.2f} s ({build.library_path().name})")
    for name, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_config("transformer-base")
    corpus = make_corpus(N_REQUESTS + N_CALIB, cfg.vocab, seed=11)
    s_enc, s_moe, moe_cfg = path_dims()
    log(f"transformer-base: {N_REQUESTS} requests, S_enc={s_enc}, "
        f"max_len={MAX_LEN}, max_new_tokens={MAX_NEW}")

    # 3. kernels vs plain
    phase("kernels vs plain")
    results = check_kernels(s_enc, s_moe, moe_cfg)

    # 4. end to end
    phase("end to end")
    model = EncDecLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    warm_up(model, params, corpus)
    ops.reset_launch_counts()
    batch, qparams, qctx, recs, runs = run_main_path(model, params, corpus)
    counts = ops.launch_counts()
    log(f"launches on the main path: {json.dumps(counts)}")
    check_against_plain(model, qparams, qctx, batch)
    profile_greedy(model, qparams, qctx, batch)

    # 5. continuous serving, contiguous and paged
    phase("continuous serving")
    serve_counts, serve_results, toks = run_serving(model, qparams, qctx)
    phase("serve vs per-request generate")
    serve_vs_generate(model, qparams, qctx, toks)

    # 5b. continuous beam serving, contiguous and paged
    phase("continuous beam serving")
    beam_counts, beam_results, beam_toks = run_beam_serving(
        model, params, qparams, qctx)
    phase("beam serve vs per-request generate_beam")
    beam_serve_vs_generate_beam(model, qparams, qctx, beam_toks)

    # 6. INT4 weights
    phase("INT4 weights")
    int4_counts, q4params, q4ctx, int4_paged = run_int4(
        model, params, recs, batch, runs["greedy_static"])
    check_against_plain(model, q4params, q4ctx, batch)
    profile_int4(model, q4params, q4ctx, batch)

    # 5c. the prefix cache and overload (after phase 6: its INT4 serve
    # reuses phase 6's weights and is held to its paged serve)
    phase("prefix cache and overload")
    prefix_counts = run_prefix_and_overload(
        model, qparams, qctx, q4params, q4ctx, beam_results["beam_paged"],
        int4_paged)
    phase("spill and resume")
    spill_resume_ms(model, qparams, qctx)

    # 5d. chunked prefill and self-speculative decoding (phase 5e's ranks
    # start their imports meanwhile)
    tp_ranks = start_tp_ranks()
    phase("chunked prefill and speculative decoding")
    staged_counts = run_chunked_and_speculative(
        model, qparams, qctx, batch, runs["greedy_static"], toks,
        beam_results["beam_paged"])

    # 5e. tensor-parallel serving on two ranks of the card, and the router
    phase("5e: tensor parallel on two ranks of the card, and the router")
    tp_counts = run_tensor_parallel(tp_ranks, model, qparams, qctx, batch,
                                    runs["greedy_static"],
                                    serve_results["paged"])

    # 4t. train -> calibrate -> quantize -> translate
    phase("4t: transformer-base training step")
    train_transformer_base(model, params)
    del model, params, qparams, q4params
    phase("4t: Table 1 on a model trained here")
    start_decoder_tp(tp_ranks)          # 5f's dynamic runs beside Table 1
    table1_counts = run_table1()
    end_decoder_tp_dynamic(tp_ranks)

    # 7. the decoder-only MoE family: its training step (phase 4t) on the
    # float32 weights, then INT8 generation from the same weights
    moe_model = DecoderLM(dataclasses.replace(get_config(MOE_ARCH),
                                              n_layers=MOE_LAYERS),
                          device="cuda")
    moe_params = moe_model.init(torch.Generator(device="cuda").manual_seed(0))
    phase("4t: MoE training step")
    train_moe_step(moe_model, moe_params)
    phase("MoE generate")
    moe_counts, (msparams, msctx), (mdparams, mdctx), moe_batch, \
        tp_want = run_moe(moe_model, moe_params)
    tp_recs = {"moe": tp_want.pop("recs")}
    phase("MoE against the plain versions")
    for mparams, mctx in ((mdparams, mdctx), (msparams, msctx)):
        check_against_plain(moe_model, mparams, mctx, moe_batch,
                            max_len=MOE_MAX_LEN)
    phase("MoE profile")
    profile_moe(moe_model, mdparams, mdctx, moe_batch)
    del moe_model, moe_params, msparams, mdparams
    torch.cuda.empty_cache()

    # 7b. the dense SwiGLU family at full width, then 7c. the
    # audio stub's src_embeds (after phase 7's trees are freed)
    phase(f"7b: mistral-nemo-12b at full width, {DENSE_LAYERS} layers")
    dense_counts, dense_want = run_dense()
    tp_recs["dense"] = dense_want.pop("recs")
    tp_want.update(dense_want)
    phase("7c: whisper-base from src_embeds")
    audio_counts = run_audio()

    # 5f. the decoder-only families on phase 5e's ranks (their dynamic
    # runs went beside Table 1; the static ones run now, on phases 7's and
    # 7b's thresholds), held to phases 7's and 7b's runs; joined here, so
    # their trees are gone before phase 7d
    phase("5f: the decoder-only families on two ranks of the card")
    hand_recs(tp_ranks, tp_recs)
    decoder_tp_counts = check_decoder_tp(tp_ranks, tp_want, moe_cfg)

    # 7d. the recurrent families at full width, one at a time (phase 5g's
    # transformer-base runs on the ranks beside it, after 5f)
    torch.cuda.empty_cache()
    recurrent_counts = {}
    for arch in RECURRENT_ARCHS:
        phase(f"7d: {arch} at full width")
        recurrent_counts.update(run_recurrent(arch))

    # 8. the serving driver (phase 5g's transformer-base and MoE runs
    # beside it)
    torch.cuda.empty_cache()
    phase("serving driver")
    run_driver()

    # 5g. training on a mesh on phase 5e's ranks, checked here (their
    # mistral-nemo-12b runs, last, have the card to themselves)
    phase("5g: training on a mesh on two ranks of the card")
    train_tp_counts = check_train_tp(tp_ranks)

    # 9. launch counts and the kernel table
    phase("kernel table")
    maxP = MAX_LEN // PAGE
    headline = {"quantize_static": [N_REQUESTS * s_enc, 512],
                "quantize_rowwise": [N_REQUESTS * s_enc, 512],
                "int8_matmul": [N_REQUESTS * BEAM, 512, 512],
                "int8_matmul_accumulate": [SERVE_SLOTS, 1024, 512],
                "int8_matmul_epilogue": [SERVE_SLOTS, 1024, 512],
                "int8_matmul_batched": [
                    moe_cfg.moe.n_experts, moe_expert_rows(moe_cfg, N_REQUESTS),
                    moe_cfg.d_model, moe_cfg.d_ff],
                "int4_matmul": [N_REQUESTS * BEAM, 512, 512],
                "decode_attention": [N_REQUESTS * BEAM, MAX_LEN, 8, 8, 64],
                "decode_attention_paged": [SERVE_SLOTS, SERVE_SLOTS * maxP,
                                           PAGE, 8, 64]}
    replaces = {
        "quantize_static": "src/repro/kernels/quantize.py:79",
        "quantize_rowwise": "src/repro/kernels/quantize.py:38",
        "int8_matmul": "src/repro/kernels/int8_matmul.py:145",
        "int8_matmul_accumulate": "src/repro/kernels/int8_matmul.py:145",
        "int8_matmul_epilogue": "src/repro/kernels/int8_matmul.py:145",
        "int8_matmul_batched": "src/repro/kernels/int8_matmul.py:82",
        "int4_matmul": "src/repro/kernels/int4_matmul.py:104",
        "decode_attention": "src/repro/kernels/decode_attention.py:80",
        "decode_attention_paged": "src/repro/kernels/decode_attention.py:250"}
    sources = {
        "quantize_static": "src/repro_torch/csrc/quantize.cu",
        "quantize_rowwise": "src/repro_torch/csrc/quantize.cu",
        "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu",
        "int8_matmul_accumulate": "src/repro_torch/csrc/int8_matmul.cu",
        "int8_matmul_epilogue": "src/repro_torch/csrc/int8_matmul.cu",
        "int8_matmul_batched": "src/repro_torch/csrc/int8_matmul.cu",
        "int4_matmul": "src/repro_torch/csrc/int4_matmul.cu",
        "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
        "decode_attention_paged": "src/repro_torch/csrc/decode_attention.cu"}
    # each kernel's launches over every path driven with the counts read
    # from zero: generate, the four serves, the six beam serves, the INT4
    # phase, the prefix-cache and overload serves, the chunked and
    # speculative runs, the ranks, the (1, 1) mesh and the router of phase
    # 5e, the Table-1 runs of phase 4t, the MoE phase, the dense, the audio
    # and the recurrent phases
    path_counts = {"generate": counts,
                   **{f"serve {k}": v for k, v in serve_counts.items()},
                   **{f"serve {k}": v for k, v in beam_counts.items()},
                   "INT4": int4_counts,
                   **{f"serve {k}": v for k, v in prefix_counts.items()},
                   **{f"5d {k}": v for k, v in staged_counts.items()},
                   **{f"5e {k}": v for k, v in tp_counts.items()},
                   **{f"5f {k}": v for k, v in decoder_tp_counts.items()},
                   **{f"5g {k}": v for k, v in train_tp_counts.items()},
                   **{f"4t {k}": v for k, v in table1_counts.items()},
                   "MoE": moe_counts,
                   **{f"7b {k}": v for k, v in dense_counts.items()},
                   **{f"7c {k}": v for k, v in audio_counts.items()},
                   **{f"7d {k}": v for k, v in recurrent_counts.items()}}
    paths = {}
    for name in replaces:
        per = {k: c[name] for k, c in path_counts.items() if c[name]}
        paths[name] = ("; ".join(f"{k} {n}" for k, n in per.items()),
                       sum(per.values()))
        log(f"launches {name}: {paths[name][1]} ({paths[name][0]})")
    kernels = []
    for name in replaces:
        r = next(x for x in results[name] if x["shape"] == headline[name])
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": paths[name][1],
            "max_abs_err": max(x["max_abs_err"] for x in results[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "path": paths[name][0],
            **{k: r[k] for k in ("k3_ms", "cold_ms", "tile", "plan",
                                 "empty_ms") if k in r},
            **({"gradient_rows": [
                {k: x[k] for k in ("shape", "dtype", "ms", "cold_ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                for x in results[name] if x.get("dtype") == "float32"]}
               if name == "quantize_static" else {})})
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    print(json.dumps({"kernels": kernels}), flush=True)

    # 10. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
