"""Flash-decode attention over an INT8 KV cache on the card: contiguous
(K4) and paged (K5).

Port of ``repro/kernels/decode_attention.py:decode_attention_pallas`` and
``decode_attention_paged_pallas``.  Both kernels are in
``csrc/decode_attention.cu``, one body: the cache is walked in chunks of
``CHUNK`` positions, each chunk's partial (local max, sum, accumulator) is
computed in a fixed order, and the partials are folded in ascending chunk
order, so that neither the plan nor a row's batch changes a bit.
:func:`plan` picks the split of the sequence over a thread block cluster
and the warps of a block from the shapes alone, so the CPU tests can check
it.  Each wrapper checks its inputs, allocates the output, launches
on the current stream and counts the launch.  The plain versions are
``ref.ref_decode_attention`` and ``ref.ref_decode_attention_paged``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import SMS

Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)  # csrc instantiations (80: zamba2)
WARPS = (2, 4, 8)              # warps a block can have
SPLITS = (1, 2, 4, 8)          # cluster ranks (powers of two up to the
MAX_SPLIT = SPLITS[-1]         # portable cluster size)
_SMEM_LIMIT = 232448           # opt-in shared memory of an H100 block

# Positions of a chunk, one warp's work.  Each chunk's softmax uses its own
# max, so the chunk is part of the arithmetic: one constant, never a plan
# output (csrc: kChunk; the library is checked against it).  Set from
# tools/decode_attention_sweep.py on an H100 (PERF.md §6): 32 against 16
# at the decode shapes, K4 16 × 64 0.0041 against 0.0039 ms, 16 × 80 0.0048
# both, 64 × 80 0.0063 against 0.0072, K5 16 slots 0.0046 against 0.0042
# (within 1% of each other weighted by the main paths' launches), and at a
# cache of 4096 positions 0.0269 against 0.0338.
CHUNK = 32
# The plan, from the same sweep.  2 warps a block where a row has at most
# 2 chunks (16 × 64: 0.0041 ms, 0.0041 with 4), else 4 (16 × 80: 0.0048
# against 0.0069 with 2 and 0.0049 with 8).  A cluster split of the
# sequence pays only where each warp would walk more than two chunks (its
# barriers and the fold's three steps cost some 2 us: 16 × 64 split in 2,
# 0.0064 against 0.0041): into as many ranks as bring the blocks up to
# TARGET_BLOCKS, at most MAX_SPLIT (16 × 4096, 128 blocks: 4 ranks of 4
# warps 0.0269 ms, 8 of 2 0.0285, 4 of 8 0.0289, unsplit 0.0477).  A power
# of two, so the fold finds a chunk's rank and slot by mask and shift.
TARGET_BLOCKS = 4 * SMS


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of K4 or K5: the cluster's ranks per (row, kv head, head
    tile) and the warps of a block.  Neither changes a bit."""
    split: int      # one of SPLITS (1: no cluster)
    warps: int      # 2, 4 or 8


def chunks(S: int, chunk: int = CHUNK) -> int:
    """Chunks of a cache of capacity ``S``."""
    return -(-S // chunk)


def head_tile(G: int, dh: int) -> int:
    """Query heads of one block (csrc: gmax): at most 8, 4 at dh 128."""
    return min(G, 8 if dh <= 64 else 4)


def smem_bytes(p: Plan, G: int, dh: int, S: int, maxP: int = 0,
               chunk: int = CHUNK) -> int:
    """Shared memory of one block (csrc: layout): each warp's ring of two
    chunks, its p·v_scale row, the chunk partials (two rounds unsplit, the
    rank's chunks split), the split's fold factors and K5's block table."""
    a16 = lambda n: -(-n // 16) * 16
    gt = head_tile(G, dh)
    gp = 1 if gt <= 1 else 2 if gt <= 2 else 4 if gt <= 4 else 8
    n = chunks(S, chunk)
    slots = -(-n // p.split) if p.split > 1 else 2 * p.warps
    fold = a16(4 * 3 * gp * n) if p.split > 1 else 0
    return (p.warps * 2 * (2 * chunk * dh + 8 * chunk)
            + a16(4 * p.warps * gp * chunk)
            + a16(4 * slots * (gp * dh + 2 * gp)) + fold + a16(4 * maxP))


def plan(B: int, S: int, HKV: int, G: int, dh: int, *,
         chunk: int = CHUNK) -> Plan:
    """K4's and K5's plan for ``B`` rows over a cache of capacity ``S`` (K5:
    maxP · page size) with ``HKV`` kv heads of ``G`` query heads each.

    2 warps a block where a row has at most 2 chunks, else 4.  The
    sequence is split over a cluster where each warp would walk more than
    2 chunks: into the largest power of two of ranks that keeps the blocks
    (one per row, kv head and tile of query heads) within
    ``TARGET_BLOCKS``, at most ``MAX_SPLIT``.  A split whose partials would
    not fit in shared memory falls back to no split, which any capacity
    fits."""
    n = chunks(S, chunk)
    blocks = B * HKV * -(-G // head_tile(G, dh))
    warps = 2 if n <= 2 else 4
    split = 1
    if n > 2 * warps:
        fit = max(1, min(MAX_SPLIT, TARGET_BLOCKS // max(blocks, 1)))
        split = 1 << (fit.bit_length() - 1)
    p = Plan(split, warps)
    if smem_bytes(p, G, dh, S, chunk=chunk) > _SMEM_LIMIT:
        p = Plan(1, warps)
    return p


def all_plans(S: int, chunk: int = CHUNK):
    """Every plan a launch over capacity ``S`` can take (for the tests and
    the sweep): splits up to one a chunk."""
    n = max(1, chunks(S, chunk))
    return [Plan(split, warps)
            for split in SPLITS if split <= n for warps in WARPS]


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"decode_attention: {name} is on {t.device}, "
                         f"not {device}")
    if t.dtype != dtype:
        raise TypeError(f"decode_attention: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_attention: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_attention: {name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _checked(lib):
    """The kernel library, once its chunk is known to be ``CHUNK``."""
    if lib.repro_decode_attention_chunk() != CHUNK:
        raise RuntimeError(f"decode_attention: the library's chunk "
                           f"{lib.repro_decode_attention_chunk()} is not "
                           f"CHUNK = {CHUNK}")
    return lib


def _plan_for(kernel: str, tile: Optional[Plan], G: int, dh: int, S: int,
              maxP: int, B: int, HKV: int) -> Plan:
    """The launch's plan, checked against what the kernels were built for
    and the card's shared memory (``smem_bytes`` mirrors the kernels'
    layout; the card tests hold the two equal)."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {dh} is not one of {HEAD_DIMS}")
    p = tile or plan(B, S, HKV, G, dh)
    if p.split not in SPLITS or p.warps not in WARPS:
        raise ValueError(f"{kernel}: bad plan {p}")
    smem = smem_bytes(p, G, dh, S, maxP)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{kernel}: G={G}, dh={dh}, S={S}, {p} needs "
                         f"{smem} bytes of shared memory, more than "
                         f"{_SMEM_LIMIT}")
    return p


def _check_aligned(kernel: str, *tensors: torch.Tensor) -> None:
    """The rows are copied 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: the int8 cache must be 16-byte "
                             f"aligned")


def decode_attention_cuda(
    q: torch.Tensor,          # (B, H, dh) f32/bf16
    k_q: torch.Tensor,        # (B, S, HKV, dh) int8
    k_scale: torch.Tensor,    # (B, S, HKV) f32
    v_q: torch.Tensor,        # (B, S, HKV, dh) int8
    v_scale: torch.Tensor,    # (B, S, HKV) f32
    lengths: torch.Tensor,    # (B,) int32
    *,
    sm_scale: float,
    tile: Optional[Plan] = None,
) -> torch.Tensor:
    """K4; ``tile`` overrides :func:`plan` (for measuring the plans against
    each other: every plan gives the same bits)."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention: needs CUDA tensors, got {q.device}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, dh) and k_q "
                         f"(B, S, HKV, dh), got {tuple(q.shape)}, "
                         f"{tuple(k_q.shape)}")
    B, H, dh = q.shape
    _, S, HKV, _ = k_q.shape
    if H % HKV:
        raise ValueError(f"decode_attention: {H} heads over {HKV} kv heads")
    G = H // HKV
    dev = q.device
    _check(q, "q", q.dtype, (B, H, dh), dev)
    _check(k_q, "k_q", torch.int8, (B, S, HKV, dh), dev)
    _check(v_q, "v_q", torch.int8, (B, S, HKV, dh), dev)
    _check(k_scale, "k_scale", torch.float32, (B, S, HKV), dev)
    _check(v_scale, "v_scale", torch.float32, (B, S, HKV), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    _check_aligned("decode_attention", k_q, v_q)
    p = _plan_for("decode_attention", tile, G, dh, S, 0, B, HKV)
    lib = _checked(build.lib())
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        err = lib.repro_decode_attention(
            q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, S, HKV, G, dh, float(sm_scale), Q_DTYPES[q.dtype], p.split,
            p.warps, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "decode_attention")
        build.count("decode_attention")
    return out


def decode_attention_paged_cuda(
    q: torch.Tensor,             # (B, H, dh) f32/bf16
    k_pages: torch.Tensor,       # (P, ps, HKV, dh) int8 page pool
    k_scale: torch.Tensor,       # (P, ps, HKV) f32
    v_pages: torch.Tensor,       # (P, ps, HKV, dh) int8
    v_scale: torch.Tensor,       # (P, ps, HKV) f32
    block_tables: torch.Tensor,  # (B, maxP) int32; sentinel P = unreserved
    lengths: torch.Tensor,       # (B,) int32
    *,
    sm_scale: float,
    tile: Optional[Plan] = None,
) -> torch.Tensor:
    """K5; its plan is K4's at capacity maxP · ps, so K5 on a paged cache
    and K4 on the linearized cache take the same plan.  ``tile`` as for
    :func:`decode_attention_cuda`."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention_paged: needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"decode_attention_paged: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"decode_attention_paged: q must be (B, H, dh), "
                         f"k_pages (P, ps, HKV, dh) and block_tables "
                         f"(B, maxP), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, "
                         f"{tuple(block_tables.shape)}")
    B, H, dh = q.shape
    P, ps, HKV, _ = k_pages.shape
    maxP = block_tables.shape[1]
    if H % HKV:
        raise ValueError(f"decode_attention_paged: {H} heads over {HKV} kv "
                         f"heads")
    G = H // HKV
    dev = q.device
    _check(q, "q", q.dtype, (B, H, dh), dev)
    _check(k_pages, "k_pages", torch.int8, (P, ps, HKV, dh), dev)
    _check(v_pages, "v_pages", torch.int8, (P, ps, HKV, dh), dev)
    _check(k_scale, "k_scale", torch.float32, (P, ps, HKV), dev)
    _check(v_scale, "v_scale", torch.float32, (P, ps, HKV), dev)
    _check(block_tables, "block_tables", torch.int32, (B, maxP), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    _check_aligned("decode_attention_paged", k_pages, v_pages)
    p = _plan_for("decode_attention_paged", tile, G, dh, maxP * ps, maxP,
                  B, HKV)
    lib = _checked(build.lib())
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        err = lib.repro_decode_attention_paged(
            q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
            v_pages.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, P, ps, maxP, HKV, G, dh,
            float(sm_scale), Q_DTYPES[q.dtype], p.split, p.warps, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "decode_attention_paged")
        build.count("decode_attention_paged")
    return out
