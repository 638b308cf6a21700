"""Activation quantizers on the card: K1 (calibrated) and K2 (dynamic).

Ports of ``repro/kernels/quantize.py``.  The kernels are in
``csrc/quantize.cu``: K1 is one flat pass of 16-byte loads over the
contiguous tensor, K2 keeps each row in the registers of one to eight
warps.  :func:`plan` picks, from the shapes alone, K1's vector or scalar
path and grid and K2's vectors a lane and warps a row (a block holds one
row), so the CPU tests can check it.  These wrappers check their inputs,
allocate the outputs, launch on the current stream and count the launch.
The plain versions are ``ref.ref_quantize_static`` /
``ref.ref_quantize_rowwise``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import SMS

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16              # one load a lane
MAX_THREADS = 256           # K1's block, K2's largest (csrc: kMaxThreads)
MAX_VECS = 8                # K2: vectors a lane holds (csrc: kMaxVecs), so
WARP_ROW_BYTES = 32 * MAX_VECS * VEC_BYTES   # a warp holds at most 4 KB
WARPS_PER_ROW = (1, 2, 4, 8)
EPS = np.float32(1e-12)

# Set from tools/quantize_sweep.py on an H100 (PERF.md §6).  K1: blocks
# of 256 threads, at most one wave of them (2048 threads an SM), each
# thread two 16-byte vectors in flight an iteration; within 0.0001 ms of
# the best grid at every phase-3 shape (30720 × 1024 bf16: 0.0345 ms).
STATIC_WAVE = SMS * (2048 // MAX_THREADS)
# K2: a lane holds one 16-byte vector, the row split over as many warps as
# cover it (up to 8), while the rows' warps stay within WARP_CAP; beyond
# that two (736 × 2048: 8 warps a row, 5888 warps, 0.0039 ms against
# 0.0075 with 8 vectors a lane; 2944 × 1024: 2 vectors over 2 warps 0.0050
# against 0.0052 with one over 4).  A block holds one row.
WARP_CAP = 6144


@dataclasses.dataclass(frozen=True)
class StaticPlan:
    """One launch of K1."""
    vector: bool        # 8 elements a thread a step, 16-byte loads
    blocks: int         # of 256 threads; a grid-stride loop covers the rest


@dataclasses.dataclass(frozen=True)
class RowwisePlan:
    """One launch of K2: a block a row.  ``vecs`` 16-byte vectors a lane
    (0: the scalar path, which reads its row twice), ``warps_per_row``
    warps share the row.  No choice changes a bit."""
    vecs: int
    warps_per_row: int

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_row


@dataclasses.dataclass(frozen=True)
class Plan:
    static: StaticPlan
    rowwise: RowwisePlan


def _elem(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 2


def static_vector_ok(M: int, K: int, aligned: bool) -> bool:
    """K1's 16-byte path: an aligned base and 8 elements a vector."""
    return aligned and (M * K) % 8 == 0


def rowwise_vector_ok(K: int, dtype: torch.dtype, aligned: bool) -> bool:
    """K2's 16-byte path: an aligned base, rows of whole vectors, and a row
    that 8 warps hold (32 KB)."""
    row = K * _elem(dtype)
    return (aligned and row % VEC_BYTES == 0
            and row <= max(WARPS_PER_ROW) * WARP_ROW_BYTES)


def _vecs(K: int, dtype: torch.dtype, wpr: int) -> int:
    """Vectors a lane must hold to cover a row with ``wpr`` warps, rounded
    up to a power of two (csrc instantiations 1, 2, 4, 8)."""
    need = -(-K * _elem(dtype) // (VEC_BYTES * 32 * wpr))
    return 1 << max(need - 1, 0).bit_length()


def _static_blocks(n_units: int, wave: int) -> int:
    return max(1, min(-(-n_units // MAX_THREADS), wave))


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """K1's and K2's launches for a contiguous (M, K) input of ``dtype``
    whose base address is 16-byte ``aligned`` (or not)."""
    vec = static_vector_ok(M, K, aligned)
    units = M * K // 8 if vec else M * K
    static = StaticPlan(vec, _static_blocks(units, STATIC_WAVE))
    # K2: one vector a lane while the rows' warps stay within WARP_CAP,
    # else two; as many warps a row as that takes, at most 8 (a wider row
    # takes more vectors a lane: up to MAX_VECS)
    row_units = -(-K * _elem(dtype) // VEC_BYTES)
    per_lane = 1 if M * -(-row_units // 32) <= WARP_CAP else 2
    need = -(-row_units // (32 * per_lane))
    wpr = min(max(WARPS_PER_ROW), 1 << max(need - 1, 0).bit_length())
    vecs = _vecs(K, dtype, wpr) if rowwise_vector_ok(K, dtype, aligned) else 0
    return Plan(static, RowwisePlan(vecs, wpr))


def static_plans(M: int, K: int, dtype: torch.dtype,
                 aligned: bool) -> List[StaticPlan]:
    """Every K1 launch a (M, K) input admits that the tests and the sweep
    try: both paths where the vectors fit, one block (all grid-stride),
    one block an SM, and up to two waves."""
    out = []
    for vec in ((True, False) if static_vector_ok(M, K, aligned)
                else (False,)):
        units = M * K // 8 if vec else M * K
        for blocks in sorted({_static_blocks(units, w) for w in (
                1, SMS, STATIC_WAVE // 2, STATIC_WAVE, 2 * STATIC_WAVE)}):
            out.append(StaticPlan(vec, blocks))
    return out


def rowwise_plans(M: int, K: int, dtype: torch.dtype,
                  aligned: bool) -> List[RowwisePlan]:
    """Every K2 launch a (M, K) input admits: the vector path (where it
    fits) and the scalar path, at every warps a row."""
    out = []
    for wpr in WARPS_PER_ROW:
        if rowwise_vector_ok(K, dtype, aligned):
            v = _vecs(K, dtype, wpr)
            if v <= MAX_VECS:
                out.append(RowwisePlan(v, wpr))
        out.append(RowwisePlan(0, wpr))
    return out


def is_aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % VEC_BYTES == 0


def static_inv(amax: float, clamp: bool = True) -> float:
    """K1's multiplier ``1 / (max(amax, 1e-12) / 127)``: both f32 IEEE
    divisions (numpy's), as ``ref.ref_quantize_static`` computes it; a NaN
    threshold is ignored by the max, as the kernel's ``fmaxf`` did.  With
    ``clamp`` off, ``1 / (amax / 127)``: the MoE expert sites' form, which
    does not clamp the threshold."""
    t = np.float32(amax)
    with np.errstate(divide="ignore"):
        scale = (np.fmax(t, EPS) if clamp else t) / np.float32(127.0)
        return float(np.float32(1.0) / scale)


def check_rows(x: torch.Tensor, kernel: str) -> None:
    """A kernel input of shape (M, K): CUDA, f32/bf16, contiguous."""
    if not x.is_cuda:
        raise ValueError(f"{kernel}: needs a CUDA tensor, got {x.device}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{kernel}: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{kernel}: x must be 2-D (M, K), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: x must be contiguous")


def quantize_static_cuda(x: torch.Tensor, amax: float, *, clamp: bool = True,
                         tile: Optional[StaticPlan] = None) -> torch.Tensor:
    """``clip(rint(x / (max(amax, 1e-12) / 127)), ±127)`` as int8 (M, K);
    ``clamp`` off drops the max with 1e-12 (:func:`static_inv`).
    ``tile`` forces a launch (tests, sweeps); by default :func:`plan`'s."""
    check_rows(x, "quantize_static")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    if q.numel():
        aligned = is_aligned(x)
        p = tile or plan(M, K, x.dtype, aligned).static
        if p.vector and not static_vector_ok(M, K, aligned):
            raise ValueError(f"quantize_static: {p} needs a 16-byte aligned "
                             f"input of a multiple of 8 elements")
        err = build.lib().repro_quantize_static(
            x.data_ptr(), q.data_ptr(), M * K, static_inv(amax, clamp),
            X_DTYPES[x.dtype], int(p.vector), p.blocks, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "quantize_static")
        build.count("quantize_static")
    return q


def quantize_rowwise_cuda(x: torch.Tensor, *,
                          tile: Optional[RowwisePlan] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row abs-max quantizer: (int8 (M, K), f32 scales (M, 1)).
    ``tile`` forces a launch (tests, sweeps); by default :func:`plan`'s."""
    check_rows(x, "quantize_rowwise")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if q.numel():
        aligned = is_aligned(x)
        p = tile or plan(M, K, x.dtype, aligned).rowwise
        if p.vecs and (not rowwise_vector_ok(K, x.dtype, aligned)
                       or p.vecs < _vecs(K, x.dtype, p.warps_per_row)):
            raise ValueError(f"quantize_rowwise: {p} does not fit a row of "
                             f"{K} {x.dtype} at this alignment")
        err = build.lib().repro_quantize_rowwise(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
            X_DTYPES[x.dtype], p.vecs, p.warps_per_row, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "quantize_rowwise")
        build.count("quantize_rowwise")
    return q, scale

