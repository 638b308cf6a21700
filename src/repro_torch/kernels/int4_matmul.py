"""s8 activations × block-wise INT4 weights with the dequantize epilogue
fused (K6), on the card.

Port of ``repro/kernels/int4_matmul.py:int4_matmul_pallas``.  The kernel is
the s8 tensor-core tile in ``csrc/int4_matmul.cu``; :func:`plan` picks its
rows per tile and its group-ordered split of K from the shapes alone, so the
CPU tests can check it.  This wrapper checks its inputs, computes the
zero-point column sums of the dequantized weights (as the reference's
wrapper does, outside the kernel, and only for asymmetric activations),
allocates the output and the split's workspace, launches on the current
stream and counts the launch (once per call, with or without the split's
reduction kernel).  The plain version is ``ref.ref_int4_matmul``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_matmul import OUT_DTYPES, SMS
from repro_torch.kernels.int8_matmul import _check as _check_tensor

SCALE_DTYPES = {torch.float32: 0, torch.float16: 1}
_check = functools.partial(_check_tensor, kernel="int4_matmul")

BN = 64                   # output columns of a tile (csrc: Tile::BN)
# Set from tools/int8_tile_sweep.py on an H100 (times in PERF.md §6): a
# block pays about 0.8 us a group in series, the split's reduction about
# 1 us once, so K is cut into slices of whole groups while the output tiles
# are fewer than SPLIT_TILES, into as many slices as bring the blocks up to
# TARGET_BLOCKS (one group a slice at every decode shape of the INT4 path:
# 16 x 2048 -> 512 took 0.0062 ms in 16 slices, 0.0072 in 8, 0.0187
# unsplit; 16 x 512 -> 512 0.0061 in 4, 0.0076 unsplit).  No split past
# MAX_SPLIT_GROUPS groups: the f32 terms, n_groups x M x N, would outgrow
# the product.
SPLIT_TILES = SMS // 2
TARGET_BLOCKS = 2 * SMS
MAX_SPLIT_GROUPS = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of K6: the tile's rows (BN = 64 columns and BK = 128
    virtual K rows a stage are fixed) and the split of K into slices of
    whole groups."""
    bm: int                # output tile rows: 16, 32 or 64
    splits: int            # K slices (1: no split, no workspace)
    groups_per_slice: int  # groups of each slice but the last

    def slices(self, n_groups: int):
        """The group ranges [g0, g1) of the slices, in launch order."""
        g = self.groups_per_slice
        return [(s * g, min(n_groups, (s + 1) * g))
                for s in range(self.splits)]

    def workspace_shape(self, M: int, N: int,
                        n_groups: int) -> Optional[Tuple]:
        """The f32 group terms' shape, (n_groups, M, N), or None unsplit."""
        return (n_groups, M, N) if self.splits > 1 else None


def plan(M: int, N: int, K: int, G: int,
         n_groups: Optional[int] = None) -> Plan:
    """K6's tile and split for (M, K) × (K, N) in groups of ``G`` rows
    (``n_groups`` stored groups, ⌈K/G⌉ by default), from the shapes alone.

    BM = 16, 32 or 64 (the least that holds M, then tiled over M).  K is
    split when the ⌈M/BM⌉·⌈N/BN⌉ output tiles are fewer than
    ``SPLIT_TILES`` and there are 2 to ``MAX_SPLIT_GROUPS`` groups: into
    slices of whole groups, as many as bring the blocks up to
    ``TARGET_BLOCKS``, at most one a group; the last slice ends at the last
    group and may be the shortest.
    """
    if n_groups is None:
        n_groups = -(-K // G)
    bm = 16 if M <= 16 else 32 if M <= 32 else 64
    tiles = -(-M // bm) * -(-N // BN)
    if tiles < SPLIT_TILES and 2 <= n_groups <= MAX_SPLIT_GROUPS:
        per = -(-n_groups // -(-TARGET_BLOCKS // tiles))
        return Plan(bm, -(-n_groups // per), per)
    return Plan(bm, 1, max(1, n_groups))


def int4_matmul_cuda(
    a_q: torch.Tensor,                      # (M, K) int8
    a_scale: Union[torch.Tensor, float],    # (M, 1) / (1, 1) f32, or a float
    b_packed: torch.Tensor,                 # (K_store // 2, N) int8 nibbles
    b_scale: torch.Tensor,                  # (n_groups, N) f16/f32
    b_min: torch.Tensor,                    # (n_groups, N), b_scale's dtype
    a_zero_point: Optional[float] = None,   # q-space offset
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    *,
    group_size: int,
    out_dtype: torch.dtype = torch.float32,
    tile: Optional[Plan] = None,
) -> torch.Tensor:
    """K6; ``tile`` overrides :func:`plan` (for measuring the splits
    against each other)."""
    if not a_q.is_cuda:
        raise ValueError(f"int4_matmul: needs CUDA tensors, got {a_q.device}")
    if a_q.dim() != 2 or b_packed.dim() != 2 or b_scale.dim() != 2:
        raise ValueError("int4_matmul: a_q, b_packed and b_scale must be 2-D")
    if group_size < 2 or group_size % 2:
        raise ValueError(f"int4_matmul: group_size must be even and >= 2, "
                         f"got {group_size}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int4_matmul: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if b_scale.dtype not in SCALE_DTYPES:
        raise TypeError(f"int4_matmul: scales must be float16 or float32, "
                        f"got {b_scale.dtype}")
    M, K = a_q.shape
    n_g, N = b_scale.shape
    k_store = n_g * group_size
    if tuple(b_packed.shape) != (k_store // 2, N):
        raise ValueError(f"int4_matmul: packed weights {tuple(b_packed.shape)}"
                         f" do not hold {n_g} groups of {group_size} rows "
                         f"x {N}")
    if K > k_store:
        raise ValueError(f"int4_matmul: activation K={K} exceeds the stored "
                         f"K={k_store}")
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (M, K), dev)
    _check(b_packed, "b_packed", torch.int8, (k_store // 2, N), dev)
    _check(b_scale, "b_scale", b_scale.dtype, (n_g, N), dev)
    _check(b_min, "b_min", b_scale.dtype, (n_g, N), dev)
    a_scale_ptr, a_scale_value, per_row = None, 0.0, 0
    if isinstance(a_scale, torch.Tensor):
        per_row = int(a_scale.numel() != 1)
        _check(a_scale, "a_scale", torch.float32, (M, 1) if per_row else (1, 1),
               dev)
        a_scale_ptr = a_scale.data_ptr()
    else:
        a_scale_value = float(a_scale)
    colsum_ptr, zp = None, 0.0
    if a_zero_point is not None:
        zp = float(a_zero_point)
        colsum = ref.int4_zp_colsum(b_packed, b_scale, b_min,
                                    group_size=group_size, k=K).reshape(N)
        colsum_ptr = colsum.data_ptr()
    if bias is not None:
        _check(bias, "bias", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        p = tile or plan(M, N, K, group_size, n_g)
        shape = p.workspace_shape(M, N, n_g)
        ws = (None if shape is None
              else torch.empty(shape, dtype=torch.float32, device=dev))
        err = build.lib().repro_int4_matmul(
            a_q.data_ptr(), b_packed.data_ptr(), a_scale_ptr, a_scale_value,
            per_row, b_scale.data_ptr(), b_min.data_ptr(),
            SCALE_DTYPES[b_scale.dtype], colsum_ptr, zp,
            int(a_zero_point is not None),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, n_g, group_size, OUT_DTYPES[out_dtype], p.bm, p.splits,
            p.groups_per_slice, None if ws is None else ws.data_ptr(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "int4_matmul")
        build.count("int4_matmul")
    return out
