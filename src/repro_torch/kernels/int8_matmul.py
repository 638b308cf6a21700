"""s8·s8→s32 matmul with the dequantize epilogue fused (K3), its two
halves for a product split across ranks (the accumulator alone, and the
epilogue alone), and its per-expert grouped form (K7), on the card.

Ports of ``repro/kernels/int8_matmul.py:int8_matmul_pallas`` and
``:int8_matmul_batched_pallas``.  Both run the tensor-core tile in
``csrc/int8_matmul.cu`` (K7 with the expert as a grid axis).  :func:`plan`
picks the tile configuration and the split of K from the shapes alone, so
the CPU tests can check it; these wrappers check their inputs, compute the
zero-point column sums (as the reference's wrapper does, outside the
kernel, and only for asymmetric activations), allocate the output and the
split-K workspace, launch on the current stream and count the launch
(once per call, with or without the split's reduction kernel).  The plain
versions are ``ref.ref_int8_matmul`` and ``ref.ref_int8_matmul_batched``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build

OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132                 # streaming multiprocessors of an H100 SXM
# Set from tools/int8_tile_sweep.py on an H100 (times in PERF.md §6):
# the large tile from LARGE_M rows on, where its E·⌈M/128⌉·⌈N/128⌉ tiles
# fill at least LARGE_MIN_TILES blocks (at 736 × 1024 → 1024, 48 tiles, the
# small tile was 1.3× faster; at 736 × 512 → 2048, 96 tiles, 1.6× slower)
LARGE_M = 65
LARGE_MIN_TILES = SMS // 2
# split K while the small tile's output tiles are fewer than SPLIT_TILES
# and a block's serial work, K stages × m16 fragments, is at least
# MIN_SPLIT_WORK, into as many slices as bring the blocks up to
# TARGET_BLOCKS (16 × 2048 → 512, 8 tiles: 1.5× faster in 8 slices;
# 64 × 512 → 512: 1.2× in 2; 65 × 2048 → 512: 1.1× faster in 8 slices than
# in 4; 16 × 1024 → 512, or 96 tiles and more: the reduction's launch
# costs what the split gains, or more)
SPLIT_TILES = SMS // 2
TARGET_BLOCKS = SMS
MIN_SPLIT_WORK = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the tile: its configuration and the split of K."""
    config: str           # "small" (decode) or "large" (prefill)
    bm: int               # output tile rows
    bn: int               # output tile columns
    bk: int               # K bytes a pipeline stage
    splits: int           # K slices (1: no split, no workspace)
    slice_k: int          # K bytes of each slice but the last (ends at K)

    def workspace_shape(self, E: int, M: int, N: int) -> Optional[Tuple]:
        """The s32 partials' shape, (splits, E, M, N), or None unsplit."""
        return (self.splits, E, M, N) if self.splits > 1 else None


def plan(E: int, M: int, N: int, K: int) -> Plan:
    """The tile configuration and the split of K for ``E`` products of
    (M, K) × (K, N), from the shapes alone.

    Large M (prefill) takes BM = BN = 128, BK = 64, where M ≥ ``LARGE_M``
    and its tiles fill ``LARGE_MIN_TILES`` blocks; otherwise the small tile
    takes BM = 16·⌈M/16⌉ ≤ 64, BN = 64, BK = 128.  The small tile splits K
    when its E·⌈M/BM⌉·⌈N/BN⌉ output tiles are fewer than ``SPLIT_TILES``
    and its ⌈K/BK⌉ stages times BM/16 fragments reach ``MIN_SPLIT_WORK``:
    into slices of a whole number of BK stages, at least two each, as many
    as bring the blocks up to ``TARGET_BLOCKS``; the last slice ends at K
    and is at least as deep as the others.
    """
    if M >= LARGE_M and E * -(-M // 128) * -(-N // 128) >= LARGE_MIN_TILES:
        return Plan("large", 128, 128, 64, 1, K)
    bm, bn, bk = min(64, 16 * max(1, -(-M // 16))), 64, 128
    splits, slice_k = 1, K
    tiles = E * -(-M // bm) * -(-N // bn)
    steps = -(-K // bk)
    if tiles < SPLIT_TILES and steps * (bm // 16) >= MIN_SPLIT_WORK:
        per = max(2, -(-steps // -(-TARGET_BLOCKS // tiles)))
        if K // (per * bk) >= 2:
            splits, slice_k = K // (per * bk), per * bk
    return Plan("small", bm, bn, bk, splits, slice_k)


def _workspace(p: Plan, E: int, M: int, N: int, dev: torch.device):
    shape = p.workspace_shape(E, M, N)
    return (None if shape is None
            else torch.empty(shape, dtype=torch.int32, device=dev))


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device, kernel: str = "int8_matmul") -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def int8_matmul_cuda(
    a_q: torch.Tensor,                      # (M, K) int8
    a_scale: Union[torch.Tensor, float],    # (M, 1) / (1, 1) f32, or a float
    b_q: torch.Tensor,                      # (K, N) int8
    b_scale: torch.Tensor,                  # (1, N) f32
    a_zero_point: Optional[float] = None,   # q-space offset
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    *,
    out_dtype: torch.dtype = torch.float32,
    tile: Optional[Plan] = None,
) -> torch.Tensor:
    """K3; ``tile`` overrides :func:`plan` (for measuring the
    configurations against each other)."""
    if not a_q.is_cuda:
        raise ValueError(f"int8_matmul: needs CUDA tensors, got {a_q.device}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a_q.shape)} x "
                         f"{tuple(b_q.shape)} do not multiply")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_matmul: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    M, K = a_q.shape
    N = b_q.shape[1]
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (M, K), dev)
    _check(b_q, "b_q", torch.int8, (K, N), dev)
    _check(b_scale, "b_scale", torch.float32, (1, N), dev)
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
        colsum = b_q.to(torch.int32).sum(dim=0).to(torch.float32)
        colsum_ptr = colsum.data_ptr()
    if bias is not None:
        _check(bias, "bias", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        p = tile or plan(1, M, N, K)
        ws = _workspace(p, 1, M, N, dev)
        err = build.lib().repro_int8_matmul(
            a_q.data_ptr(), b_q.data_ptr(), a_scale_ptr, a_scale_value,
            per_row, b_scale.data_ptr(), colsum_ptr, zp,
            int(a_zero_point is not None),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, OUT_DTYPES[out_dtype], p.bm, p.splits, p.slice_k,
            None if ws is None else ws.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "int8_matmul")
        build.count("int8_matmul")
    return out


def int8_matmul_accumulate_cuda(
    a_q: torch.Tensor,                      # (M, K) int8
    b_q: torch.Tensor,                      # (K, N) int8
    *,
    tile: Optional[Plan] = None,
) -> torch.Tensor:
    """K3's tile without its epilogue: the exact s32 ``a_q @ b_q``, (M, N)
    int32, for a product whose K is split across ranks (the ranks'
    accumulators are summed, then :func:`int8_matmul_epilogue_cuda` runs
    once).  The plan is K3's at the same shapes."""
    kernel = "int8_matmul_accumulate"
    if not a_q.is_cuda:
        raise ValueError(f"{kernel}: needs CUDA tensors, got {a_q.device}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"{kernel}: shapes {tuple(a_q.shape)} x "
                         f"{tuple(b_q.shape)} do not multiply")
    M, K = a_q.shape
    N = b_q.shape[1]
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (M, K), dev, kernel)
    _check(b_q, "b_q", torch.int8, (K, N), dev, kernel)
    acc = torch.empty((M, N), dtype=torch.int32, device=dev)
    if acc.numel():
        p = tile or plan(1, M, N, K)
        ws = _workspace(p, 1, M, N, dev)
        err = build.lib().repro_int8_matmul_accumulate(
            a_q.data_ptr(), b_q.data_ptr(), acc.data_ptr(), M, N, K, p.bm,
            p.splits, p.slice_k, None if ws is None else ws.data_ptr(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, kernel)
        build.count(kernel)
    return acc


def int8_matmul_epilogue_cuda(
    acc: torch.Tensor,                      # (M, N) int32
    a_scale: Union[torch.Tensor, float],    # (M, 1) / (1, 1) f32, or a float
    b_scale: torch.Tensor,                  # (1, N) f32
    a_zero_point: Optional[float] = None,   # q-space offset
    colsum: Optional[torch.Tensor] = None,  # (N,) f32, with a zero point
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    *,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K3's epilogue alone on an s32 accumulator: the split K3's reduction
    over one slice, so ``epilogue(accumulate(a, b))`` is K3 bit for bit."""
    kernel = "int8_matmul_epilogue"
    if not acc.is_cuda:
        raise ValueError(f"{kernel}: needs CUDA tensors, got {acc.device}")
    if acc.dim() != 2:
        raise ValueError(f"{kernel}: acc must be (M, N), got "
                         f"{tuple(acc.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{kernel}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    M, N = acc.shape
    dev = acc.device
    _check(acc, "acc", torch.int32, (M, N), dev, kernel)
    _check(b_scale, "b_scale", torch.float32, (1, N), dev, kernel)
    a_scale_ptr, a_scale_value, per_row = None, 0.0, 0
    if isinstance(a_scale, torch.Tensor):
        per_row = int(a_scale.numel() != 1)
        _check(a_scale, "a_scale", torch.float32, (M, 1) if per_row else (1, 1),
               dev, kernel)
        a_scale_ptr = a_scale.data_ptr()
    else:
        a_scale_value = float(a_scale)
    zp = 0.0
    if a_zero_point is not None:
        zp = float(a_zero_point)
        _check(colsum, "colsum", torch.float32, (N,), dev, kernel)
    if bias is not None:
        _check(bias, "bias", torch.float32, (N,), dev, kernel)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        err = build.lib().repro_int8_matmul_epilogue(
            acc.data_ptr(), a_scale_ptr, a_scale_value, per_row,
            b_scale.data_ptr(),
            None if a_zero_point is None else colsum.data_ptr(), zp,
            int(a_zero_point is not None),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N,
            OUT_DTYPES[out_dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, kernel)
        build.count(kernel)
    return out


MAX_EXPERTS = 65535          # the grid's z extent (experts × K slices)


def int8_matmul_batched_cuda(
    a_q: torch.Tensor,                      # (E, M, K) int8
    a_scale: Union[torch.Tensor, float],    # (E, M, 1) / (1, 1, 1) f32, float
    b_q: torch.Tensor,                      # (E, K, N) int8
    b_scale: torch.Tensor,                  # (E, 1, N) f32
    *,
    out_dtype: torch.dtype = torch.float32,
    tile: Optional[Plan] = None,
) -> torch.Tensor:
    """K7: ``out[e] = (a_q[e] @ b_q[e]) · a_scale[e] · b_scale[e]``;
    ``tile`` overrides :func:`plan`."""
    kernel = "int8_matmul_batched"
    if not a_q.is_cuda:
        raise ValueError(f"{kernel}: needs CUDA tensors, got {a_q.device}")
    if (a_q.dim() != 3 or b_q.dim() != 3 or a_q.shape[0] != b_q.shape[0]
            or a_q.shape[2] != b_q.shape[1]):
        raise ValueError(f"{kernel}: shapes {tuple(a_q.shape)} x "
                         f"{tuple(b_q.shape)} do not multiply per expert")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{kernel}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    E, M, K = a_q.shape
    N = b_q.shape[2]
    if E > MAX_EXPERTS:
        raise ValueError(f"{kernel}: at most {MAX_EXPERTS} experts, got {E}")
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (E, M, K), dev, kernel)
    _check(b_q, "b_q", torch.int8, (E, K, N), dev, kernel)
    _check(b_scale, "b_scale", torch.float32, (E, 1, N), dev, kernel)
    a_scale_ptr, a_scale_value, per_row = None, 0.0, 0
    if isinstance(a_scale, torch.Tensor):
        per_row = int(a_scale.numel() != 1)
        _check(a_scale, "a_scale", torch.float32,
               (E, M, 1) if per_row else (1, 1, 1), dev, kernel)
        a_scale_ptr = a_scale.data_ptr()
    else:
        a_scale_value = float(a_scale)
    out = torch.empty((E, M, N), dtype=out_dtype, device=dev)
    if out.numel():
        p = tile or plan(E, M, N, K)
        if E * p.splits > MAX_EXPERTS:
            raise ValueError(f"{kernel}: {E} experts × {p.splits} K slices "
                             f"exceed the grid's {MAX_EXPERTS}")
        ws = _workspace(p, E, M, N, dev)
        err = build.lib().repro_int8_matmul_batched(
            a_q.data_ptr(), b_q.data_ptr(), a_scale_ptr, a_scale_value,
            per_row, b_scale.data_ptr(), out.data_ptr(), E, M, N, K,
            OUT_DTYPES[out_dtype], p.bm, p.splits, p.slice_k,
            None if ws is None else ws.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, kernel)
        build.count(kernel)
    return out
