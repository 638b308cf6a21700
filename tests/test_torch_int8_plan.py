"""The INT8 GEMM tile's plan (``repro_torch/kernels/int8_matmul.py:plan``),
on the CPU: which configuration and which split of K each shape of the
port's main paths gets, the split-K workspace, and the invariants of every
plan (slices of whole stages, at least two deep, covering K; no split
where the output tiles already fill the card).  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``); its choices are made here, in
Python, from the shapes alone.
"""

import numpy as np
import pytest

from repro_torch.kernels.int8_matmul import (
    LARGE_M,
    MIN_SPLIT_WORK,
    SMS,
    SPLIT_TILES,
    Plan,
    plan,
)

# (E, M, K, N) -> (config, bm, splits): transformer-base (16 requests,
# sources padded to 46, beam 4: M = 16, 64, 736) and granite-moe-1b-a400m
# (q/o 1024 -> 1024, k/v 1024 -> 512 at M = 16, 64, 736, 2944; its 32
# experts at 5, 20, 230 and 960 rows each)
MAIN_PATH = {
    (1, 16, 512, 512): ("small", 16, 1),
    (1, 16, 512, 2048): ("small", 16, 1),
    (1, 16, 2048, 512): ("small", 16, 8),
    (1, 64, 512, 512): ("small", 64, 2),
    (1, 64, 512, 2048): ("small", 64, 2),
    (1, 64, 2048, 512): ("small", 64, 8),
    (1, 736, 512, 512): ("small", 64, 1),
    (1, 736, 512, 2048): ("large", 128, 1),
    (1, 736, 2048, 512): ("small", 64, 1),
    (1, 16, 1024, 1024): ("small", 16, 1),
    (1, 16, 1024, 512): ("small", 16, 1),
    (1, 64, 1024, 1024): ("small", 64, 4),
    (1, 64, 1024, 512): ("small", 64, 4),
    (1, 736, 1024, 1024): ("small", 64, 1),
    (1, 736, 1024, 512): ("small", 64, 1),
    (1, 2944, 1024, 1024): ("large", 128, 1),
    (1, 2944, 1024, 512): ("large", 128, 1),
    (32, 5, 1024, 512): ("small", 16, 1),
    (32, 5, 512, 1024): ("small", 16, 1),
    (32, 20, 1024, 512): ("small", 32, 1),
    (32, 20, 512, 1024): ("small", 32, 1),
    (32, 230, 1024, 512): ("large", 128, 1),
    (32, 230, 512, 1024): ("large", 128, 1),
    (32, 960, 1024, 512): ("large", 128, 1),
    (32, 960, 512, 1024): ("large", 128, 1),
}

TILES = {"small": (64, 128), "large": (128, 64)}      # config -> (BN, BK)


def _slices(p: Plan, K: int):
    """The K ranges of the slices, as the kernel walks them."""
    return [(s * p.slice_k, K if s == p.splits - 1 else (s + 1) * p.slice_k)
            for s in range(p.splits)]


def _check_invariants(E, M, K, N):
    p = plan(E, M, N, K)
    bn, bk = TILES[p.config]
    assert (p.bn, p.bk) == (bn, bk)
    assert p.bm in ((16, 32, 48, 64) if p.config == "small" else (128,))
    if p.config == "small":
        assert p.bm == min(64, 16 * -(-M // 16))
    else:
        assert M >= LARGE_M
    tiles = E * -(-M // p.bm) * -(-N // p.bn)
    if tiles >= 2 * SMS or p.config == "large":
        assert p.splits == 1
    if p.splits == 1:
        assert p.workspace_shape(E, M, N) is None
        return p
    assert tiles < SPLIT_TILES
    assert -(-K // bk) * (p.bm // 16) >= MIN_SPLIT_WORK
    assert p.slice_k % bk == 0 and p.slice_k >= 2 * bk
    ranges = _slices(p, K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    depths = [b - a for a, b in ranges]
    assert min(depths) >= 2 * bk                  # every slice ≥ 2 BK deep
    assert depths[-1] >= p.slice_k                # the last is the deepest
    assert E * p.splits <= 65535
    assert p.workspace_shape(E, M, N) == (p.splits, E, M, N)
    return p


@pytest.mark.parametrize("E,M,K,N", sorted(MAIN_PATH))
def test_plan_at_main_path_shapes(E, M, K, N):
    p = _check_invariants(E, M, K, N)
    assert (p.config, p.bm, p.splits) == MAIN_PATH[(E, M, K, N)]


def test_plan_workspace_of_the_decode_splits():
    """The enc-dec FFN down projection at decode: 8 slices of 256, a
    (8, 1, 16, 512) s32 workspace of 256 KiB."""
    p = plan(1, 16, 512, 2048)
    assert p.slice_k == 256
    shape = p.workspace_shape(1, 16, 512)
    assert shape == (8, 1, 16, 512)
    assert 4 * np.prod(shape) == 262144                       # s32 bytes
    q = plan(1, 64, 1024, 1024)
    assert (q.splits, q.slice_k) == (4, 256)
    assert 4 * np.prod(q.workspace_shape(1, 64, 1024)) == 4 * 64 * 1024 * 4


@pytest.mark.parametrize("M", [1, 5, 16, 17, 33, 64, 65, 129, 300, 736, 2944])
def test_plan_invariants(M):
    """Every plan over ragged and round shapes keeps the invariants."""
    for E in (1, 3, 32):
        for N in (48, 130, 512, 1024, 2048):
            for K in (64, 130, 512, 1000, 1024, 2048, 2050, 4096):
                _check_invariants(E, M, K, N)


def test_plan_splits_only_short_grids():
    """S = 1 wherever the grid already fills 2 × 132 blocks, and a split
    appears once the tiles are few and K is deep."""
    assert plan(33, 16, 512, 2048).splits == 1        # 264 tiles
    assert plan(1, 16, 512, 1024).splits == 1         # 8 stages × 1 fragment
    assert plan(1, 17, 512, 1024).splits == 4         # 8 stages × 2
    assert plan(1, 64, 512, 512).splits == 2          # 4 stages × 4
    deep = plan(1, 16, 512, 4096)        # 8 tiles × 16 slices ≈ 132 blocks
    assert (deep.splits, deep.slice_k) == (16, 256)
