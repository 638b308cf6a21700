"""K6's plan (``repro_torch/kernels/int4_matmul.py:plan``) and the order of
its group-ordered split, on the CPU.

The plan picks the tile's rows and cuts K into slices of whole groups from
the shapes alone; the kernel itself runs only on the card
(``tests/test_torch_cuda.py``).  Here: the plan at the INT4 path's decode
shapes and at ragged ones, the invariants of every plan (slices of whole
groups that cover the groups in order, the workspace that follows), and
the split's arithmetic emulated in torch, slice by slice (each group's f32
term, then the terms summed in ascending groups from 0), which must equal
the plain version bit for bit, and the JAX reference's plain version too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import qtensor as jqt
from repro.kernels import ref as jref

from repro_torch.core import quantize_block
from repro_torch.core.qtensor import unpack_nibbles
from repro_torch.kernels import ref
from repro_torch.kernels.int4_matmul import (
    BN,
    MAX_SPLIT_GROUPS,
    SPLIT_TILES,
    Plan,
    plan,
)

# (M, K, N, G) -> (bm, splits, groups a slice): the INT4 decoder linears of
# transformer-base at decode (16 rows greedy, 64 beam-4; group 128), the
# same at groups of 32 and 6, and ragged N
MAIN_PATH = {
    (16, 512, 512, 128): (16, 4, 1),
    (16, 512, 2048, 128): (16, 4, 1),
    (16, 2048, 512, 128): (16, 16, 1),
    (64, 512, 512, 128): (64, 4, 1),
    (64, 512, 2048, 128): (64, 4, 1),
    (64, 2048, 512, 128): (64, 16, 1),
    (16, 512, 512, 32): (16, 16, 1),
    (16, 512, 2048, 32): (16, 8, 2),
    (16, 2048, 512, 32): (16, 32, 2),
    (64, 512, 512, 32): (64, 16, 1),
    (64, 512, 2048, 32): (64, 8, 2),
    (64, 2048, 512, 32): (64, 32, 2),
    (16, 512, 512, 6): (16, 1, 86),
    (64, 2048, 512, 6): (64, 1, 342),
    (16, 90, 40, 6): (16, 15, 1),
    (17, 200, 72, 32): (32, 7, 1),
    (65, 512, 130, 128): (64, 4, 1),
    (300, 2048, 512, 128): (64, 6, 3),
    (1, 128, 130, 128): (16, 1, 1),
}


def _check_invariants(M, K, N, G):
    p = plan(M, N, K, G)
    n_g = -(-K // G)
    assert p.bm == (16 if M <= 16 else 32 if M <= 32 else 64)
    tiles = -(-M // p.bm) * -(-N // BN)
    slices = p.slices(n_g)
    # slices of whole groups, in order, covering every group once
    assert slices[0][0] == 0 and slices[-1][1] == n_g
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(g1 > g0 for g0, g1 in slices)
    assert all(g1 - g0 == p.groups_per_slice for g0, g1 in slices[:-1])
    assert p.splits == -(-n_g // p.groups_per_slice)
    if p.splits == 1:
        assert p.workspace_shape(M, N, n_g) is None
        assert tiles >= SPLIT_TILES or not 2 <= n_g <= MAX_SPLIT_GROUPS
    else:
        assert tiles < SPLIT_TILES and 2 <= n_g <= MAX_SPLIT_GROUPS
        assert p.workspace_shape(M, N, n_g) == (n_g, M, N)
        assert p.splits <= 65535
    return p


@pytest.mark.parametrize("M,K,N,G", sorted(MAIN_PATH))
def test_plan_at_main_path_shapes(M, K, N, G):
    p = _check_invariants(M, K, N, G)
    assert (p.bm, p.splits, p.groups_per_slice) == MAIN_PATH[(M, K, N, G)]


@pytest.mark.parametrize("G", [2, 6, 32, 48, 128, 256])
def test_plan_invariants(G):
    """Every plan over ragged and round shapes keeps the invariants."""
    for M in (1, 5, 16, 17, 33, 64, 65, 300):
        for N in (40, 130, 512, 2048):
            for K in (G, 90, 512, 2048, 4096):
                if K >= 2:
                    _check_invariants(M, K, N, G)


def test_plan_workspace_of_the_decode_splits():
    """The enc-dec FFN down projection at decode (16 × 2048 → 512, G =
    128): 16 slices of one group, a (16, 16, 512) f32 workspace of 512 KiB;
    at beam 4 (64 rows) 2 MiB, four times the packed weights."""
    p = plan(16, 512, 2048, 128)
    assert p.slices(16) == [(g, g + 1) for g in range(16)]
    assert 4 * np.prod(p.workspace_shape(16, 512, 16)) == 524288
    q = plan(64, 512, 2048, 128)
    assert 4 * np.prod(q.workspace_shape(64, 512, 16)) == 2 * 2 ** 20
    assert 2048 * 512 // 2 == 2 ** 19


def test_plan_splits_only_short_grids():
    """No split where the tiles already fill half the card, with one group
    or with more than ``MAX_SPLIT_GROUPS`` groups; the stored groups, not
    K, count."""
    assert plan(300, 2048, 512, 128).splits == 1       # 5 × 32 = 160 tiles
    assert plan(16, 512, 128, 128).splits == 1         # one group
    assert plan(16, 512, 128, 128, n_groups=2).splits == 2
    assert plan(16, 512, 2048, 6).splits == 1          # 342 groups
    assert plan(16, 512, 384, 6).splits == 32          # 64 groups, 2 a slice


# ---------------------------------------------------------------------------
# the split's order, emulated
# ---------------------------------------------------------------------------

def split_order(a, a_scale, b_packed, b_scale, b_min, zp, bias, *, G, tile,
                out_dtype):
    """K6's arithmetic in the kernel's order: each slice of ``tile`` on its
    own computes its groups' f32 terms t_g = d_g · s_g + r_g · mn_g (d_g
    and r_g exact) into the workspace; then the terms are summed in
    ascending g from 0 and the epilogue runs."""
    M, K = a.shape
    n_g, N = b_scale.shape
    nib = unpack_nibbles(b_packed)
    a_p = torch.nn.functional.pad(a, (0, n_g * G - K))
    sc, mn = b_scale.float(), b_min.float()
    ws = torch.full((n_g, M, N), float("nan"))
    for g0, g1 in tile.slices(n_g):
        for g in range(g0, g1):
            ag = a_p[:, g * G:(g + 1) * G]
            d = (ag.double() @ nib[g * G:(g + 1) * G].double()).float()
            r = ag.int().sum(dim=1, keepdim=True).float()
            ws[g] = d * sc[g] + r * mn[g]
    acc = torch.zeros((M, N))
    for g in range(n_g):
        acc = acc + ws[g]
    if zp is not None:
        acc = acc - torch.tensor(zp, dtype=torch.float32) * ref.int4_zp_colsum(
            b_packed, b_scale, b_min, group_size=G, k=K)
    out = acc * a_scale
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _inputs(M, K, N, G, seed, scale_dtype=torch.float16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    bq = quantize_block(torch.from_numpy(w), G, scale_dtype=scale_dtype)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    a_s = torch.from_numpy((rng.random((M, 1)) * 0.02).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    return a, a_s, bq, bias


@pytest.mark.parametrize("M,K,N,G", [(16, 512, 512, 128), (16, 512, 2048, 128),
                                     (16, 2048, 512, 128), (64, 512, 512, 128),
                                     (64, 512, 2048, 128), (64, 2048, 512, 128),
                                     (17, 200, 72, 32), (5, 90, 40, 6),
                                     (65, 512, 130, 128)])
def test_split_order_equals_plain(M, K, N, G):
    """The plan's split and every other slicing (one slice, slices of 1, 2
    and 3 groups), in f32 and bf16, with and without a zero point, equal
    ``ref_int4_matmul`` bit for bit."""
    a, a_s, bq, bias = _inputs(M, K, N, G, seed=M + K + N + G)
    n_g = bq.scale.shape[0]
    tiles = {plan(M, N, K, G)} | {Plan(16, -(-n_g // per), per)
                                  for per in (n_g, 1, 2, 3)}
    for dt in (torch.float32, torch.bfloat16):
        for zp, b in ((None, bias), (2.5, None)):
            want = ref.ref_int4_matmul(a, a_s, bq.data, bq.scale, bq.vmin,
                                       zp, b, group_size=G, out_dtype=dt)
            for tile in tiles:
                got = split_order(a, a_s, bq.data, bq.scale, bq.vmin, zp, b,
                                  G=G, tile=tile, out_dtype=dt)
                assert torch.equal(got, want), (dt, zp, tile)


@pytest.mark.parametrize("scale", ["f16", "f32"])
@pytest.mark.parametrize("M,K,N,G", [(16, 512, 512, 128), (7, 96, 40, 32)])
def test_split_order_equals_reference(M, K, N, G, scale):
    """The emulated split against the JAX reference's plain version, on the
    reference's own block-quantized weights: bit-identical in f32."""
    rng = np.random.default_rng(M * K)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jdt = jnp.float16 if scale == "f16" else jnp.float32
    bq = jqt.quantize_block(jnp.asarray(w), G, scale_dtype=jdt)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    a_s = (rng.random((M, 1)) * 0.02).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(jref.ref_int4_matmul(
        jnp.asarray(a), jnp.asarray(a_s), bq.data, bq.scale, bq.vmin, None,
        jnp.asarray(bias), group_size=G))
    got = split_order(torch.from_numpy(a), torch.from_numpy(a_s),
                      torch.from_numpy(np.array(bq.data)),
                      torch.from_numpy(np.array(bq.scale)),
                      torch.from_numpy(np.array(bq.vmin)), None,
                      torch.from_numpy(bias), G=G, tile=plan(M, N, K, G),
                      out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
