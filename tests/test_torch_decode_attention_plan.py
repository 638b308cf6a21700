"""K4 and K5's plan (``repro_torch/kernels/decode_attention.py:plan``) and
the order of their chunked fold, on the CPU.

The plan picks the split of the sequence over a thread block cluster and
the warps of a block from the shapes alone; the kernels themselves run
only on the card (``tests/test_torch_cuda.py``).
Here: the plan at the main paths' shapes, the invariants of every plan,
and the kernels' arithmetic emulated in torch chunk by chunk (each chunk
of ``CHUNK`` positions with its own max, the partials folded in ascending
chunk order with one formula), which must not depend on the split or the
warps (bit for bit), must equal the plain version and the JAX reference
within the kernels' tolerances (f32 1e-5; bf16 one bf16 ulp), and must give
a row the same bits alone or in a batch, paged or contiguous.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    CHUNK,
    MAX_SPLIT,
    SPLITS,
    TARGET_BLOCKS,
    WARPS,
    Plan,
    _SMEM_LIMIT,
    all_plans,
    chunks,
    head_tile,
    plan,
    smem_bytes,
)
from repro_torch.models.kv_cache import linearize_pages

JAX_IMPLS = ("xla", "interpret")

# (B, S, HKV, G, dh) -> plan: K4 on the enc-dec decoder (8 heads, capacity
# 64; greedy 16 rows, beam-4 64) and the MoE decoder (16 heads over 8,
# capacity 80), K5 on the serve grid (16 slots, 4 pages of 16; 64 rows;
# 4 kv heads of 2), and the long cache of 4096 positions
MAIN_PATH = {
    (16, 64, 8, 1, 64): Plan(1, 2),
    (64, 64, 8, 1, 64): Plan(1, 2),
    (16, 80, 8, 2, 64): Plan(1, 4),
    (64, 80, 8, 2, 64): Plan(1, 4),
    (16, 64, 4, 2, 64): Plan(1, 2),
    (16, 4096, 8, 2, 64): Plan(4, 4),
    (16, 4096, 8, 1, 64): Plan(4, 4),
    (64, 4096, 8, 2, 64): Plan(1, 4),
}


def _check_invariants(B, S, HKV, G, dh):
    p = plan(B, S, HKV, G, dh)
    assert p in all_plans(S)
    assert p.split in SPLITS and p.warps in WARPS
    assert p.split <= max(1, chunks(S))
    blocks = B * HKV * -(-G // head_tile(G, dh))
    # 2 warps for rows of at most 2 chunks, else 4; a split only where each
    # warp would walk more than 2 chunks, within TARGET_BLOCKS
    assert p.warps == (2 if chunks(S) <= 2 else 4)
    if chunks(S) <= 2 * p.warps:
        assert p.split == 1
    else:
        assert p.split == 1 or blocks * p.split <= TARGET_BLOCKS
    assert smem_bytes(p, G, dh, S) <= _SMEM_LIMIT
    return p


@pytest.mark.parametrize("shape", sorted(MAIN_PATH))
def test_plan_at_main_path_shapes(shape):
    assert _check_invariants(*shape) == MAIN_PATH[shape]


@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 12])
def test_plan_invariants(G):
    """Every plan over ragged and round shapes keeps the invariants."""
    for B in (1, 5, 16, 64, 300):
        for S in (1, CHUNK - 1, CHUNK, CHUNK + 1, 64, 80, 1000, 4096):
            for HKV in (1, 2, 8):
                for dh in (16, 32, 64, 128):
                    _check_invariants(B, S, HKV, G, dh)


def test_k5_takes_k4_plan_at_its_capacity():
    """K5 plans at maxP · ps: the serve grid's 4 pages of 16 take the plan
    of K4 at capacity 64, whatever the page size that makes 64."""
    for maxP, ps in ((4, 16), (16, 4), (64, 1)):
        assert plan(16, maxP * ps, 8, 1, 64) == plan(16, 64, 8, 1, 64)
    # the block table adds its maxP entries to the shared memory
    p = plan(16, 64, 8, 1, 64)
    assert smem_bytes(p, 1, 64, 64, maxP=4) == smem_bytes(p, 1, 64, 64) + 16


def test_plan_falls_back_to_no_split_where_partials_do_not_fit():
    """A split keeps every chunk's partial of its rank in shared memory; a
    capacity whose partials would not fit runs unsplit."""
    S = 2 ** 21
    p = plan(1, S, 8, 8, 64)
    assert p.split == 1
    assert smem_bytes(Plan(MAX_SPLIT, p.warps), 8, 64, S) \
        > _SMEM_LIMIT
    assert smem_bytes(p, 8, 64, S) <= _SMEM_LIMIT


def test_main_path_plans_need_no_shared_memory_opt_in():
    """The decode shapes' plans stay under the 48 KB a launch gets without
    the opt-in attribute (which the kernels set anyway)."""
    for (B, S, HKV, G, dh), p in MAIN_PATH.items():
        if S <= 80:
            assert smem_bytes(p, G, dh, S, maxP=S // 16) <= 48 * 1024


def test_head_tiles():
    """At most 8 query heads a block (4 at dh 128), so the registers of a
    warp's (heads, dh) partial stay bounded."""
    assert head_tile(2, 64) == 2 and head_tile(12, 64) == 8
    assert head_tile(8, 128) == 4 and head_tile(3, 16) == 3


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated chunk by chunk
# ---------------------------------------------------------------------------

def _chunk_partial(q, kq, ks, vq, vs, sm_scale):
    """One chunk's partial for (G, dh) queries against n cached rows:
    scores from the 4 parts of dh summed (p0 + p1) + (p2 + p3), the chunk's
    own max m, p = exp(s - m), l = sum p, and acc = the two half-warps'
    sums over alternate positions, added."""
    G, dh = q.shape
    k = kq.float()
    parts = [q[:, None, j * dh // 4:(j + 1) * dh // 4]
             * k[None, :, j * dh // 4:(j + 1) * dh // 4] for j in range(4)]
    dots = ((parts[0].sum(-1) + parts[1].sum(-1))
            + (parts[2].sum(-1) + parts[3].sum(-1)))            # (G, n)
    s = (dots * ks[None, :]) * sm_scale
    m = s.max(dim=1).values                                      # (G,)
    p = torch.exp(s - m[:, None])
    l = p.sum(dim=1)
    pv = p * vs[None, :]
    v = vq.float()
    acc = (pv[:, 0::2] @ v[0::2]) + (pv[:, 1::2] @ v[1::2])       # (G, dh)
    return m, l, acc


def _fold(M, L, A, m, l, acc):
    Mn = torch.maximum(M, m)
    x = torch.exp(M - Mn)
    y = torch.exp(m - Mn)
    return Mn, L * x + l * y, A * x[:, None] + acc * y[:, None]


def emulate(q, kq, ks, vq, vs, lengths, sm_scale, *, split=1, warps=4,
            chunk=CHUNK):
    """K4's arithmetic in its order, row by row: rank r of ``split`` takes
    chunks r, r + split, ..., its warps in rounds of ``warps``; every
    chunk's partial is kept; then the partials are folded from chunk 0 in
    ascending order.  Returns the output in q's dtype."""
    B, S, HKV, dh = kq.shape
    H = q.shape[1]
    G = H // HKV
    out = torch.zeros((B, H, dh), dtype=torch.float32)
    for b in range(B):
        end = min(int(lengths[b]), S)
        n_chunks = -(-end // chunk)
        for h in range(HKV):
            qh = q[b, h * G:(h + 1) * G].float()
            partials = {}
            for rank in range(split):
                mine = list(range(rank, n_chunks, split))
                for r0 in range(0, len(mine), warps):      # a round
                    for ci in mine[r0:r0 + warps]:
                        s0 = ci * chunk
                        s1 = min(end, s0 + chunk)
                        partials[ci] = _chunk_partial(
                            qh, kq[b, s0:s1, h], ks[b, s0:s1, h],
                            vq[b, s0:s1, h], vs[b, s0:s1, h], sm_scale)
            M = torch.full((G,), -1e30)
            L = torch.zeros(G)
            A = torch.zeros((G, dh))
            for ci in range(n_chunks):
                M, L, A = _fold(M, L, A, *partials[ci])
            out[b, h * G:(h + 1) * G] = A / torch.clamp_min(L, 1e-30)[:, None]
    return out.to(q.dtype)


def _inputs(B, S, HKV, G, dh, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * G, dh)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, S, HKV, dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, S, HKV, dh)).astype(np.int8)
    ks = (rng.random((B, S, HKV)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((B, S, HKV)) * 0.02 + 1e-3).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    return (t(q), t(kq), t(ks), t(vq), t(vs),
            torch.tensor(lengths, dtype=torch.int32))


LENGTHS = (1, CHUNK - 1, CHUNK, CHUNK + 1, 70)   # 70: the full capacity


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_chunked_fold_equals_plain(G, dtype):
    """f32 within 1e-5; bf16 output within one bf16 ulp (2^-8 relative)."""
    q, kq, ks, vq, vs, lengths = _inputs(5, 70, 2, G, 64, LENGTHS, seed=G)
    q = q.to(dtype)
    got = emulate(q, kq, ks, vq, vs, lengths, 0.125).float()
    want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, 0.125).float()
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got, want, atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_chunked_fold_same_bits_under_every_plan(G):
    """Neither the split nor the warps a round change a bit: the partials
    depend on their positions and the fold on the chunk index only."""
    q, kq, ks, vq, vs, lengths = _inputs(3, 70, 2, G, 32, (70, 33, 17),
                                         seed=10 + G)
    base = emulate(q, kq, ks, vq, vs, lengths, 0.125)
    for split in SPLITS:
        for warps in WARPS:
            got = emulate(q, kq, ks, vq, vs, lengths, 0.125, split=split,
                          warps=warps)
            assert torch.equal(got, base), (split, warps)


def test_chunked_fold_row_independent():
    """A row's output is the same bits alone or among other rows of other
    lengths (the engine's paged == contiguous, burst and serve == generate
    contracts rest on it)."""
    q, kq, ks, vq, vs, lengths = _inputs(6, 48, 2, 2, 16,
                                         (48, 1, 17, 30, 16, 5), seed=7)
    batch = emulate(q, kq, ks, vq, vs, lengths, 0.25)
    for b in range(6):
        alone = emulate(q[b:b + 1], kq[b:b + 1], ks[b:b + 1], vq[b:b + 1],
                        vs[b:b + 1], lengths[b:b + 1], 0.25, split=2)
        assert torch.equal(alone[0], batch[b]), b


@pytest.mark.parametrize("ps", [4, 16])
def test_chunked_fold_paged_equals_contiguous(ps):
    """K5 reads a row's pages through its block table in position order, so
    on the pages it computes what K4 computes on the linearized cache; a
    sentinel entry (P) clamps into the pool and is masked by the length."""
    B, maxP, HKV, G, dh = 3, 64 // ps, 2, 2, 16
    P = B * maxP
    rng = np.random.default_rng(ps)
    perm = rng.permutation(P).astype(np.int32)
    lengths = np.array([64, CHUNK + 1, 3], np.int32)
    tables = np.full((B, maxP), P, np.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = perm[b * maxP:b * maxP + n]
    pool = lambda shape, lo, hi: torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int8))
    kp, vp = pool((P, ps, HKV, dh), -127, 128), pool((P, ps, HKV, dh), -127,
                                                     128)
    ksp = torch.from_numpy((rng.random((P, ps, HKV)) * 0.02).astype(np.float32))
    vsp = torch.from_numpy((rng.random((P, ps, HKV)) * 0.02).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, HKV * G, dh)).astype(
        np.float32))
    tab = torch.from_numpy(tables)
    lin = lambda a: linearize_pages(a, tab)
    got = emulate(q, lin(kp), lin(ksp), lin(vp), lin(vsp),
                  torch.from_numpy(lengths), 0.25)
    want = ref.ref_decode_attention_paged(q, kp, ksp, vp, vsp, tab,
                                          torch.from_numpy(lengths), 0.25)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("H,HKV", [(4, 4), (4, 2), (8, 2)])
def test_chunked_fold_equals_jax_reference(impl, H, HKV):
    """The emulated kernel against the reference's plain version and its
    Pallas kernel in interpret mode, as ``tests/test_torch_kernels.py``
    runs them: f32 within 1e-5."""
    q, kq, ks, vq, vs, lengths = _inputs(4, 40, HKV, H // HKV, 16,
                                         (1, CHUNK + 1, 40, 29), seed=H + HKV)
    got = emulate(q, kq, ks, vq, vs, lengths, 0.25)
    want = jops.decode_attention(*[jnp.asarray(t.numpy()) for t in
                                   (q, kq, ks, vq, vs, lengths)],
                                 sm_scale=0.25, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
