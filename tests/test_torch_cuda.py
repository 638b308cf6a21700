"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips, with its reason, where there is no CUDA
device (as on a CPU-only host).  Run on a GPU host with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

The first test builds the kernels from ``src/repro_torch/csrc`` (seconds).
``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import Calibrator, QuantPolicy, Taps, quantize_model
from repro_torch.data import make_corpus, pad_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    CHUNK,
    Plan as AttentionPlan,
    all_plans,
    decode_attention_cuda,
    decode_attention_paged_cuda,
    smem_bytes,
)
from repro_torch.kernels.decode_attention import plan as attention_plan
from repro_torch.core import quantize_block
from repro_torch.kernels.int4_matmul import int4_matmul_cuda
from repro_torch.kernels.int8_matmul import (
    Plan,
    int8_matmul_accumulate_cuda,
    int8_matmul_batched_cuda,
    int8_matmul_cuda,
    int8_matmul_epilogue_cuda,
    plan,
)
from repro_torch.kernels.quantize import (
    quantize_rowwise_cuda,
    quantize_static_cuda,
)
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.models import kv_cache as kvc
from repro_torch.models.kv_cache import linearize_pages
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _quantizer_input(gen, M, K, dtype, offset):
    """(M, K) values for K1 (threshold 127, so its multiplier is 1) and K2:
    normal draws; row 0 all zero (scale 1e-12 · f32(1/127), codes 0); row 1
    with abs-max 127 (scale exactly 1, so the codes are the values) holding
    every half-integer in (-127, 127), which must round half to even; row 2
    with values past the threshold (clip to ±127, never -128).  ``offset``
    elements before the base make it unaligned (a slice, still
    contiguous)."""
    x = torch.randn((M, K), generator=gen, device="cuda") * 60
    halves = torch.arange(-253, 254, device="cuda") / 2.0
    if M > 1:
        x[0] = 0.0
        x[1] = halves.repeat(-(-K // halves.numel()))[:K]
        x[1, 0] = 127.0
    if M > 2:
        x[2] = torch.tensor([-127.5, -128.0, 127.5, 300.0, -1e6, 128.5],
                            device="cuda").repeat(-(-K // 6))[:K]
        x[2, 0] = 127.0
    flat = torch.zeros(M * K + offset, device="cuda", dtype=dtype)
    flat[offset:] = x.reshape(-1).to(dtype)
    return flat[offset:].view(M, K)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [64, 130, 200, 512, 1024, 2048, 8192])
def test_quantizers_exact(gen, dtype, K):
    """K1 and K2 bit for bit against their plain versions (codes, and K2's
    scales) under the plan and under every plan forced, aligned and offset
    by one element (the scalar path), at 1, 12, 160 and 2944 rows."""
    from repro_torch.kernels.quantize import (is_aligned, plan,
                                              rowwise_plans, static_plans)
    for M in (1, 12, 160, 2944):
        for offset in (0, 1):
            x = _quantizer_input(gen, M, K, dtype, offset)
            aligned = is_aligned(x)
            assert aligned == (offset == 0)
            want = ref.ref_quantize_static(x, 127.0)
            rq, rs = ref.ref_quantize_rowwise(x)
            default = plan(M, K, dtype, aligned)
            for p in [None, default.static] + static_plans(M, K, dtype,
                                                           aligned):
                assert torch.equal(quantize_static_cuda(x, 127.0, tile=p),
                                   want), (M, K, offset, p)
            assert torch.equal(quantize_static_cuda(x, 2.5),
                               ref.ref_quantize_static(x, 2.5))
            for p in [None, default.rowwise] + rowwise_plans(M, K, dtype,
                                                             aligned):
                q, s = quantize_rowwise_cuda(x, tile=p)
                assert torch.equal(q, rq) and torch.equal(s, rs), \
                    (M, K, offset, p)
            if M > 2:
                assert int(want.min()) == -127 and int(rq.min()) == -127
                assert (rq[0] == 0).all() and float(rs[0]) == float(
                    np.float32(1e-12) * (np.float32(1) / np.float32(127)))
                assert float(rs[1]) == 1.0
                row = x[1].float()
                assert int((row.frac().abs() == 0.5).sum()) >= \
                    (min(K, 507) - 1) // 2
                assert torch.equal(rq[1].long(),
                                   torch.round(row).clamp(-127, 127).long())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rowwise_every_bf16_value(gen, dtype):
    """K2 (the IEEE division, then the clip and the low-byte rounding)
    equals the plain version for every finite bf16 value, in rows of 8192
    whose abs-max is one of several bf16 values (127: scale exactly 1), under
    the plan and every plan forced."""
    from repro_torch.kernels.quantize import is_aligned, rowwise_plans
    bits = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(
        torch.float32)
    bits = bits[torch.isfinite(bits)]
    K, rows = 8192, []
    for amax in (127.0, 1.0, 2.5, 0.0117, 3e-13, 1e30):
        a = float(torch.tensor(amax).to(torch.bfloat16).float())
        vals = bits[bits.abs() <= a]
        for i in range(0, vals.numel(), K - 1):
            row = torch.zeros(K)
            row[0] = a
            chunk = vals[i:i + K - 1]
            row[1:1 + chunk.numel()] = chunk
            rows.append(row)
    x = torch.stack(rows).to(dtype).cuda()
    rq, rs = ref.ref_quantize_rowwise(x)
    M = x.shape[0]
    for p in [None] + rowwise_plans(M, K, dtype, is_aligned(x)):
        q, s = quantize_rowwise_cuda(x, tile=p)
        assert torch.equal(q, rq) and torch.equal(s, rs), p


def test_quantizer_plans_refused(gen):
    """A forced vector plan on an unaligned input is refused, not run."""
    from repro_torch.kernels.quantize import RowwisePlan, StaticPlan
    x = _quantizer_input(gen, 16, 512, torch.bfloat16, 1)
    with pytest.raises(ValueError):
        quantize_static_cuda(x, 1.0, tile=StaticPlan(True, 4))
    with pytest.raises(ValueError):
        quantize_rowwise_cuda(x, tile=RowwisePlan(2, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_static_unclamped_threshold(gen, dtype):
    """K1 with the threshold's clamp off (the MoE expert sites) equals the
    plain version's unclamped form below 1e-12, under every plan, and the
    clamped form at and above it."""
    from repro_torch.kernels.quantize import is_aligned, static_plans
    M, K = 160, 1024
    for offset in (0, 1):
        x = _quantizer_input(gen, M, K, dtype, offset) * 1e-15
        for t in (1e-13, 3.3e-13, 1e-12, 2.5):
            want = ref.ref_quantize_static(x, t, clamp=False)
            for p in [None] + static_plans(M, K, dtype, is_aligned(x)):
                assert torch.equal(quantize_static_cuda(x, t, clamp=False,
                                                        tile=p), want), (t, p)
            if t >= 1e-12:
                assert torch.equal(want, ref.ref_quantize_static(x, t))
        assert not torch.equal(quantize_static_cuda(x, 1e-13, clamp=False),
                               quantize_static_cuda(x, 1e-13))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rowwise_ignores_nan_in_max(gen, dtype):
    """K2's row max drops NaNs (the scale is that of the row's other
    elements, whichever lanes the NaNs fall on, a whole lane's included),
    and a NaN's code is -127, as K1 gives it: the same bits under the plan
    and every plan forced, aligned and offset."""
    from repro_torch.kernels.quantize import is_aligned, rowwise_plans
    M, K = 12, 2048
    for offset in (0, 1):
        x = _quantizer_input(gen, M, K, dtype, offset)
        x[3, :512] = float("nan")               # whole lanes of NaNs
        x[4, ::7] = float("nan")                # NaNs across the lanes
        x[5] = float("nan")                     # a row of NaNs
        nan = torch.isnan(x)
        rq, rs = ref.ref_quantize_rowwise(torch.where(nan, 0.0, x))
        rq = torch.where(nan, -127, rq).to(torch.int8)
        for p in [None] + rowwise_plans(M, K, dtype, is_aligned(x)):
            q, s = quantize_rowwise_cuda(x, tile=p)
            assert torch.equal(q, rq) and torch.equal(s, rs), p


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (16, 130, 130),
                                   (77, 512, 200)])
def test_int8_matmul_exact(gen, M, K, N):
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    acc = int8_matmul_cuda(a, 1.0, b, torch.ones((1, N), device="cuda"))
    assert torch.equal(acc.double(),
                       torch.matmul(a.double(), b.double()).float().double())
    a_s = torch.rand((M, 1), generator=gen, device="cuda") * 0.05
    b_s = torch.rand((1, N), generator=gen, device="cuda") * 0.05
    bias = torch.randn((N,), generator=gen, device="cuda")
    for zp in (None, 3.0):
        got = int8_matmul_cuda(a, a_s, b, b_s, zp, bias)
        want = ref.ref_int8_matmul(a, a_s, b, b_s, zp, bias)
        assert torch.equal(got, want)


# rows that reach both tile configurations, ragged M tiles and K splits
TILE_M = (1, 5, 16, 17, 64, 65, 300)


def _int8_operands(gen, E, M, K, N):
    a = torch.randint(-127, 128, (E, M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    a_s = torch.rand((E, M, 1), generator=gen, device="cuda") * 0.05
    b_s = torch.rand((E, 1, N), generator=gen, device="cuda") * 0.05
    return a, b, a_s, b_s


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [48, 130, 512])
@pytest.mark.parametrize("K", [64, 130, 1024, 2048])
def test_int8_matmul_tile_equals_plain(gen, K, N, out_dtype):
    """K3 bit for bit against ``ref_int8_matmul`` at every M of ``TILE_M``
    (the small and the large tile, split and unsplit K, 16-byte and 1-byte
    loads), with the zero point and the bias on and off."""
    for M in TILE_M:
        a, b, a_s, b_s = (t[0] for t in _int8_operands(gen, 1, M, K, N))
        bias = torch.randn((N,), generator=gen, device="cuda")
        for zp, bi in ((None, None), (3.0, bias), (None, bias), (-2.5, None)):
            got = int8_matmul_cuda(a, a_s, b, b_s, zp, bi,
                                   out_dtype=out_dtype)
            want = ref.ref_int8_matmul(a, a_s, b, b_s, zp, bi,
                                       out_dtype=out_dtype)
            assert torch.equal(got, want), (M, K, N, zp, bi is not None,
                                            plan(1, M, N, K))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [48, 130, 512])
@pytest.mark.parametrize("K", [64, 130, 1024, 2048])
def test_int8_matmul_batched_tile_equals_plain(gen, K, N, out_dtype):
    """K7 bit for bit at the same shapes, three experts, per-row and
    scalar activation scales."""
    for M in TILE_M:
        a, b, a_s, b_s = _int8_operands(gen, 3, M, K, N)
        for scale in (a_s, 0.0123):
            got = int8_matmul_batched_cuda(a, scale, b, b_s,
                                           out_dtype=out_dtype)
            want = ref.ref_int8_matmul_batched(a, scale, b, b_s,
                                               out_dtype=out_dtype)
            assert torch.equal(got, want), (M, K, N, plan(3, M, N, K))


def _forced_tiles(M, K):
    bm = min(64, 16 * -(-M // 16))
    tiles = [Plan("small", bm, 64, 128, 1, K),
             Plan("large", 128, 128, 64, 1, K)]
    for per in (2, 3):
        if K // (per * 128) >= 2:
            tiles.append(Plan("small", bm, 64, 128, K // (per * 128),
                              per * 128))
    return tiles


@pytest.mark.parametrize("M,K,N", [(1, 1024, 512), (17, 130, 130),
                                   (65, 2048, 512), (300, 1024, 130)])
def test_int8_matmul_every_configuration_equals_plain(gen, M, K, N):
    """Every configuration and split, forced at shapes ``plan`` gives to
    another, is the same product bit for bit (K3 and K7)."""
    a, b, a_s, b_s = _int8_operands(gen, 2, M, K, N)
    bias = torch.randn((N,), generator=gen, device="cuda")
    want3 = ref.ref_int8_matmul(a[0], a_s[0], b[0], b_s[0], 1.5, bias,
                                out_dtype=torch.bfloat16)
    want7 = ref.ref_int8_matmul_batched(a, a_s, b, b_s)
    for tile in _forced_tiles(M, K):
        got = int8_matmul_cuda(a[0], a_s[0], b[0], b_s[0], 1.5, bias,
                               out_dtype=torch.bfloat16, tile=tile)
        assert torch.equal(got, want3), tile
        assert torch.equal(int8_matmul_batched_cuda(a, a_s, b, b_s,
                                                    tile=tile), want7), tile


def test_int8_matmul_launches_counted_once(gen):
    """One launch per wrapper call, split (two kernels) or not."""
    for E, M, K, N in ((1, 16, 2048, 512), (1, 300, 512, 512),
                       (2, 5, 2048, 512), (2, 230, 1024, 512)):
        a, b, a_s, b_s = _int8_operands(gen, E, M, K, N)
        ops.reset_launch_counts()
        if E == 1:
            int8_matmul_cuda(a[0], a_s[0], b[0], b_s[0])
            key = "int8_matmul"
        else:
            int8_matmul_batched_cuda(a, a_s, b, b_s)
            key = "int8_matmul_batched"
        counts = ops.launch_counts()
        assert counts[key] == 1 and sum(counts.values()) == 1, counts
    assert plan(1, 16, 512, 2048).splits > 1
    assert plan(2, 5, 512, 2048).splits > 1


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [(32, 5, 1024, 512), (32, 20, 512, 1024),
                                     (4, 37, 200, 72), (1, 1, 64, 48),
                                     (3, 33, 130, 130)])
def test_int8_matmul_batched_equals_plain(gen, out_dtype, E, M, K, N):
    """K7 against ``ref_int8_matmul_batched`` bit for bit: granite-moe's
    decode shapes, ragged M, K and N, one expert, per-row and scalar
    activation scales."""
    a = torch.randint(-127, 128, (E, M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    a_s = torch.rand((E, M, 1), generator=gen, device="cuda") * 0.05
    b_s = torch.rand((E, 1, N), generator=gen, device="cuda") * 0.05
    for scale in (a_s, 0.0123, torch.full((1, 1, 1), 0.02, device="cuda")):
        got = int8_matmul_batched_cuda(a, scale, b, b_s, out_dtype=out_dtype)
        want = ref.ref_int8_matmul_batched(a, scale, b, b_s,
                                           out_dtype=out_dtype)
        assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,G", [(16, 512, 512, 128), (64, 512, 2048, 128),
                                     (16, 2048, 512, 128), (64, 512, 512, 32),
                                     (5, 200, 72, 32), (3, 128, 130, 128),
                                     (7, 90, 40, 6)])
def test_int4_matmul_equals_plain(gen, out_dtype, M, K, N, G):
    """K6 against ``ref_int4_matmul`` bit for bit, f32 and bf16 (the f32
    values are equal and both sides round to nearest even): the slice's
    shapes at G = 128, G = 32, a padded K (200 in 7 groups of 32; 90 in 15
    groups of 6, each padded to 32 rows in the kernel), one group (K = G =
    128), f16 and f32 scales, per-row and scalar activation scales, bias
    and a zero point."""
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    a_s = torch.rand((M, 1), generator=gen, device="cuda") * 0.02
    bias = torch.randn((N,), generator=gen, device="cuda")
    for scale_dtype in (torch.float16, torch.float32):
        bq = quantize_block(w, G, scale_dtype=scale_dtype)
        for scale, zp, b in ((a_s, None, bias), (0.01, 3.0, None),
                             (a_s, -2.0, bias)):
            got = int4_matmul_cuda(a, scale, bq.data, bq.scale, bq.vmin, zp,
                                   b, group_size=G, out_dtype=out_dtype)
            want = ref.ref_int4_matmul(a, scale, bq.data, bq.scale, bq.vmin,
                                       zp, b, group_size=G,
                                       out_dtype=out_dtype)
            assert torch.equal(got, want), (scale_dtype, zp)


def _int4_operands(gen, M, K, N, G, scale_dtype):
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
    bq = quantize_block(w, G, scale_dtype=scale_dtype)
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    a_s = torch.rand((M, 1), generator=gen, device="cuda") * 0.02
    return a, a_s, bq


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [6, 32, 128])
@pytest.mark.parametrize("N", [40, 130, 512])
@pytest.mark.parametrize("K", [90, 512, 2048])
def test_int4_matmul_tile_equals_plain(gen, K, N, G, out_dtype):
    """K6 bit for bit against ``ref_int4_matmul`` at every M of ``TILE_M``
    (each row count of the tile, ragged M tiles, split and unsplit K,
    16-byte and 1-byte loads), f16 and f32 scales, with the zero point and
    the bias on and off."""
    from repro_torch.kernels.int4_matmul import plan as plan4
    for M in TILE_M:
        for scale_dtype in (torch.float16, torch.float32):
            a, a_s, bq = _int4_operands(gen, M, K, N, G, scale_dtype)
            bias = torch.randn((N,), generator=gen, device="cuda")
            for zp, bi in ((None, None), (3.0, bias)):
                got = int4_matmul_cuda(a, a_s, bq.data, bq.scale, bq.vmin,
                                       zp, bi, group_size=G,
                                       out_dtype=out_dtype)
                want = ref.ref_int4_matmul(a, a_s, bq.data, bq.scale,
                                           bq.vmin, zp, bi, group_size=G,
                                           out_dtype=out_dtype)
                assert torch.equal(got, want), (M, scale_dtype, zp,
                                                plan4(M, N, K, G))


@pytest.mark.parametrize("M,K,N,G", [(1, 2048, 512, 128), (17, 512, 130, 32),
                                     (65, 2048, 512, 128), (300, 512, 72, 6),
                                     (16, 4096, 512, 128)])
def test_int4_matmul_every_split_equals_plain(gen, M, K, N, G):
    """Every tile (16, 32 or 64 rows) and every group-ordered split
    (slices of 1, 2, 3 groups and unsplit), forced at shapes ``plan``
    gives to another, is the same product bit for bit, f32 and bf16."""
    from repro_torch.kernels.int4_matmul import Plan as Plan4
    a, a_s, bq = _int4_operands(gen, M, K, N, G, torch.float16)
    bias = torch.randn((N,), generator=gen, device="cuda")
    n_g = bq.scale.shape[0]
    for dt in (torch.float32, torch.bfloat16):
        want = ref.ref_int4_matmul(a, a_s, bq.data, bq.scale, bq.vmin, 1.5,
                                   bias, group_size=G, out_dtype=dt)
        for bm in (16, 32, 64):
            for per in (n_g, 1, 2, 3):
                tile = Plan4(bm, -(-n_g // per), per)
                got = int4_matmul_cuda(a, a_s, bq.data, bq.scale, bq.vmin,
                                       1.5, bias, group_size=G, out_dtype=dt,
                                       tile=tile)
                assert torch.equal(got, want), (dt, tile)


def test_int4_matmul_launches_counted_once(gen):
    """One launch per wrapper call, split (two kernels) or not."""
    from repro_torch.kernels.int4_matmul import plan as plan4
    for M, K, N in ((16, 2048, 512), (16, 512, 512), (300, 512, 512)):
        a, a_s, bq = _int4_operands(gen, M, K, N, 128, torch.float16)
        ops.reset_launch_counts()
        int4_matmul_cuda(a, a_s, bq.data, bq.scale, bq.vmin,
                         group_size=128)
        counts = ops.launch_counts()
        assert counts["int4_matmul"] == 1 and sum(counts.values()) == 1
    assert plan4(16, 512, 2048, 128).splits > 1


@pytest.mark.parametrize("H,HKV", [(8, 8), (8, 2)])
def test_decode_attention_close(gen, H, HKV):
    B, S, dh = 5, 70, 64
    kq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((B, S, HKV), generator=gen, device="cuda") * 0.02
    vs = torch.rand((B, S, HKV), generator=gen, device="cuda") * 0.02
    lengths = torch.tensor([1, 64, 65, 70, 33], dtype=torch.int32,
                           device="cuda")
    q = torch.randn((B, H, dh), generator=gen, device="cuda")
    got = decode_attention_cuda(q, kq, ks, vq, vs, lengths, sm_scale=0.125)
    want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, 0.125)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _paged_inputs(gen, B, H, HKV, ps, maxP, dh=64):
    """A pool of B·maxP pages handed out in a shuffled order, sentinel
    entries past each row's reservation, lengths from 1 to capacity."""
    P = B * maxP
    cpu = torch.Generator().manual_seed(B * 100 + ps)
    perm = torch.randperm(P, generator=cpu).int()
    reserve = torch.randint(1, maxP + 1, (B,), generator=cpu)
    tables = torch.full((B, maxP), P, dtype=torch.int32)
    for b in range(B):
        tables[b, :int(reserve[b])] = perm[b * maxP:b * maxP + int(reserve[b])]
    lengths = torch.minimum(
        torch.randint(1, maxP * ps + 1, (B,), generator=cpu), reserve * ps)
    lengths[0] = int(reserve[0]) * ps                # a full reservation
    kq = torch.randint(-127, 128, (P, ps, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (P, ps, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((P, ps, HKV), generator=gen, device="cuda") * 0.02
    vs = torch.rand((P, ps, HKV), generator=gen, device="cuda") * 0.02
    q = torch.randn((B, H, dh), generator=gen, device="cuda")
    return (q, kq, ks, vq, vs, tables.cuda(),
            lengths.to(torch.int32).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,maxP", [(4, 9), (16, 4)])
@pytest.mark.parametrize("H,HKV", [(8, 8), (8, 4)])
def test_decode_attention_paged_close(gen, dtype, ps, maxP, H, HKV):
    """K5 against its plain version: f32 within 1e-5, bf16 within one bf16
    ulp."""
    q, kq, ks, vq, vs, tables, lengths = _paged_inputs(gen, 7, H, HKV, ps,
                                                       maxP)
    q = q.to(dtype)
    got = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables, lengths,
                                      sm_scale=0.125).float()
    want = ref.ref_decode_attention_paged(q, kq, ks, vq, vs, tables, lengths,
                                          0.125).float()
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got, want, atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,maxP", [(4, 9), (16, 4)])
def test_decode_attention_paged_equals_contiguous_kernel(gen, dtype, ps,
                                                         maxP):
    """K5 on the pages equals K4 on the linearized cache bit for bit: the
    same chunks, summed in the same order."""
    q, kq, ks, vq, vs, tables, lengths = _paged_inputs(gen, 9, 8, 4, ps,
                                                       maxP)
    q = q.to(dtype)
    got = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables, lengths,
                                      sm_scale=0.125)
    lin = lambda a: linearize_pages(a, tables).contiguous()
    want = decode_attention_cuda(q, lin(kq), lin(ks), lin(vq), lin(vs),
                                 lengths, sm_scale=0.125)
    assert torch.equal(got, want)


# lengths 1, C - 1, C, C + 1 and the full capacity, for K4 and K5 under every
# plan the planner can return, forced
def _attention_lengths(S):
    return [1, CHUNK - 1, CHUNK, CHUNK + 1, S]


def _k4_inputs(gen, B, S, HKV, G, lengths, dh=64):
    kq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((B, S, HKV), generator=gen, device="cuda") * 0.02
    vs = torch.rand((B, S, HKV), generator=gen, device="cuda") * 0.02
    q = torch.randn((B, HKV * G, dh), generator=gen, device="cuda")
    return (q, kq, ks, vq, vs,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def _paged_pool(gen, lengths, HKV, G, ps, maxP, dh=64):
    """Each row reserves the pages its length reaches, from a shuffled pool
    of B·maxP pages; the rest of its table is the sentinel P."""
    B = len(lengths)
    P = B * maxP
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(ps))
    tables = torch.full((B, maxP), P, dtype=torch.int32)
    for b, n in enumerate(lengths):
        k = -(-n // ps)
        tables[b, :k] = perm[b * maxP:b * maxP + k].int()
    kq = torch.randint(-127, 128, (P, ps, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (P, ps, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((P, ps, HKV), generator=gen, device="cuda") * 0.02
    vs = torch.rand((P, ps, HKV), generator=gen, device="cuda") * 0.02
    q = torch.randn((B, HKV * G, dh), generator=gen, device="cuda")
    return (q, kq, ks, vq, vs, tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def _tol(dtype):
    """f32 within 1e-5; bf16 output within one bf16 ulp (2^-8 relative)."""
    return dict(atol=1e-5, rtol=1e-5 if dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention_every_plan_equals_plain(gen, G, dtype):
    """K4 under every plan (splits 1, 2, 4, 8 up to one a chunk; 2, 4 and 8
    warps): within the tolerance of the plain version, and the same bits
    under every plan."""
    S = 70
    q, kq, ks, vq, vs, lengths = _k4_inputs(gen, 5, S, 2, G,
                                            _attention_lengths(S))
    q = q.to(dtype)
    want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, 0.125)
    first = None
    for p in all_plans(S):
        got = decode_attention_cuda(q, kq, ks, vq, vs, lengths,
                                    sm_scale=0.125, tile=p)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        first = got if first is None else first
        assert torch.equal(got, first), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention_head_dim_80_every_plan(gen, G, dtype):
    """zamba2's head dim 80 (score parts of 20 bytes, 5 value dims a
    lane): K4 and K5 (pages of 16) within the tolerance of the plain
    version under every plan, the same bits under every plan, and K5 equal
    to K4 on the linearized cache."""
    S, ps = 80, 16
    q, kq, ks, vq, vs, lengths = _k4_inputs(gen, 5, S, 2, G,
                                            _attention_lengths(S), dh=80)
    q = q.to(dtype)
    want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, 0.125)
    pq, pkq, pks, pvq, pvs, tables, plens = _paged_pool(
        gen, _attention_lengths(S), 2, G, ps, S // ps, dh=80)
    pq = pq.to(dtype)
    pwant = ref.ref_decode_attention_paged(pq, pkq, pks, pvq, pvs, tables,
                                           plens, 0.125)
    lin = lambda a: linearize_pages(a, tables).contiguous()
    first = pfirst = None
    for p in all_plans(S):
        got = decode_attention_cuda(q, kq, ks, vq, vs, lengths,
                                    sm_scale=0.125, tile=p)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        first = got if first is None else first
        assert torch.equal(got, first), p
        pgot = decode_attention_paged_cuda(pq, pkq, pks, pvq, pvs, tables,
                                           plens, sm_scale=0.125, tile=p)
        torch.testing.assert_close(pgot.float(), pwant.float(),
                                   **_tol(dtype))
        pfirst = pgot if pfirst is None else pfirst
        assert torch.equal(pgot, pfirst), p
        assert torch.equal(pgot, decode_attention_cuda(
            pq, lin(pkq), lin(pks), lin(pvq), lin(pvs), plens,
            sm_scale=0.125, tile=p)), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("ps,maxP", [(4, 18), (16, 5)])
def test_decode_attention_paged_every_plan(gen, ps, maxP, G, dtype):
    """K5 under every plan: within the tolerance of the plain version, and
    equal bit for bit to K4 on the linearized cache under the same plan."""
    S = ps * maxP
    q, kq, ks, vq, vs, tables, lengths = _paged_pool(
        gen, _attention_lengths(S), 2, G, ps, maxP)
    q = q.to(dtype)
    want = ref.ref_decode_attention_paged(q, kq, ks, vq, vs, tables, lengths,
                                          0.125)
    lin = lambda a: linearize_pages(a, tables).contiguous()
    k_l, ks_l, v_l, vs_l = lin(kq), lin(ks), lin(vq), lin(vs)
    first = None
    for p in all_plans(S):
        got = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables, lengths,
                                          sm_scale=0.125, tile=p)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        k4 = decode_attention_cuda(q, k_l, ks_l, v_l, vs_l, lengths,
                                   sm_scale=0.125, tile=p)
        assert torch.equal(got, k4), p
        first = got if first is None else first
        assert torch.equal(got, first), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_row_independent(gen, dtype):
    """A row's output is the same bits alone (B = 1), among 16 or 64 rows
    of other lengths, and under any forced split: the plan changes with B,
    the bits do not."""
    S = 80
    lengths = torch.randint(1, S + 1, (64,), generator=gen,
                            device="cuda").tolist()
    q, kq, ks, vq, vs, lens = _k4_inputs(gen, 64, S, 8, 2, lengths)
    q = q.to(dtype)
    k4 = lambda sl, tile=None: decode_attention_cuda(
        q[sl], kq[sl], ks[sl], vq[sl], vs[sl], lens[sl], sm_scale=0.125,
        tile=tile)
    full = k4(slice(0, 64))
    assert torch.equal(k4(slice(0, 16)), full[:16])
    for r in (0, 5, 17, 63):
        assert torch.equal(k4(slice(r, r + 1))[0], full[r]), r
    for tile in (AttentionPlan(2, 4), AttentionPlan(4, 2),
                 AttentionPlan(4, 8)):
        assert torch.equal(k4(slice(0, 64), tile), full), tile


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_long_cache(gen, paged):
    """16 rows over 4096 positions (K5: 256 pages of 16), 16 heads over 8,
    lengths drawn in [1, 4096]: the plan splits the sequence; the split is
    within the tolerance of the plain version and equal to no split."""
    S, ps = 4096, 16
    lengths = torch.randint(1, S + 1, (16,), generator=gen,
                            device="cuda").tolist()
    p = attention_plan(16, S, 8, 2, 64)
    assert p.split > 1
    for dtype in (torch.float32, torch.bfloat16):
        if paged:
            q, kq, ks, vq, vs, tables, lens = _paged_pool(
                gen, lengths, 8, 2, ps, S // ps)
            q = q.to(dtype)
            run = lambda tile: decode_attention_paged_cuda(
                q, kq, ks, vq, vs, tables, lens, sm_scale=0.125, tile=tile)
            want = ref.ref_decode_attention_paged(q, kq, ks, vq, vs, tables,
                                                  lens, 0.125)
        else:
            q, kq, ks, vq, vs, lens = _k4_inputs(gen, 16, S, 8, 2, lengths)
            q = q.to(dtype)
            run = lambda tile: decode_attention_cuda(
                q, kq, ks, vq, vs, lens, sm_scale=0.125, tile=tile)
            want = ref.ref_decode_attention(q, kq, ks, vq, vs, lens, 0.125)
        got = run(None)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        assert torch.equal(got, run(AttentionPlan(1, p.warps)))


def test_decode_attention_shared_memory_as_planned(gen):
    """The library's chunk is CHUNK and its shared memory per block is what
    ``smem_bytes`` (which the plan consults) says, K4 and K5."""
    lib = build.lib()
    assert lib.repro_decode_attention_chunk() == CHUNK
    for G, dh, S, maxP in ((1, 64, 64, 0), (2, 64, 80, 0), (2, 64, 64, 4),
                           (12, 128, 300, 0), (3, 16, 4096, 256),
                           (1, 80, 80, 5), (4, 80, 300, 0)):
        for p in all_plans(S):
            assert lib.repro_decode_attention_smem_bytes(
                G, dh, S, maxP, p.split, p.warps) == smem_bytes(
                    p, G, dh, S, maxP), (G, dh, S, maxP, p)


def test_decode_attention_refuses_what_it_cannot_run(gen):
    """No fallback: a head dim the kernels are not built for, a plan out of
    range or a misaligned cache raises, and nothing is launched."""
    q, kq, ks, vq, vs, lengths = _k4_inputs(gen, 2, 32, 2, 1, [3, 32])
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_cuda(q[..., :48].contiguous(),
                              kq[..., :48].contiguous(), ks,
                              vq[..., :48].contiguous(), vs, lengths,
                              sm_scale=0.125)
    with pytest.raises(ValueError, match="plan"):
        decode_attention_cuda(q, kq, ks, vq, vs, lengths, sm_scale=0.125,
                              tile=AttentionPlan(9, 4))
    with pytest.raises(ValueError, match="plan"):
        decode_attention_cuda(q, kq, ks, vq, vs, lengths, sm_scale=0.125,
                              tile=AttentionPlan(1, 3))
    with pytest.raises(ValueError, match="plan"):
        decode_attention_cuda(q, kq, ks, vq, vs, lengths, sm_scale=0.125,
                              tile=AttentionPlan(3, 4))
    flat = torch.zeros(kq.numel() + 1, dtype=torch.int8, device="cuda")
    shifted = flat[1:].view(kq.shape)
    with pytest.raises(ValueError, match="aligned"):
        decode_attention_cuda(q, shifted, ks, vq, vs, lengths,
                              sm_scale=0.125)
    assert sum(ops.launch_counts().values()) == 0


def test_engine_runs_through_every_kernel(gen):
    cfg = get_config("transformer-base").reduced(vocab=512, d_model=128,
                                                  head_dim=32,
                                                  dtype="bfloat16")
    model = EncDecLM(cfg)
    params = model.init(gen)
    corpus = make_corpus(4, cfg.vocab, seed=1)
    src, lens = pad_batch([s.src for s in corpus])
    batch = {"src_tokens": src, "src_lengths": lens}
    ops.reset_launch_counts()
    qp, ctx = quantize_model(params, {}, QuantPolicy(act_quant="dynamic"))
    ServingEngine(model, qp, quant=ctx, max_len=32).generate_beam(
        batch, beam=2, max_new_tokens=4)
    cal = Calibrator()
    taps = Taps()
    model.forward(params, {"src_tokens": torch.as_tensor(src, device="cuda"),
                           "tgt_tokens": torch.as_tensor(src, device="cuda")},
                  taps=taps)
    cal.observe_taps(taps)
    qp, ctx = quantize_model(params, cal.compute("symmetric"),
                             QuantPolicy(act_quant="static"))
    ServingEngine(model, qp, quant=ctx, max_len=32).generate(
        batch, max_new_tokens=4)
    ServingEngine(model, qp, quant=ctx, max_len=32, paged=True,
                  page_size=8).serve(corpus, n_slots=2, max_new_tokens=4)
    qp, ctx = quantize_model(params, {}, QuantPolicy(act_quant="dynamic"),
                             weight_bits=4)
    ServingEngine(model, qp, quant=ctx, max_len=32).generate(
        batch, max_new_tokens=4)
    # a row-parallel linear (a group of one rank) runs K3's two halves
    from repro_torch.distributed.collectives import Parallel, TPGroup
    from repro_torch.models.layers import dense
    qp, ctx = quantize_model(params, {}, QuantPolicy(act_quant="dynamic"))
    out = qp["dec_blocks.0"]["ffn"]["out"]
    x = torch.randn((4, cfg.d_ff), generator=gen, device="cuda").to(
        torch.bfloat16)
    site = "dec_blocks.0/ffn/out"
    assert torch.equal(
        dense(dict(out, tp=Parallel("row", TPGroup(0, 1))), x, site=site,
              quant=ctx),
        dense(out, x, site=site, quant=ctx))
    # the decoder-only MoE model runs K7
    cfg = get_config("granite-moe-1b-a400m").reduced(vocab=512,
                                                      dtype="bfloat16")
    moe_model = DecoderLM(cfg)
    qp, ctx = quantize_model(moe_model.init(gen), {},
                             QuantPolicy(act_quant="dynamic"))
    ServingEngine(moe_model, qp, quant=ctx, max_len=48).generate(
        {"tokens": src, "lengths": lens}, max_new_tokens=4)
    assert all(n > 0 for n in ops.launch_counts().values()), \
        ops.launch_counts()


def _shared_table_cache(gen, B=8, group=4, maxP=5, ps=4, HKV=4, dh=64):
    """A one-layer paged INT8 cache after two beam reorders within groups
    of ``group`` rows (``kv_cache.gather_beams_paged``): siblings map the
    same full pages, each row's write-slot page is its own."""
    P = B * maxP
    cpu = torch.Generator().manual_seed(B + maxP)
    own = torch.randperm(P, generator=cpu).int().reshape(B, maxP).cuda()
    rand8 = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                     device="cuda", dtype=torch.int8)
    randf = lambda *s: torch.rand(s, generator=gen, device="cuda") * 0.02
    cache = kvc.PagedKVCache(
        k_store=rand8(1, P + 1, ps, HKV, dh),
        v_store=rand8(1, P + 1, ps, HKV, dh),
        ks_store=randf(1, P + 1, ps, HKV), vs_store=randf(1, P + 1, ps, HKV),
        block_tables=own.clone(), own_pages=own,
        lengths=torch.randint(1, maxP * ps - 1, (B,),
                              generator=cpu).int().cuda())
    for _ in range(2):
        pick = torch.randint(0, group, (B,), generator=cpu)
        idx = (torch.arange(B) // group * group + pick).cuda()
        cache = kvc.gather_beams_paged(cache, idx)
        cache = kvc.with_lengths(cache, cache.lengths + 1)
    return cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged_over_shared_tables(gen, dtype):
    """K5 over block tables shared within beam groups equals its plain
    version, and K4 on the linearized cache bit for bit, under every
    plan."""
    cache = _shared_table_cache(gen)
    tables, lengths = cache.block_tables, cache.lengths
    assert len(set(tables.flatten().tolist())) < tables.numel()
    kq, vq, ks, vs = cache.k[0], cache.v[0], cache.k_scale[0], \
        cache.v_scale[0]
    q = torch.randn((tables.shape[0], 8, 64), generator=gen,
                    device="cuda").to(dtype)
    got = decode_attention_paged_cuda(q, kq, ks, vq, vs, tables, lengths,
                                      sm_scale=0.125)
    want = ref.ref_decode_attention_paged(q, kq, ks, vq, vs, tables,
                                          lengths, 0.125)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    lin = lambda a: linearize_pages(a, tables).contiguous()
    for p in all_plans(tables.shape[1] * cache.page_size):
        assert torch.equal(decode_attention_paged_cuda(
            q, kq, ks, vq, vs, tables, lengths, sm_scale=0.125, tile=p), got)
        assert torch.equal(decode_attention_cuda(
            q, lin(kq), lin(ks), lin(vq), lin(vs), lengths, sm_scale=0.125,
            tile=p), got)


def test_cow_write_slot_on_card_equals_cpu(gen):
    """The copy-on-write page copy and the table repoint on the card equal
    the CPU's, with rows whose write slot is a sentinel (the sink)."""
    cache = _shared_table_cache(gen)
    own = cache.own_pages.clone()
    own[1, 2:] = cache.n_pages          # rows reserving part of a row
    own[6, :] = cache.n_pages
    cache = dataclasses.replace(cache, own_pages=own)
    idx = torch.tensor([1, 1, 0, 3, 4, 4, 7, 6], device="cuda")
    to_cpu = lambda c: dataclasses.replace(c, **{
        f.name: None if getattr(c, f.name) is None
        else getattr(c, f.name).cpu().clone()
        for f in dataclasses.fields(c)})
    cpu = kvc.gather_beams_paged(to_cpu(cache), idx.cpu())
    card = kvc.gather_beams_paged(cache, idx)
    for name in ("k", "v", "k_scale", "v_scale", "block_tables", "lengths"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), \
            name


def test_paged_beam_serve_equals_contiguous_on_card(gen):
    """A reduced INT8 beam-4 serve with mixed admissions: the paged cache
    (K5 over shared tables) gives the contiguous cache's (K4) tokens, and
    each launches its own kernel."""
    cfg = get_config("transformer-base").reduced(vocab=512, d_model=128,
                                                  head_dim=32,
                                                  dtype="bfloat16")
    model = EncDecLM(cfg)
    qp, ctx = quantize_model(model.init(gen), {},
                             QuantPolicy(act_quant="dynamic"))
    corpus = make_corpus(10, cfg.vocab, seed=2)
    budgets = [int(b) for b in np.random.default_rng(2).integers(2, 15, 10)]
    toks = {}
    for paged in (False, True):
        ops.reset_launch_counts()
        res = ServingEngine(model, qp, quant=ctx, max_len=32, paged=paged,
                            page_size=8, burst_len=4).serve(
            corpus, n_slots=8, max_new_tokens=budgets, beam=4)
        counts = ops.launch_counts()
        own, other = (("decode_attention_paged", "decode_attention")
                      if paged else
                      ("decode_attention", "decode_attention_paged"))
        assert counts[own] > 0 and counts[other] == 0, counts
        assert res.pages_in_use == 0
        toks[paged] = [list(r.tokens) for r in res.requests]
    assert toks[True] == toks[False]


def test_train_step_on_card_equals_cpu(gen):
    """One step of a reduced enc-dec model (float32) on the card against
    the same step on the CPU, from the same weights and batch: the loss
    and gradient norm to 1e-4 relative, and the new parameters to
    ``2.5·lr`` everywhere (Adam's first step is about ``lr·g/|g|``, and a
    gradient near its rounding noise, such as a key-projection bias's, may
    turn its sign) and ``1e-3·lr`` on average."""
    from repro_torch.data import TranslationBatches
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = get_config("transformer-base").reduced()
    models = {d: EncDecLM(cfg, device=d) for d in ("cuda", "cpu")}
    params = models["cuda"].init(gen)
    batch = TranslationBatches(make_corpus(64, cfg.vocab, seed=0),
                               16).next_batch()
    out = {}
    for d, model in models.items():
        opt = AdamW(lr=warmup_cosine(2e-3, 2, 20))
        p = tree_map(lambda t: t.to(d), params)
        out[d] = make_train_step(model, opt)(p, opt.init(p), batch)
    (gp, gs), gm = out["cuda"]
    (cp, cs), cm = out["cpu"]
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[k]), float(cm[k]), rtol=1e-4,
                                   err_msg=k)
    lr = float(cm["lr"])
    errs = []
    for (k, a), (_, b) in zip(leaves_with_paths(gp), leaves_with_paths(cp)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        err = (a.cpu() - b).abs()
        assert float(err.max()) <= 2.5 * lr, k
        errs.append(err.reshape(-1))
    assert float(torch.cat(errs).mean()) <= 1e-3 * lr
    assert int(gs.step) == int(cs.step) == 1


@pytest.mark.parametrize("M,K,N", [(16, 1024, 512), (16, 2048, 512),
                                   (736, 256, 512), (5, 100, 72)])
def test_k3_halves_equal_fused_k3(gen, M, K, N):
    """K3's two halves for a product split across ranks: the accumulator
    alone and the epilogue alone equal fused K3 and their plain versions
    bit for bit (f32 and bf16, with and without a zero point, per-row,
    per-tensor and by-value scales)."""
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    a_scale = torch.rand((M, 1), generator=gen, device="cuda") * 0.02
    b_scale = torch.rand((1, N), generator=gen, device="cuda") * 0.02
    bias = torch.randn((N,), generator=gen, device="cuda")
    acc = int8_matmul_accumulate_cuda(a, w)
    assert torch.equal(acc, ref.ref_int8_matmul_accumulate(a, w))
    colsum = w.to(torch.int32).sum(dim=0).to(torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        for scale in (a_scale, a_scale[:1], float(a_scale[0, 0])):
            for zp in (None, -37.5):
                cs = None if zp is None else colsum
                fused = int8_matmul_cuda(a, scale, w, b_scale, zp, bias,
                                         out_dtype=dt)
                assert torch.equal(fused, int8_matmul_epilogue_cuda(
                    acc, scale, b_scale, zp, cs, bias, out_dtype=dt))
                assert torch.equal(fused, ref.ref_int8_matmul_epilogue(
                    acc, scale, b_scale, zp, cs, bias, out_dtype=dt))
