"""K1 and K2's launch plan (``repro_torch/kernels/quantize.py:plan``) and
the MoE expert sites' route through them, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); here, in
Python, are the choices made from the shapes alone: the path (16-byte or
scalar), K1's grid, K2's vectors a lane and warps a row, and the
invariants of every plan (a warp never holds more than 4 KB of a row,
every vector of a row belongs to exactly one lane, a block stays within 256
threads).  The arithmetic the kernels share with the plain versions is
checked too: K1's multiplier from the host, the clip of a code in the
kernels' order against the former order, and K2's codes and scale against
the plain version, for every bf16 value.

Then ``models/moe.py:_expert_dense``, whose activations now go through
``ops.quantize_static`` / ``ops.quantize_rowwise`` (K1/K2 on the card, the
plain versions here), against ``jax.jit`` of the reference's
``_expert_dense`` and against the plain form it had before: the int8
codes, the activation scales and the K7 outputs bit for bit, on the
reduced ``granite-moe-1b-a400m`` (as ``tests/test_torch_moe.py`` builds
it), (E, M, K) inputs in f32 and bf16 with one expert's buffer all zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import Calibrator as JCalibrator
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import Taps as JTaps
from repro.core import quantize_model as jquantize_model
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe

from repro_torch.checkpoint.bridge import (
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.core import QuantPolicy, quantize_model
from repro_torch.core.qtensor import INV_127, QTensor, div_exact, rdiv_exact
from repro_torch.data import make_corpus, pad_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.int8_matmul import SMS
from repro_torch.kernels.quantize import (
    MAX_THREADS,
    STATIC_WAVE,
    WARP_ROW_BYTES,
    RowwisePlan,
    StaticPlan,
    plan,
    rowwise_plans,
    static_inv,
    static_plans,
)
from repro_torch.models import moe

BF16, F32 = torch.bfloat16, torch.float32

# (M, K) -> (K1 blocks, K2 (vecs, warps a row)), bf16,
# aligned: chip_smoke.py's phase-3 shapes (transformer-base: 16 requests,
# sources padded to 46, beam 4; granite-moe-1b-a400m: d_model 1024, d_ff
# 512, its 32 experts' rows at greedy and beam-4 decode and prefill)
MAIN_PATH = {
    (16, 512): (4, (1, 2)),
    (16, 2048): (16, (1, 8)),
    (64, 512): (16, (1, 2)),
    (64, 2048): (64, (1, 8)),
    (736, 512): (184, (1, 2)),
    (736, 2048): (736, (1, 8)),
    (16, 1024): (8, (1, 4)),
    (64, 1024): (32, (1, 4)),
    (736, 1024): (368, (1, 4)),
    (2944, 1024): (1056, (2, 2)),
    (160, 1024): (80, (1, 4)),
    (640, 1024): (320, (1, 4)),
    (7360, 1024): (1056, (2, 2)),
    (30720, 1024): (1056, (2, 2)),
    (160, 512): (40, (1, 2)),
    (640, 512): (160, (1, 2)),
}

SHAPES = [(M, K) for M in (1, 3, 12, 16, 160, 2944, 30720)
          for K in (8, 64, 130, 200, 512, 1024, 2048, 4096, 8192, 16384,
                    20000)]


def _elem(dtype):
    return 4 if dtype == F32 else 2


@pytest.mark.parametrize("shape", sorted(MAIN_PATH))
def test_plan_at_main_path_shapes(shape):
    M, K = shape
    blocks, (vecs, wpr) = MAIN_PATH[shape]
    p = plan(M, K, BF16, True)
    assert p.static == StaticPlan(True, blocks)
    assert p.rowwise == RowwisePlan(vecs, wpr)


def _lanes_cover_row(p: RowwisePlan, K: int, dtype) -> None:
    """Lane g of the row's 32·wpr takes vectors g, g + 32·wpr, ..., while
    below the row's count (csrc: quantize_rowwise_kernel): every vector of
    the row exactly once."""
    lanes = 32 * p.warps_per_row
    per_vec = 16 // _elem(dtype)
    nvec = K // per_vec
    taken = [g + v * lanes for g in range(lanes) for v in range(p.vecs)
             if g + v * lanes < nvec]
    assert sorted(taken) == list(range(nvec))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rowwise_plans_hold_at_most_4kb_a_warp(dtype):
    """Under the plan and every plan a shape admits: a warp holds at most
    4 KB of its row, the lanes cover the row, a block has at most 256
    threads, and a row too wide for eight warps takes the scalar path."""
    for M, K in SHAPES:
        for aligned in (True, False):
            chosen = plan(M, K, dtype, aligned).rowwise
            for p in [chosen] + rowwise_plans(M, K, dtype, aligned):
                assert p.threads <= MAX_THREADS
                assert p.warps_per_row in (1, 2, 4, 8)
                if p.vecs:
                    assert 32 * p.vecs * 16 <= WARP_ROW_BYTES == 4096
                    assert (K * _elem(dtype)) % 16 == 0 and aligned
                    _lanes_cover_row(p, K, dtype)
            if K * _elem(dtype) > 8 * WARP_ROW_BYTES:
                assert chosen.vecs == 0
            if K * _elem(dtype) % 16 == 0 and aligned and \
                    K * _elem(dtype) <= 8 * WARP_ROW_BYTES:
                assert chosen.vecs > 0


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_unaligned_input_takes_the_scalar_paths(dtype):
    for M, K in SHAPES:
        p = plan(M, K, dtype, False)
        assert not p.static.vector and p.rowwise.vecs == 0
        assert all(not s.vector for s in static_plans(M, K, dtype, False))
        assert all(r.vecs == 0 for r in rowwise_plans(M, K, dtype, False))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_static_plans(dtype):
    """K1: the 16-byte path exactly where the base is aligned and the
    elements come in eights; the plan's grid at most one wave (2048 threads
    an SM) and no more blocks than 256-thread blocks need; the forced plans
    within two waves, with one block among them (the grid-stride loop
    alone)."""
    for M, K in SHAPES:
        for aligned in (True, False):
            p = plan(M, K, dtype, aligned).static
            assert p.vector == (aligned and (M * K) % 8 == 0)
            units = M * K // 8 if p.vector else M * K
            assert 1 <= p.blocks <= min(STATIC_WAVE, -(-units // 256))
            assert STATIC_WAVE == SMS * 8
            forced = static_plans(M, K, dtype, aligned)
            assert p in forced and any(f.blocks == 1 for f in forced)
            for f in forced:
                assert f.blocks <= 2 * SMS * (2048 // MAX_THREADS)


def test_static_inv_is_the_ieee_f32_form():
    """K1's multiplier, made once on the host, is ``1 / (max(amax, 1e-12)
    / 127)`` with both divisions IEEE f32, as the plain version computes it
    (and the jitted reference, which folds the calibrated constant); with
    the clamp off, ``1 / (amax / 127)`` (the MoE expert sites' form)."""
    rng = np.random.default_rng(0)
    amaxes = np.concatenate([
        rng.uniform(1e-3, 50.0, 200), 10.0 ** rng.uniform(-15, 8, 200),
        [0.0, 1e-12, 1e-13, 127.0, 2.5, 3.4e38]]).astype(np.float32)
    for a in amaxes:
        t = torch.tensor(float(a), dtype=F32)
        want = rdiv_exact(1.0, div_exact(torch.clamp_min(t, 1e-12), 127.0))
        assert np.float32(static_inv(float(a))) == np.float32(want.item())
        assert static_inv(float(a)) == float(
            np.float32(1) / (max(a, np.float32(1e-12)) / np.float32(127)))
        want = rdiv_exact(1.0, div_exact(t, 127.0))
        assert np.float32(static_inv(float(a), clamp=False)) == np.float32(
            want.item())
        if a >= np.float32(1e-12):
            assert static_inv(float(a), clamp=False) == static_inv(float(a))


ROUND = np.float32(1.5 * 2.0 ** 23)      # csrc: kRound


def _former_code(v):
    """The codes as the kernels computed them before:
    ``fminf(fmaxf(rintf(v), -127), 127)`` (rint half to even)."""
    with np.errstate(invalid="ignore"):
        return np.fmin(np.fmax(np.rint(v), np.float32(-127)),
                       np.float32(127)).astype(np.int64)


def _low_byte(t):
    """The int8 code in the low byte of a float's bits."""
    return (t.astype(np.float32).view(np.uint32) & 0xFF).astype(
        np.uint8).view(np.int8).astype(np.int64)


def _clip_code(v):
    """csrc ``clip_code``: lowbyte(RN(min(max(v, -127), 127) + 1.5·2^23))."""
    with np.errstate(invalid="ignore"):
        return _low_byte(np.fmin(np.fmax(v, np.float32(-127)),
                                 np.float32(127)) + ROUND)


def test_code_rounding_equals_former_code():
    """K1's code, rounded by adding 1.5·2^23 after the clip and read off the
    low byte, equals the former ``fminf(fmaxf(rintf(v), -127), 127)`` for
    every bf16 value, at scales that put each near the clip, and for f32
    edge values (half-integers, the clip's edges, infinities, NaN)."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    edges = np.array([-127.5, -127.49999, -128.0, -128.5, 127.5, 127.49999,
                      126.5, -126.5, 0.5, -0.5, 1.5, 2.5, -2.5, -0.0, np.inf,
                      -np.inf, np.nan, 3.4e38, -3.4e38, 2.0 ** 31,
                      -2.0 ** 31, 2.0 ** 22 + 0.5], dtype=np.float32)
    for mul in (1.0, 0.5, 127.0 / 3.0, 1e-3, 1e6):
        with np.errstate(invalid="ignore", over="ignore"):
            v = np.concatenate([bits * np.float32(mul), edges])
        np.testing.assert_array_equal(_clip_code(v), _former_code(v))


def _k2_codes(x, amax):
    """K2's codes and scale of a row holding ``x`` with abs-max ``amax``,
    in f32 as the card computes them (csrc ``divided_code``): the scale
    s = RN(max(amax, 1e-12) · RN(1/127)), the IEEE quotient RN(x / s),
    clipped and rounded by ``clip_code``."""
    s = np.fmax(amax, np.float32(1e-12)) * (np.float32(1) / np.float32(127))
    with np.errstate(invalid="ignore", over="ignore"):
        return _clip_code(x / s), s


def test_k2_codes_equal_plain_for_every_bf16_value():
    """K2's arithmetic (the IEEE division, then the clip and the low-byte
    rounding) equals ``ref.ref_quantize_rowwise``, codes and scale, for
    every finite bf16 value in a row of abs-max ``amax``, at scales
    log-uniform over the f32 range, at 127 (scale exactly 1: the halves
    round to even), below the 1e-12 clamp and in an all-zero row; and for
    random f32 rows."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    bits = bits[np.isfinite(bits)]
    rng = np.random.default_rng(0)
    amaxes = np.concatenate([
        10.0 ** rng.uniform(-40, 38.5, 300), [127.0, 254.0, 1.0, 3e-13,
                                              1e-12, 3.3895e38, 0.0]])
    rows = []
    for amax in amaxes.astype(np.float32):
        a = np.float32(torch.tensor(float(amax)).to(BF16).float().item())
        rows.append(np.concatenate([[a], bits[np.abs(bits) <= a]]))
    for _ in range(50):
        rows.append((rng.standard_normal(4096)
                     * 10.0 ** rng.uniform(-30, 30)).astype(np.float32))
    halves = np.arange(-253, 254, 2, dtype=np.float32) / 2
    rows.append(np.concatenate([[np.float32(127)], halves]))
    for x in rows:
        x = x.astype(np.float32)
        got, s = _k2_codes(x, np.abs(x).max())
        q, scale = ref.ref_quantize_rowwise(torch.from_numpy(x)[None])
        np.testing.assert_array_equal(got, q[0].numpy().astype(np.int64))
        assert np.float32(scale.item()) == s
    np.testing.assert_array_equal(
        _k2_codes(halves, np.float32(127))[0],
        np.rint(halves).astype(np.int64))


# ---------------------------------------------------------------------------
# the MoE expert sites through K1/K2
# ---------------------------------------------------------------------------

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def moe_sides():
    """The reduced model's weights and the reference's and the port's
    quantized trees and contexts (dynamic, and static after calibration)."""
    jcfg = jget_config(ARCH).reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    toks, lens = pad_batch([s.src for s in make_corpus(16, 128, seed=5)])
    taps = JTaps()
    jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, taps=taps)
    jcal = JCalibrator()
    jcal.observe_taps(taps)
    jcalibs = jcal.compute("symmetric")
    sides = {}
    for act, calibs in (("dynamic", {}), ("static", jcalibs)):
        sides[act] = (jquantize_model(jparams, calibs,
                                      JQuantPolicy(act_quant=act)),
                      quantize_model(fp, calibrations_from_reference(calibs),
                                     QuantPolicy(act_quant=act),
                                     device="cpu"))
    return jcfg, sides


def _reference_expert_dense(jnode, x, site, jctx, monkeypatch):
    """``jax.jit`` of the reference's ``_expert_dense``: (codes, activation
    scale, output)."""
    batched = jops.int8_matmul_batched
    seen = []

    def spy(a, b, **kw):
        seen.append((a.data, jnp.asarray(a.scale, jnp.float32)))
        return batched(a, b, **kw)

    monkeypatch.setattr(jops, "int8_matmul_batched", spy)

    def run(node, xx):
        del seen[:]
        out = jmoe._expert_dense(node, xx, site=site, quant=jctx, taps=None)
        return seen[0][0], seen[0][1], out

    # the weights are arguments, as in the engine's jitted programs
    q, s, out = jax.jit(run)(jnode, x)
    monkeypatch.undo()
    return np.asarray(q), np.asarray(s), np.asarray(out.astype(jnp.float32))


def _port_expert_dense(node, x, site, ctx, monkeypatch):
    """The port's ``_expert_dense``: (codes, activation scale, K7's weight
    scales, output)."""
    batched = ops.int8_matmul_batched
    seen = []

    def spy(a, b, **kw):
        seen.append((a, b))
        return batched(a, b, **kw)

    monkeypatch.setattr(ops, "int8_matmul_batched", spy)
    out = moe._expert_dense(node, x, site=site, quant=ctx, taps=None)
    monkeypatch.undo()
    (a, b), = seen
    return a.data, a.scale, b.scale, out


def _former_codes(x, ctx, site):
    """The expert sites' plain quantization as it was before the route
    through K1/K2: (codes, activation scale)."""
    xf = x.to(torch.float32)
    thr = ctx.activation_thresholds(site)
    if thr is not None and thr.symmetric:
        scale = np.float32(thr.t_max) / np.float32(127.0)
        inv = float(np.float32(1.0) / scale)
        return (torch.clamp(torch.round(xf * inv), -127, 127)
                .to(torch.int8), 1.0)
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12)
    a_scale = amax * INV_127
    return (torch.clamp(torch.round(xf / a_scale), -127, 127)
            .to(torch.int8), a_scale)


@pytest.mark.parametrize("site", ["gate", "down"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_expert_dense_through_quantizers(moe_sides, act, dtype, site,
                                         monkeypatch):
    jcfg, sides = moe_sides
    (jp, jctx), (pp, pctx) = sides[act]
    name = f"blocks.0/moe/experts/{site}"
    jnode = jp["blocks.0"]["moe"]["experts"][site]
    node = pp["blocks.0"]["moe"]["experts"][site]
    E, K, _ = node["w"].data.shape
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((E, 9, K)) * 2).astype(np.float32)
    x[2] = 0.0                           # an expert with no rows routed
    x[0, 3] = 0.0                        # an empty slot
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ops.reset_launch_counts()
    q, a_scale, b_scale, out = _port_expert_dense(node, tx, name, pctx,
                                                  monkeypatch)
    assert all(n == 0 for n in ops.launch_counts().values())
    assert out.dtype == tx.dtype and tuple(q.shape) == (E, 9, K)
    jq, js, jout = _reference_expert_dense(jnode, jx, name, jctx,
                                           monkeypatch)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(out.float().numpy(), jout)
    assert (q[2] == 0).all() and (q[0, 3] == 0).all()
    fq, fs = _former_codes(tx, pctx, name)
    assert torch.equal(q, fq)
    if act == "dynamic":
        assert tuple(a_scale.shape) == (E, 9, 1)
        np.testing.assert_array_equal(a_scale.numpy(), js)
        assert torch.equal(a_scale, fs)
        assert float(a_scale[2, 0, 0]) == float(
            np.float32(1e-12) * (np.float32(1) / np.float32(127)))
    else:
        # the static scale rides in K7's weight scales (XLA's fold)
        t_max = np.float32(pctx.activation_thresholds(name).t_max)
        assert a_scale == 1.0 and float(js) == t_max / np.float32(127)
        w = node["w"]
        np.testing.assert_array_equal(
            b_scale.numpy(),
            (w.scale.reshape(E, 1, -1) * float(t_max / np.float32(127)))
            .numpy())


def test_expert_dense_tiny_threshold_keeps_plain_form(moe_sides,
                                                      monkeypatch):
    """Below K1's clamp (1e-12) the reference divides by the unclamped
    scale: the site hands K1 (``ops.quantize_static``) the threshold with
    the clamp off, and equals the jitted reference."""
    import dataclasses
    jcfg, sides = moe_sides
    (jp, jctx), (pp, pctx) = sides["static"]
    name = "blocks.0/moe/experts/up"
    jnode = jp["blocks.0"]["moe"]["experts"]["up"]
    node = pp["blocks.0"]["moe"]["experts"]["up"]
    rng = np.random.default_rng(4)
    E, K, _ = node["w"].data.shape
    x = (rng.standard_normal((E, 5, K)) * 1e-14).astype(np.float32)
    x[1] = 0.0
    tiny = 1e-13

    jthr = jctx.activation_thresholds(name)
    monkeypatch.setattr(type(jctx), "activation_thresholds",
                        lambda self, site: dataclasses.replace(
                            jthr, t_min=-tiny, t_max=tiny)
                        if site == name else None)
    jq, _, jout = _reference_expert_dense(jnode, jnp.asarray(x), name, jctx,
                                          monkeypatch)
    thr = pctx.activation_thresholds(name)
    monkeypatch.setattr(type(pctx), "activation_thresholds",
                        lambda self, site: dataclasses.replace(
                            thr, t_min=-tiny, t_max=tiny)
                        if site == name else None)
    calls = []
    quantize_static = ops.quantize_static
    monkeypatch.setattr(ops, "quantize_static",
                        lambda *a, **kw: calls.append((a[1], kw))
                        or quantize_static(*a, **kw))
    q, _, _, out = _port_expert_dense(node, torch.from_numpy(x), name, pctx,
                                      monkeypatch)
    assert calls == [(tiny, {"impl": pctx.impl, "clamp": False})]
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(out.numpy(), jout)
    # K1's function (threshold clamped at 1e-12) gives other codes here
    assert not torch.equal(ref.ref_quantize_static(
        torch.from_numpy(x).reshape(-1, K), tiny).reshape(q.shape), q)
