"""The port's decoder-only MoE family against the JAX package, on the CPU.

``granite-moe-1b-a400m`` reduced (2 layers, d_model 64, 4 experts, top-2,
group 32) with random weights initialised by the reference and carried
across with ``repro_torch.checkpoint.bridge``; inputs are numpy arrays made
from a seed.  Where the reference runs inside ``jax.jit`` (its serving
engine does), XLA folds constants and turns a division by a constant into
a multiplication by its reciprocal; the port follows the jitted form at the
MoE expert sites and in the rotary frequencies (see ``models/moe.py`` and
``models/layers.py``), so those are held to ``jax.jit`` of the reference.

Tolerances (float32):
* integer results (int8 codes, s32 accumulators, expert indices, keep
  masks, dispatched expert rows) and the K7 outputs at equal codes: exact;
* norm, rope and MoE outputs: a few float32 ulps, from ``rsqrt``, ``exp``,
  ``cos``/``sin`` and the sum orders of matmuls and of the combine;
* model logits: as ``tests/test_torch_core.py`` argues for the enc-dec
  model — 1e-5 in FP, and with INT8 activations a last-bit difference can
  move one code by one step at a rounding boundary.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.configs import MoEConfig as JMoEConfig
from repro.core import Calibrator as JCalibrator
from repro.core import FP_CONTEXT as JFP_CONTEXT
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import Taps as JTaps
from repro.core import count_quantized as jcount_quantized
from repro.core import quantize_model as jquantize_model
from repro.core.qtensor import QTensor as JQTensor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul_batched_pallas
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe

from repro_torch.checkpoint.bridge import (
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.configs import MoEConfig, get_config
from repro_torch.core import (
    FP_CONTEXT,
    Calibrator,
    QuantPolicy,
    QTensor,
    Taps,
    count_quantized,
    quantize_model,
)
from repro_torch.data import make_corpus, pad_batch
from repro_torch.kernels import ops, ref
from repro_torch.models import DecoderLM, EncDecLM, build_model
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.serving import ServingEngine

from _torch_reference import import_reference_serving

ARCH = "granite-moe-1b-a400m"
MAX_LEN = 48
MAX_NEW = 12
KINDS = ("fp", "int8_dynamic", "int8_static")
DROPS = JMoEConfig(n_experts=4, top_k=2, capacity_factor=0.5, group_size=32)


def _pair(**overrides):
    """(reference cfg, port cfg) of the reduced MoE config."""
    port_over = dict(overrides)
    if isinstance(port_over.get("moe"), JMoEConfig):
        port_over["moe"] = MoEConfig(**dataclasses.asdict(port_over["moe"]))
    return (jget_config(ARCH).reduced(**overrides),
            get_config(ARCH).reduced(**port_over))


def _assert_same_config(port, ref):
    for field in dataclasses.fields(port):
        p, r = getattr(port, field.name), getattr(ref, field.name)
        if dataclasses.is_dataclass(p):
            assert dataclasses.asdict(p) == dataclasses.asdict(r), field.name
        else:
            assert p == r, field.name


def _flat(tree, prefix=()):
    """Port params → {path: numpy} (a QTensor as its three leaves)."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        elif isinstance(v, QTensor):
            for i, leaf in enumerate((v.data, v.scale, v.zero_point)):
                out["/".join(path + (str(i),))] = leaf.numpy()
        else:
            out["/".join(path)] = v.numpy()
    return out


def _prompts(seed, n, vocab=128):
    """Right-padded prompts from the synthetic corpus, with lengths."""
    corpus = make_corpus(n, vocab, seed=seed)
    return pad_batch([s.src for s in corpus])


@pytest.fixture(scope="module")
def moe_model():
    """Reference model and weights, the port's copy, and both packages'
    quantized trees and contexts for each kind."""
    jcfg, cfg = _pair()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    toks, lens = _prompts(seed=5, n=16)
    taps = JTaps()
    jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, taps=taps)
    jcal = JCalibrator()
    jcal.observe_taps(taps)
    jcalibs = jcal.compute("symmetric")
    sides = {"fp": ((jparams, JFP_CONTEXT), (fp, FP_CONTEXT))}
    for act, calibs in (("dynamic", {}), ("static", jcalibs)):
        sides[f"int8_{act}"] = (
            jquantize_model(jparams, calibs, JQuantPolicy(act_quant=act)),
            quantize_model(fp, calibrations_from_reference(calibs),
                           QuantPolicy(act_quant=act), device="cpu"))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams, fp=fp,
                model=DecoderLM(cfg, device="cpu"), sides=sides,
                jcalibs=jcalibs)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [None, {}, {"moe": DROPS}])
def test_config_matches_reference(overrides):
    """Full config (``None``) and reduced configs, field by field, MoE
    sub-config included; ``transformer-base`` gains no MoE config."""
    if overrides is None:
        ref, port = jget_config(ARCH), get_config(ARCH)
    else:
        ref, port = _pair(**overrides)
    _assert_same_config(port, ref)
    assert port.hd == ref.hd
    assert get_config("transformer-base").reduced().moe is None


def test_build_model_routes_families():
    _, cfg = _pair()
    assert isinstance(build_model(cfg, device="cpu"), DecoderLM)
    tb = get_config("transformer-base").reduced()
    assert isinstance(build_model(tb, device="cpu"), EncDecLM)
    with pytest.raises(KeyError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="rwkv"), device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        DecoderLM(tb, device="cpu")


# ---------------------------------------------------------------------------
# rmsnorm and rotary embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    """The mean of squares sums in another order than XLA's and ``rsqrt``
    differs in the last bit: float32 within 4 ulps (measured: 2.7 at
    most, on 0.8% of the values); bfloat16 outputs round the same float32
    values, so they differ by at most one bf16 ulp where a float32 value
    sits at a rounding boundary."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 7, 64)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(x).astype(dtype)),
                      np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x).to(getattr(torch, dtype)))
    rtol = 2 ** -21 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=0)
    assert np.asarray(layers.norm({"scale": torch.ones(64)},
                                  torch.ones(2, 64), "rmsnorm")).shape \
        == (2, 64)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope_matches_jitted_reference(head_dim):
    """Frequencies: bit-equal to the constants XLA folds under ``jit``.
    Rotation: XLA's float32 ``cos``/``sin`` and the port's (float64,
    rounded once) differ by one ulp on about 1% of the angles, so the
    rotated values agree to a few float32 ulps of the largest input."""
    np.testing.assert_array_equal(
        layers.rope_frequencies(head_dim, 10000.0).numpy(),
        np.asarray(jax.jit(lambda: jlayers.rope_frequencies(
            head_dim, 10000.0))()))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 40, 4, head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 40)).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, p: jlayers.apply_rope(
        a, p, 10000.0))(jnp.asarray(x), jnp.asarray(pos)))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * 2 ** -24 * np.abs(x).max())
    # position 0 is the identity
    np.testing.assert_array_equal(
        layers.apply_rope(torch.from_numpy(x[:, :1]),
                          torch.zeros((3, 1), dtype=torch.int32),
                          10000.0).numpy(), x[:, :1])


# ---------------------------------------------------------------------------
# the plain K7 against the reference's oracle and its Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("M", [1, 5, 37])
@pytest.mark.parametrize("E", [1, 4])
def test_plain_k7_equals_reference(E, M, per_row, out_dtype):
    rng = np.random.default_rng(E * 100 + M)
    K, N = 72, 40
    a = rng.integers(-127, 128, (E, M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (E, K, N)).astype(np.int8)
    a_scale = (rng.uniform(1e-3, 3e-2, (E, M, 1)) if per_row
               else np.full((1, 1, 1), 0.0123)).astype(np.float32)
    b_scale = rng.uniform(1e-3, 3e-2, (E, 1, N)).astype(np.float32)
    jdt = jnp.dtype(out_dtype)
    ja_scale = jnp.broadcast_to(jnp.asarray(a_scale), (E, M, 1))
    want = np.asarray(jref.ref_int8_matmul_batched(
        jnp.asarray(a), ja_scale, jnp.asarray(b), jnp.asarray(b_scale),
        out_dtype=jdt), np.float32)
    pallas = np.asarray(int8_matmul_batched_pallas(
        jnp.asarray(a), ja_scale, jnp.asarray(b), jnp.asarray(b_scale),
        out_dtype=jdt, interpret=True), np.float32)
    np.testing.assert_array_equal(pallas, want)
    tdt = getattr(torch, out_dtype)
    got = ref.ref_int8_matmul_batched(
        torch.from_numpy(a), torch.from_numpy(a_scale), torch.from_numpy(b),
        torch.from_numpy(b_scale), out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (E, M, N)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the s32 accumulator itself: scales of one
    acc = ref.ref_int8_matmul_batched(
        torch.from_numpy(a), 1.0, torch.from_numpy(b),
        torch.ones((E, 1, N)))
    np.testing.assert_array_equal(
        acc.numpy(), np.einsum("emk,ekn->emn", a.astype(np.int64),
                               b.astype(np.int64)).astype(np.float32))


def test_ops_k7_routing_on_cpu():
    """``auto`` runs the plain version for CPU tensors and launches
    nothing; ``cuda`` raises; a scalar activation scale equals its
    broadcast."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (4, 5, 64)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (4, 64, 24)).astype(np.int8))
    b_scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, (4, 1, 24))
                               .astype(np.float32))
    wq = QTensor(b, b_scale, 0.0, None)
    ops.reset_launch_counts()
    scalar = ops.int8_matmul_batched(QTensor(a, 0.02, 0.0, None), wq,
                                     impl="auto")
    full = ops.int8_matmul_batched(
        QTensor(a, torch.full((4, 5, 1), 0.02), 0.0, None), wq, impl="torch")
    assert torch.equal(scalar, full)
    want = jops.int8_matmul_batched(
        JQTensor(jnp.asarray(a.numpy()), jnp.float32(0.02), jnp.zeros(()),
                 None),
        JQTensor(jnp.asarray(b.numpy()), jnp.asarray(b_scale.numpy()),
                 jnp.zeros(()), None), impl="xla")
    np.testing.assert_array_equal(scalar.numpy(), np.asarray(want))
    assert all(n == 0 for n in ops.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA"):
        ops.int8_matmul_batched(QTensor(a, 0.02, 0.0, None), wq, impl="cuda")


# ---------------------------------------------------------------------------
# moe_ffn against the jitted reference
# ---------------------------------------------------------------------------

def _reference_keep(idx, n_experts, capacity):
    """The reference's capacity rule (``moe.py:115-118``) over its own
    expert indices: (G, Sg, K) → keep mask."""
    G, Sg, K = idx.shape
    flat = idx.reshape(G, Sg * K)
    pos = np.zeros_like(flat)
    for g in range(G):
        seen = np.zeros(n_experts, np.int64)
        for j, e in enumerate(flat[g]):
            pos[g, j] = seen[e]
            seen[e] += 1
    return (pos < capacity).reshape(G, Sg, K)


def _run_reference_moe(jparams, x, jcfg, jctx, monkeypatch):
    """``jax.jit`` of the reference's ``moe_ffn`` on block 0, returning its
    output, aux, expert indices, recorded expert inputs and, per expert
    matmul, (codes, activation scale, output)."""
    captured = {}
    top_k, batched = jax.lax.top_k, jops.int8_matmul_batched

    def top_k_spy(x, k):
        vals, idx = top_k(x, k)
        captured["idx"] = idx
        return vals, idx

    def batched_spy(a, b, **kw):
        out = batched(a, b, **kw)
        captured.setdefault("k7", []).append(
            (a.data, jnp.asarray(a.scale, jnp.float32), out))
        return out

    monkeypatch.setattr(jax.lax, "top_k", top_k_spy)
    monkeypatch.setattr(jops, "int8_matmul_batched", batched_spy)

    def run(params, xx):
        captured.clear()
        taps = JTaps()
        y, aux = jmoe.moe_ffn(params, xx, cfg=jcfg, site="blocks.0/moe",
                              quant=jctx, taps=taps)
        return y, aux, captured["idx"], dict(taps.values), \
            captured.get("k7", [])

    # the weights are arguments, as in the engine's jitted programs (a
    # closed-over weight scale would be a constant that XLA folds)
    out = jax.jit(run)(jparams["blocks.0"]["moe"], jnp.asarray(x))
    monkeypatch.undo()
    return jax.tree_util.tree_map(np.asarray, out)


def _run_port_moe(pparams, x, cfg, pctx, monkeypatch):
    captured = {}
    route, batched = moe._route, ops.int8_matmul_batched

    def route_spy(*args):
        out = route(*args)
        captured["idx"], captured["keep"] = out[2], out[4]
        return out

    def batched_spy(a, b, **kw):
        out = batched(a, b, **kw)
        scale = torch.as_tensor(a.scale, dtype=torch.float32)
        captured.setdefault("k7", []).append((a.data, scale, out))
        return out

    monkeypatch.setattr(moe, "_route", route_spy)
    monkeypatch.setattr(ops, "int8_matmul_batched", batched_spy)
    taps = Taps()
    y, aux = moe.moe_ffn(pparams["blocks.0"]["moe"], torch.from_numpy(x),
                         cfg=cfg, site="blocks.0/moe", quant=pctx, taps=taps)
    monkeypatch.undo()
    return y.numpy(), {k: float(v) for k, v in aux.items()}, captured, \
        taps.values


@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_moe_ffn_matches_jitted_reference(moe_model, kind, drops,
                                          monkeypatch):
    """39 tokens in groups of 32 (one padded group); with ``drops`` the
    capacity factor 0.5 gives C = 8 of 16 pairs a group, so pairs drop."""
    jcfg, cfg = _pair(moe=DROPS) if drops else (moe_model["jcfg"],
                                                moe_model["cfg"])
    (jp, jctx), (pp, pctx) = moe_model["sides"][kind]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 13, 64)).astype(np.float32)
    x[1, 5] = 0.0                       # a zero row inside the batch: ties
    y_r, aux_r, idx_r, taps_r, k7_r = _run_reference_moe(jp, x, jcfg, jctx,
                                                         monkeypatch)
    y_p, aux_p, cap, taps_p = _run_port_moe(pp, x, cfg, pctx, monkeypatch)
    C = max(int(np.ceil(32 * 2 / 4 * cfg.moe.capacity_factor)), 4)
    keep_r = _reference_keep(idx_r, 4, C)
    np.testing.assert_array_equal(cap["idx"].numpy(), idx_r)
    np.testing.assert_array_equal(cap["keep"].numpy(), keep_r)
    if drops:
        assert (~keep_r[0]).sum() > 0     # drops in the full group too
    # the zero row and the padding rows of the group route to experts 0, 1
    assert (idx_r.reshape(-1, 2)[[18] + list(range(39, 64))] == [0, 1]).all()
    # the recorded expert inputs (E, G·C, D): the dispatched rows, bit for
    # bit, empty slots zero; the router input too
    assert set(taps_p) == set(taps_r)
    for site in taps_r:
        if site.endswith(("/gate", "/up", "/router")):
            np.testing.assert_array_equal(taps_p[site], taps_r[site], site)
    np.testing.assert_allclose(taps_p["blocks.0/moe/experts/down"],
                               taps_r["blocks.0/moe/experts/down"],
                               rtol=0, atol=1e-6)
    assert taps_p["blocks.0/moe/experts/gate"].shape == (4, 2 * C, 64)
    # quantized: the same int8 codes and activation scales at the gate and
    # up sites (bit for bit), so the same K7 outputs; the down site's input
    # differs in the last bits (silu, matmul order): its codes by at most
    # one step
    assert len(cap.get("k7", [])) == len(k7_r) == (0 if kind == "fp" else 3)
    for i, ((qa, sa, oa), (qb, sb, ob)) in enumerate(zip(cap.get("k7", []),
                                                         k7_r)):
        if i < 2:
            np.testing.assert_array_equal(qa.numpy(), qb)
            if kind == "int8_dynamic":
                np.testing.assert_array_equal(sa.numpy(), sb)
            else:       # the static scale rides in K7's weight scales
                assert float(sa) == 1.0
            np.testing.assert_array_equal(oa.numpy(), ob)
        else:
            assert np.abs(qa.numpy().astype(int) - qb.astype(int)).max() <= 1
    # outputs: a few ulps of the output scale (sum orders, silu, exp);
    # INT8 down-site code flips add one code step of the down matmul
    atol = 1e-6 if kind == "fp" else 5e-4
    np.testing.assert_allclose(y_p, y_r, rtol=0, atol=atol)
    assert aux_p["dropped_fraction"] == pytest.approx(
        float(aux_r["dropped_fraction"]), abs=0)
    assert aux_p["load_balance_loss"] == pytest.approx(
        float(aux_r["load_balance_loss"]), rel=1e-6)


# ---------------------------------------------------------------------------
# DecoderLM: forward, prefill and decode against the jitted reference
# ---------------------------------------------------------------------------

# FP: float32 throughout; only the sum orders differ.  INT8: as in
# tests/test_torch_core.py, a last-bit difference can move one activation
# code by one step at a boundary; here the rotary and KV-cache scales also
# differ from the jitted reference in the last bit (ROADMAP Queue 3).
ATOL = {"fp": 2e-5, "int8_dynamic": 2e-2, "int8_static": 2e-2}


# Routing adds one more effect in the full forward over padded prompts: a
# code flip moves the next layer's activations by ~5e-3, and where a
# token's two router probabilities lie that close its top-k choice changes,
# replacing its FFN output and, through the capacity order, which pairs of
# its group drop.  Measured on these prompts (INT8 dynamic): a K2 code flip
# in block 0's o_proj, then block 1 routes the padding position 33 of
# prompt 1 to experts (2, 3) where the reference picks (2, 1) (margin
# 2.7e-4); 0.78% of the logits move by more than ATOL, by at most 0.104.
# So with INT8 activations at most 2% of the logits may exceed ATOL, and
# none may exceed 0.25.
FLIP_SHARE, FLIP_MAX = 0.02, 0.25


@pytest.mark.parametrize("kind", KINDS)
def test_forward_logits_match(moe_model, kind):
    (jp, jctx), (pp, pctx) = moe_model["sides"][kind]
    toks, lens = _prompts(seed=8, n=4)
    jm = moe_model["jmodel"]
    want, jaux = jax.jit(lambda t, l: jm.forward(
        jp, {"tokens": t, "lengths": l}, quant=jctx))(jnp.asarray(toks),
                                                      jnp.asarray(lens))
    got, aux = moe_model["model"].forward(
        pp, {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}, quant=pctx)
    d = np.abs(got.numpy() - np.asarray(want))
    if kind == "fp":
        assert d.max() <= ATOL[kind], d.max()
    else:
        assert (d > ATOL[kind]).mean() <= FLIP_SHARE and d.max() <= FLIP_MAX, \
            ((d > ATOL[kind]).mean(), d.max())
    assert float(aux["load_balance_loss"]) == pytest.approx(
        float(jaux["load_balance_loss"]), rel=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_and_decode_match(moe_model, kind):
    """Prefill logits and cache, then 8 decode steps' logits; the INT8
    cache codes within one step of the reference's."""
    (jp, jctx), (pp, pctx) = moe_model["sides"][kind]
    jm, model = moe_model["jmodel"], moe_model["model"]
    toks, lens = _prompts(seed=9, n=5)
    quantized = kind != "fp"
    js = jm.init_decode_state(5, MAX_LEN, quantized=quantized)
    ps = model.init_decode_state(5, MAX_LEN, quantized=quantized)
    jprefill = jax.jit(lambda b, s: jm.prefill(jp, b, s, quant=jctx))
    jdecode = jax.jit(lambda t, s: jm.decode_step(jp, t, s, quant=jctx))
    jl, js = jprefill({"tokens": jnp.asarray(toks),
                       "lengths": jnp.asarray(lens)}, js)
    pl, ps = model.prefill(pp, {"tokens": torch.from_numpy(toks),
                                "lengths": torch.from_numpy(lens)}, ps,
                           quant=pctx)
    S = toks.shape[1]
    jc, pc = js["cache"], ps["cache"]
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    if quantized:
        d = np.abs(pc.k.numpy()[:, :, :S].astype(np.int32)
                   - np.asarray(jc.k)[:, :, :S].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), d.mean())
        np.testing.assert_allclose(pc.k_scale.numpy()[:, :, :S],
                                   np.asarray(jc.k_scale)[:, :, :S],
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(pc.k.numpy()[:, :, :S],
                                   np.asarray(jc.k)[:, :, :S], atol=1e-5)
    for step in range(9):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=ATOL[kind], rtol=0,
                                   err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        if step == 8:
            break
        jl, js = jdecode(jnp.asarray(tok), js)
        pl, ps = model.decode_step(pp, torch.from_numpy(tok), ps, quant=pctx)
    np.testing.assert_array_equal(ps["cache"].lengths.numpy(),
                                  np.asarray(js["cache"].lengths))


# ---------------------------------------------------------------------------
# PTQ, calibration and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act_quant", ["dynamic", "static"])
def test_quantize_model_moe_codes_and_scales(moe_model, act_quant):
    """Expert weights (E, K, N) → codes and (E, 1, N) scales equal to the
    reference's; the router stays float32; the counts match."""
    calibs = moe_model["jcalibs"] if act_quant == "static" else {}
    jq, _ = jquantize_model(moe_model["jparams"], calibs,
                            JQuantPolicy(act_quant=act_quant))
    pq, _ = quantize_model(moe_model["fp"], calibrations_from_reference(
        calibs), QuantPolicy(act_quant=act_quant), device="cpu")
    want = {k: np.asarray(v) for k, v in _flatten_with_paths(jq).items()}
    got = _flat(pq)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    gate = pq["blocks.1"]["moe"]["experts"]["gate"]["w"]
    assert isinstance(gate, QTensor) and tuple(gate.scale.shape) == (4, 1, 128)
    router = pq["blocks.1"]["moe"]["router"]["w"]
    assert isinstance(router, torch.Tensor) and router.dtype == torch.float32
    assert count_quantized(pq) == jcount_quantized(jq)
    assert count_quantized(pq)["quantized_linears"] == 2 * (4 + 3)


def test_calibration_thresholds_at_expert_sites(moe_model):
    """Taps record the (E, G·C, K) expert inputs, empty slots included.
    From the same input to ``moe_ffn`` the gate/up inputs are bit-equal,
    so their KL thresholds are equal; the down site's input differs in
    the last bits (silu, matmul order), so its thresholds agree to the
    histogram's resolution.  Over the whole model (a forward with taps,
    as the calibration runs) every site matches within that resolution."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    jparams, fp = moe_model["jparams"], moe_model["fp"]
    jtaps, taps = JTaps(), Taps()
    jmoe.moe_ffn(jparams["blocks.0"]["moe"], jnp.asarray(x),
                 cfg=moe_model["jcfg"], site="blocks.0/moe", taps=jtaps)
    moe.moe_ffn(fp["blocks.0"]["moe"], torch.from_numpy(x),
                cfg=moe_model["cfg"], site="blocks.0/moe", taps=taps)
    jcal, cal = JCalibrator(), Calibrator()
    jcal.observe_taps(jtaps)
    cal.observe_taps(taps)
    want, got = jcal.compute("symmetric"), cal.compute("symmetric")
    assert set(got) == set(want) == {
        "blocks.0/moe/router", "blocks.0/moe/experts/gate",
        "blocks.0/moe/experts/up", "blocks.0/moe/experts/down"}
    for site in want:
        w, g = want[site].thresholds, got[site].thresholds
        if site.endswith("/down"):
            assert g.t_max == pytest.approx(w.t_max, rel=1e-3), site
        else:
            assert (g.t_min, g.t_max) == (w.t_min, w.t_max), site

    toks, lens = _prompts(seed=5, n=16)
    taps = Taps()
    moe_model["model"].forward(fp, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)},
                               taps=taps)
    cal = Calibrator()
    cal.observe_taps(taps)
    got, want = cal.compute("symmetric"), moe_model["jcalibs"]
    assert set(got) == set(want)
    groups = -(-toks.size // 32)          # capacity 20 a group
    assert taps.values["blocks.1/moe/experts/up"].shape == (4, groups * 20,
                                                            64)
    for site in want:
        assert got[site].thresholds.t_max == pytest.approx(
            want[site].thresholds.t_max, rel=2e-3), site


@pytest.mark.parametrize("stacked", [False, True])
def test_bridge_moe_trees(stacked):
    """Unstacked: every leaf identical.  Scan-stacked (``blocks`` with a
    leading layer axis), quantized: only the layer axis splits; expert
    weights keep their expert axis and scales."""
    jcfg = jget_config(ARCH).reduced(n_layers=3, scan_layers=stacked)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(4))
    if not stacked:
        flat = _flatten_with_paths(jparams)
        got = _flat(params_from_flat(flat, device="cpu"))
        assert set(got) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v)
        return
    jq, _ = jquantize_model(jparams, {}, JQuantPolicy(act_quant="dynamic"))
    got = params_from_flat(_flatten_with_paths(jq), device="cpu")
    assert sorted(k for k in got if "blocks" in k) == [
        "blocks.0", "blocks.1", "blocks.2"]
    w = jq["blocks"]["moe"]["experts"]["down"]["w"]
    assert tuple(w.data.shape) == (3, 4, 128, 64)
    for i in range(3):
        qt = got[f"blocks.{i}"]["moe"]["experts"]["down"]["w"]
        assert isinstance(qt, QTensor)
        np.testing.assert_array_equal(qt.data.numpy(), np.asarray(w.data[i]))
        np.testing.assert_array_equal(qt.scale.numpy(),
                                      np.asarray(w.scale[i]))
        assert tuple(qt.scale.shape) == (4, 1, 64)
        np.testing.assert_array_equal(
            got[f"blocks.{i}"]["moe"]["router"]["w"].numpy(),
            np.asarray(jq["blocks"]["moe"]["router"]["w"][i]))


# ---------------------------------------------------------------------------
# end to end: the serving engine's generate and generate_beam
# ---------------------------------------------------------------------------

def _first_divergence(want, got):
    for r, (a, b) in enumerate(zip(want, got)):
        if a != b:
            n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return f"row {r} diverges at step {n}: ref {a} port {b}"
    return "equal"


@pytest.mark.parametrize("search", ["greedy", "beam2"])
@pytest.mark.parametrize("kind", KINDS)
def test_generate_matches_reference_engine(moe_model, kind, search):
    """Tokens, steps and host syncs of ``generate`` and ``generate_beam``
    (beam 2) equal the reference engine's (which runs jitted), on 8
    right-padded prompts of 8 to 47 tokens."""
    (jp, jctx), (pp, pctx) = moe_model["sides"][kind]
    toks, lens = _prompts(seed=3, n=8)
    batch = {"tokens": toks, "lengths": lens}
    jengine = import_reference_serving().ServingEngine(
        moe_model["jmodel"], jp, quant=jctx, max_len=MAX_LEN)
    engine = ServingEngine(moe_model["model"], pp, quant=pctx,
                           max_len=MAX_LEN, device="cpu")
    if search == "greedy":
        want = jengine.generate(batch, max_new_tokens=MAX_NEW)
        got = engine.generate(batch, max_new_tokens=MAX_NEW)
    else:
        want = jengine.generate_beam(batch, beam=2, max_new_tokens=MAX_NEW)
        got = engine.generate_beam(batch, beam=2, max_new_tokens=MAX_NEW)
    wt = [list(map(int, t)) for t in want.tokens]
    gt = [list(map(int, t)) for t in got.tokens]
    assert gt == wt, _first_divergence(wt, gt)
    assert (got.steps, got.host_syncs) == (want.steps, want.host_syncs)


def test_serve_refuses_decoder_only(moe_model):
    engine = ServingEngine(moe_model["model"], moe_model["fp"],
                           max_len=MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.serve([np.arange(3, 9, dtype=np.int32)], n_slots=2,
                     max_new_tokens=4)
