"""The port's quantization core, weight bridge, data helpers and model
against the JAX package, on numpy inputs made from a seed.

Model-level tests use the ``trained_nmt`` configuration with random weights
initialised by the reference and carried across with
``repro_torch.checkpoint.bridge``; the trained weights are exercised in
``tests/test_torch_slice.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import Calibrator as JCalibrator
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.core.qtensor import QTensor as JQTensor
from repro.data import corpus_bleu as jcorpus_bleu
from repro.data import make_batches as jmake_batches
from repro.data import make_corpus as jmake_corpus
from repro.data import next_pow2 as jnext_pow2
from repro.data import pad_batch as jpad_batch
from repro.models import build_model

from repro_torch.checkpoint.bridge import (
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.configs import get_config
from repro_torch.core import Calibrator, QuantPolicy, QTensor, quantize_model
from repro_torch.data import corpus_bleu, make_batches, make_corpus, \
    next_pow2, pad_batch
from repro_torch.models import EncDecLM

# the trained_nmt fixture's configuration (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)


def _flat_leaves(tree, prefix=()):
    """Port params → {path: (kind, numpy)} for comparisons."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_flat_leaves(v, path))
        elif isinstance(v, QTensor):
            out["/".join(path + ("0",))] = v.data.numpy()
            out["/".join(path + ("1",))] = v.scale.numpy()
            out["/".join(path + ("2",))] = v.zero_point.numpy()
        else:
            out["/".join(path)] = v.numpy()
    return out


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

def _assert_fields_equal(port, ref):
    """Every field of the port's config equals the reference's; a
    dataclass-valued field (``quant``, a sub-config) by its ``asdict``,
    since two dataclasses of different classes never compare equal."""
    for field in dataclasses.fields(port):
        p, r = getattr(port, field.name), getattr(ref, field.name)
        if dataclasses.is_dataclass(p):
            assert dataclasses.asdict(p) == dataclasses.asdict(r), field.name
        else:
            assert p == r, field.name


def test_transformer_base_config_matches_reference():
    ref, port = jget_config("transformer-base"), get_config("transformer-base")
    _assert_fields_equal(port, ref)
    assert port.hd == ref.hd == 64
    assert port.activation_dtype == torch.bfloat16
    r, p = ref.reduced(**NMT), port.reduced(**NMT)
    _assert_fields_equal(p, r)
    assert p.activation_dtype == torch.float32


def test_corpus_batches_and_bleu_match_reference():
    ref, port = jmake_corpus(50, 37000, seed=11), make_corpus(50, 37000, seed=11)
    for a, b in zip(ref, port):
        assert np.array_equal(a.src, b.src) and np.array_equal(a.tgt, b.tgt)
        assert a.n_words == b.n_words
    for kw in ({}, {"add_bos": True, "add_eos": True}, {"length": 80}):
        ra = jpad_batch([s.src for s in ref], **kw)
        pa = pad_batch([s.src for s in port], **kw)
        assert all(np.array_equal(x, y) for x, y in zip(ra, pa))
    for mode in ("none", "words", "tokens"):
        assert jmake_batches(ref, 8, mode) == make_batches(port, 8, mode)
    assert [jnext_pow2(n) for n in range(70)] == [next_pow2(n)
                                                  for n in range(70)]
    rng = np.random.default_rng(0)
    hyps = [list(rng.integers(3, 9, rng.integers(1, 12))) for _ in range(40)]
    refs = [list(rng.integers(3, 9, rng.integers(1, 12))) for _ in range(40)]
    assert corpus_bleu(hyps, refs) == jcorpus_bleu(hyps, refs)


# ---------------------------------------------------------------------------
# calibration: identical numpy activations → identical thresholds
# ---------------------------------------------------------------------------

def _activation_sets(seed):
    rng = np.random.default_rng(seed)
    gauss = rng.standard_normal((3, 64, 48)).astype(np.float32)
    narrow = rng.standard_normal((3, 64, 48)).astype(np.float32) * 0.05
    narrow[:, 0, 0] = 9.0                                   # long-tail outlier
    sparse = np.zeros((3, 64, 48), np.float32)
    sparse[:, :2, :3] = rng.standard_normal((3, 2, 3)) * 4
    skewed = np.abs(rng.standard_normal((3, 64, 48))).astype(np.float32) * 2
    skewed -= 0.3
    return {"gauss": gauss, "narrow": narrow, "sparse": sparse,
            "skewed": skewed}


@pytest.mark.parametrize("mode", ["symmetric", "independent", "conjugate",
                                  "naive"])
def test_calibrator_thresholds_equal_reference(mode):
    sets = _activation_sets(seed=1)
    jcal, cal = JCalibrator(), Calibrator()
    for i in range(3):                         # three streamed batches per site
        for name, arr in sets.items():
            jcal.observe_site(name, arr[i])
            cal.observe_site(name, arr[i])
    want, got = jcal.compute(mode), cal.compute(mode)
    assert set(want) == set(got)
    for name in want:
        w, g = want[name], got[name]
        assert (g.thresholds.t_min, g.thresholds.t_max) == \
            (w.thresholds.t_min, w.thresholds.t_max), name
        assert dataclasses.asdict(g.classification) == \
            dataclasses.asdict(w.classification), name
        assert g.quantize == w.quantize, name
    assert got["sparse"].classification.kind == "sparse"


# ---------------------------------------------------------------------------
# weight bridge + quantize_model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nmt_random():
    cfg = jget_config("transformer-base").reduced(**NMT)
    model = build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(3))


def test_bridge_unstacked_tree_is_identical(nmt_random):
    _, _, jparams = nmt_random
    flat = _flatten_with_paths(jparams)
    got = _flat_leaves(params_from_flat(flat, device="cpu"))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)


def test_bridge_splits_stacked_tree_with_qtensors():
    cfg = jget_config("transformer-base").reduced(
        **{**NMT, "n_layers": 3}, scan_layers=True)
    jparams = build_model(cfg).init(jax.random.PRNGKey(1))
    qparams, _ = jquantize_model(jparams, {},
                                 JQuantPolicy(act_quant="dynamic"))
    got = params_from_flat(_flatten_with_paths(qparams), device="cpu")
    assert sorted(k for k in got if "blocks" in k) == [
        "dec_blocks.0", "dec_blocks.1", "dec_blocks.2",
        "enc_blocks.0", "enc_blocks.1"]
    w = qparams["dec_blocks"]["ffn"]["in"]["w"]
    assert isinstance(w, JQTensor)
    for i in range(3):
        qt = got[f"dec_blocks.{i}"]["ffn"]["in"]["w"]
        assert isinstance(qt, QTensor) and qt.data.dtype == torch.int8
        np.testing.assert_array_equal(qt.data.numpy(), np.asarray(w.data[i]))
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(w.scale[i]))
        assert tuple(qt.scale.shape) == (1, cfg.d_ff)


@pytest.mark.parametrize("act_quant", ["dynamic", "static"])
def test_quantize_model_codes_and_scales_equal(nmt_random, act_quant):
    """Same fp weights → the same int8 codes and bit-equal scales, and the
    same sites quantized (static: only calibrated, non-sparse sites)."""
    _, jmodel, jparams = nmt_random
    calibs = {}
    if act_quant == "static":
        jcal = JCalibrator()
        rng = np.random.default_rng(0)
        for site in ("enc_blocks.0/attn/q_proj", "dec_blocks.1/ffn/out",
                     "dec_blocks.0/self_attn/o_proj"):
            jcal.observe_site(site, rng.standard_normal((8, 16)))
        calibs = jcal.compute("symmetric")
    jq, _ = jquantize_model(jparams, calibs, JQuantPolicy(act_quant=act_quant))
    port_fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    pq, ctx = quantize_model(port_fp, calibrations_from_reference(calibs),
                             QuantPolicy(act_quant=act_quant), device="cpu")
    want, got = _flat_leaves_ref(jq), _flat_leaves(pq)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_q = sum(k.endswith("/w/0") for k in got)
    # static: the three calibrated sites and, through their layer-agnostic
    # envelopes (``enc_blocks.*/...``), the same site of the other layer
    assert n_q == (6 if act_quant == "static" else 32)
    assert ctx.impl == "auto"


def _flat_leaves_ref(jtree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(jtree).items()}


# ---------------------------------------------------------------------------
# model: logits of forward and decode_step
# ---------------------------------------------------------------------------

def _nmt_batch(seed, B=3, S=7, T=5, vocab=64):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, vocab, (B, S)).astype(np.int32)
    tgt = rng.integers(3, vocab, (B, T)).astype(np.int32)
    lens = np.array([S, S - 3, S - 1][:B], np.int32)
    return src, tgt, lens


def _contexts(jparams, kind):
    """(ref params, ref ctx, port params, port ctx) for FP or INT8 dynamic."""
    port_fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    if kind == "fp":
        from repro.core import FP_CONTEXT as JFP
        from repro_torch.core import FP_CONTEXT
        return jparams, JFP, port_fp, FP_CONTEXT
    jq, jctx = jquantize_model(jparams, {}, JQuantPolicy(act_quant="dynamic"))
    pq, pctx = quantize_model(port_fp, {}, QuantPolicy(act_quant="dynamic"),
                              device="cpu")
    return jq, jctx, pq, pctx


# FP: f32 all the way; only the summation order of the matmuls differs.
# INT8 (dynamic): a last-bit difference in an activation can move one int8
# code by one step at a rounding boundary.  That shifts one dense output row
# by scale_a·|w| ≈ (3/127)·0.09 ≈ 2e-3 here, and an encoder flip reaches
# every decoder position through cross-attention: measured 4e-3–8e-3 on the
# batches where a flip happens (1e-7 elsewhere).  0.02 allows a few flips.
ATOL = {"fp": 1e-5, "int8": 2e-2}


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_forward_logits_match(nmt_random, kind):
    cfg, jmodel, jparams = nmt_random
    jp, jctx, pp, pctx = _contexts(jparams, kind)
    src, tgt, lens = _nmt_batch(seed=4)
    want, _ = jmodel.forward(jp, {"src_tokens": jnp.asarray(src),
                                  "tgt_tokens": jnp.asarray(tgt),
                                  "src_lengths": jnp.asarray(lens)},
                             quant=jctx)
    model = EncDecLM(get_config("transformer-base").reduced(**NMT),
                     device="cpu")
    got, _ = model.forward(pp, {"src_tokens": torch.from_numpy(src),
                                "tgt_tokens": torch.from_numpy(tgt),
                                "src_lengths": torch.from_numpy(lens)},
                           quant=pctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL[kind], rtol=0)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_decode_step_logits_and_cache_match(nmt_random, kind):
    cfg, jmodel, jparams = nmt_random
    jp, jctx, pp, pctx = _contexts(jparams, kind)
    src, _, lens = _nmt_batch(seed=5)
    model = EncDecLM(get_config("transformer-base").reduced(**NMT),
                     device="cpu")
    quantized = kind == "int8"
    js = jmodel.init_decode_state(3, 8, quantized=quantized)
    ps = model.init_decode_state(3, 8, quantized=quantized)
    jl, js = jmodel.prefill(jp, {"src_tokens": jnp.asarray(src),
                                 "src_lengths": jnp.asarray(lens)}, js,
                            quant=jctx)
    pl, ps = model.prefill(pp, {"src_tokens": torch.from_numpy(src),
                                "src_lengths": torch.from_numpy(lens)}, ps,
                           quant=pctx)
    # 9 steps into a capacity-8 cache: the last step's writes must drop
    for step in range(10):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=ATOL[kind], rtol=0,
                                   err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        if step == 9:
            break
        jl, js = jmodel.decode_step(jp, jnp.asarray(tok), js, quant=jctx)
        pl, ps = model.decode_step(pp, torch.from_numpy(tok), ps, quant=pctx)
    np.testing.assert_array_equal(ps["cache"].lengths.numpy(),
                                  np.asarray(js["cache"].lengths))
    if quantized:
        kdiff = np.abs(ps["cache"].k.numpy().astype(np.int32)
                       - np.asarray(js["cache"].k).astype(np.int32))
        assert kdiff.max() <= 1, kdiff.max()        # one code at a boundary
    else:
        np.testing.assert_allclose(ps["cache"].k.numpy(),
                                   np.asarray(js["cache"].k), atol=1e-5)
