"""The enc-dec quantization sites against the reference's *jitted* engine.

The reference engine runs its prefill and decode steps under ``jax.jit``,
and XLA computes some float ops there in another form than the reference's
plain functions read: it rewrites a division by a constant into a multiply
by the constant's float32 reciprocal (``amax / 127`` becomes
``amax * float32(1/127)``; a calibrated ``x / scale`` becomes
``x * float32(1/scale)``) and folds a constant activation scale into the
weight scales first (``acc * a_scale * b_scale`` becomes
``acc * (a_scale * b_scale)``).  The engine, not the plain function, is the
oracle the port's tokens are held to.

This test runs ``jax.jit`` of the reference's ``prefill`` and one
``decode_step`` of a reduced ``transformer-base`` (INT8, dynamic and static
activation scales, float32 and bfloat16 activations), records every call of
three sites inside the jitted program with its inputs and outputs, and runs
the port's plain versions on the same inputs:

* K1/K2, the activation quantizers (``ops.quantize_static`` codes,
  ``ops.quantize_rowwise`` codes and row scales);
* ``quantize_kv``, the KV cache's per-token scales and codes;
* K3's epilogue (``ops.int8_matmul`` on the recorded codes and scales).

It counts the elements that differ at each site.  Before the port took the
jitted forms (counted on these inputs): K2 scales 103 of 1664 rows (f32)
and 76 (bf16), K2 codes 1 and 29 of 239616; K1 codes 0 (f32) and 30
(bf16); KV scales 5-22 of 256 and KV codes 0-1 of 8192; K3 outputs 87326
of 239616 with static scales in f32 (2 in bf16), 0 with dynamic ones.
The port now computes the jitted forms in its plain versions and in the
CUDA kernels alike, and every count is 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.kernels.ref as jref
import repro.models.kv_cache as jkv
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.data import make_corpus as jmake_corpus
from repro.data import pad_batch as jpad_batch
from repro.models import build_model

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kv

from _torch_reference import reference_calibration

NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)
BATCH = 8
MAX_LEN = 16
SITES = ("k1_codes", "k2_codes", "k2_scales", "kv_codes", "kv_scales",
         "k3_out")


@pytest.fixture(scope="module")
def reference():
    """The reference model per activation dtype, its random weights, KL
    calibration records and a padded source batch."""
    corpus = jmake_corpus(240, NMT["vocab"], max_words=5, seed=0)
    src, lens = jpad_batch([s.src for s in corpus[:BATCH]])
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(jget_config("transformer-base").reduced(
            dtype=dtype, **NMT))
        params = model.init(jax.random.PRNGKey(0))
        out[dtype] = (model, params,
                      reference_calibration(model, params, corpus))
    return out, jnp.asarray(src), jnp.asarray(lens)


def _record_jitted(model, qparams, ctx, src, lens, monkeypatch):
    """Run the jitted prefill + one decode step with spies on the three
    sites; returns the recorded (inputs, outputs) per site as numpy, and
    K3's static facts (zero point and bias given, output dtype)."""
    rec, k3_meta = {}, []
    quantize_rowwise, quantize_static = (jref.ref_quantize_rowwise,
                                         jref.ref_quantize_static)
    int8_matmul, quantize_kv = jref.ref_int8_matmul, jkv.quantize_kv

    def k2(x):
        q, s = quantize_rowwise(x)
        rec.setdefault("k2", []).append((x, q, s))
        return q, s

    def k1(x, amax):
        q = quantize_static(x, amax)
        rec.setdefault("k1", []).append(
            (x, jnp.asarray(amax, jnp.float32), q))
        return q

    def k3(a, a_s, b, b_s, zp=None, bias=None, out_dtype=jnp.float32):
        out = int8_matmul(a, a_s, b, b_s, zp, bias, out_dtype)
        rec.setdefault("k3", []).append(
            (a, jnp.asarray(a_s, jnp.float32), b,
             jnp.asarray(b_s, jnp.float32),
             jnp.zeros(b.shape[1:]) if bias is None else bias, out))
        k3_meta.append((bias is not None, out_dtype))
        return out

    def qkv(x):
        q, s = quantize_kv(x)
        rec.setdefault("kv", []).append((x, q, s))
        return q, s

    monkeypatch.setattr(jref, "ref_quantize_rowwise", k2)
    monkeypatch.setattr(jref, "ref_quantize_static", k1)
    monkeypatch.setattr(jref, "ref_int8_matmul", k3)
    monkeypatch.setattr(jkv, "quantize_kv", qkv)

    def run(qp, src, lens):
        rec.clear()
        del k3_meta[:]
        state = model.init_decode_state(BATCH, MAX_LEN, quantized=True)
        logits, state = model.prefill(qp, {"src_tokens": src,
                                           "src_lengths": lens}, state,
                                      quant=ctx)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        model.decode_step(qp, tok, state, quant=ctx)
        return dict(rec)

    # the weights are arguments, as in the engine's jitted programs
    out = jax.jit(run)(qparams, src, lens)
    monkeypatch.undo()
    to_np = lambda t: np.asarray(t)
    return jax.tree_util.tree_map(to_np, out), list(k3_meta)


def _torch(a: np.ndarray) -> torch.Tensor:
    """numpy (bfloat16 included) → torch of the same dtype."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _count(got: torch.Tensor, want: np.ndarray):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = want.astype(np.float32) if want.dtype == jnp.bfloat16 else want
    assert got.shape == want.shape, (got.shape, want.shape)
    return int((got != want).sum()), int(want.size)


def _port_counts(rec, k3_meta, static: bool):
    """Differing elements / elements per site: the port's plain versions
    (its CPU path, the same forms as its kernels) on the recorded inputs."""
    counts = {site: [0, 0] for site in SITES}

    def add(site, pair):
        counts[site][0] += pair[0]
        counts[site][1] += pair[1]

    for x, amax, q in rec.get("k1", []):
        got = ops.quantize_static(_torch(x), float(amax))
        add("k1_codes", _count(got.data, q))
    for x, q, s in rec.get("k2", []):
        got = ops.quantize_rowwise(_torch(x))
        add("k2_codes", _count(got.data, q))
        add("k2_scales", _count(got.scale, s))
    for x, q, s in rec.get("kv", []):
        gq, gs = kv.quantize_kv(_torch(x))
        add("kv_codes", _count(gq, q))
        add("kv_scales", _count(gs, s))
    for (a, a_s, b, b_s, bias, out), (has_bias, out_dtype) in zip(
            rec.get("k3", []), k3_meta):
        # the port's ops pass a calibrated (static) scale as a float and a
        # dynamic one as the (M, 1) tensor it is
        scale = (float(a_s.reshape(())) if static
                 else _torch(a_s).reshape(-1, 1))
        aq = QTensor(_torch(a), scale, 0.0, None)
        bq = QTensor(_torch(b), _torch(b_s).reshape(1, -1), 0.0, None)
        got = ops.int8_matmul(
            aq, bq, _torch(bias) if has_bias else None,
            out_dtype=(torch.bfloat16 if out_dtype == jnp.bfloat16
                       else torch.float32))
        add("k3_out", _count(got, out))
    return counts


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sites_match_jitted_engine(reference, dtype, mode, monkeypatch):
    models, src, lens = reference
    model, params, calib = models[dtype]
    qparams, ctx = jquantize_model(params, calib if mode == "static" else {},
                                   JQuantPolicy(act_quant=mode))
    rec, k3_meta = _record_jitted(model, qparams, ctx, src, lens, monkeypatch)
    counts = _port_counts(rec, k3_meta, static=(mode == "static"))
    print(f"{dtype} {mode}: " + ", ".join(
        f"{site} {d}/{n}" for site, (d, n) in counts.items()))
    # every site ran: the activation quantizer of the mode, the KV cache
    # and K3 (2 + 2 layers × their linears, twice)
    quantizer = "k1_codes" if mode == "static" else "k2_codes"
    for site in (quantizer, "kv_codes", "kv_scales", "k3_out"):
        assert counts[site][1] > 0, (site, counts)
    assert {site: d for site, (d, _) in counts.items()} == dict.fromkeys(
        SITES, 0), counts
