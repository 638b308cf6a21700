"""The port's translation path end to end against the reference engine, on
the tiny trained NMT model (``conftest.trained_nmt``).

The trained weights are carried into the port with
``checkpoint/bridge.py``; for static activation quantization the reference
calibrates (KL, symmetric) and its thresholds are carried across, so both
sides quantize with identical thresholds.  On the first 48 sentences, with
``max_new_tokens=16``, greedy and beam-4 output must be token-identical to
the reference ``ServingEngine`` for FP, INT8 static and INT8 dynamic, and the
port's INT8 BLEU must stay within the paper's 0.5% relative bar of its FP
BLEU (as ``tests/test_int8_parity.py`` asks of the reference) in the three
cases where the reference meets it; with dynamic scales and greedy search
the reference itself misses it, and the port is held to its score.

Every test that needs ``trained_nmt`` lives in this file: under
``--dist loadfile`` each file that uses the fixture trains it again.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.core import FP_CONTEXT as JFP_CONTEXT
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model

from repro_torch.checkpoint.bridge import (
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.configs import get_config
from repro_torch.core import FP_CONTEXT, QuantPolicy, QTensor, quantize_model
from repro_torch.data import corpus_bleu, pad_batch
from repro_torch.models import EncDecLM
from repro_torch.serving import ServingEngine

from _torch_reference import (
    import_reference_serving as _import_reference_serving,
    reference_calibration as _reference_calibration,
)

MAX_NEW = 16
MAX_LEN = 64
BEAM = 4
REL_DROP = 0.005                 # the paper's < 0.5% relative BLEU bar
MODES = ("fp", "int8_static", "int8_dynamic")
# trained_nmt's overrides (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)


@pytest.fixture(scope="module")
def nmt_slice(trained_nmt):
    _, jmodel, jparams, corpus, _ = trained_nmt
    jcalibs = _reference_calibration(jmodel, jparams, corpus)
    ref = {"fp": (jparams, JFP_CONTEXT),
           "int8_static": jquantize_model(
               jparams, jcalibs, JQuantPolicy(act_quant="static")),
           "int8_dynamic": jquantize_model(
               jparams, {}, JQuantPolicy(act_quant="dynamic"))}
    model = EncDecLM(get_config("transformer-base").reduced(**NMT),
                     device="cpu")
    fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    port = {"fp": (fp, FP_CONTEXT),
            "int8_static": quantize_model(
                fp, calibrations_from_reference(jcalibs),
                QuantPolicy(act_quant="static"), device="cpu"),
            "int8_dynamic": quantize_model(
                fp, {}, QuantPolicy(act_quant="dynamic"), device="cpu")}
    test_set = corpus[:48]
    src, lens = pad_batch([s.src for s in test_set])
    return dict(jmodel=jmodel, model=model, ref=ref, port=port,
                batch={"src_tokens": src, "src_lengths": lens},
                refs=[list(s.tgt) for s in test_set], calibs=jcalibs)


@pytest.fixture(scope="module")
def translate(nmt_slice):
    """``translate(side, mode, search)`` → token lists, computed once."""
    done = {}

    def run(side, mode, search):
        key = (side, mode, search)
        if key not in done:
            if side == "ref":
                params, ctx = nmt_slice["ref"][mode]
                engine = _import_reference_serving().ServingEngine(
                    nmt_slice["jmodel"], params, quant=ctx, max_len=MAX_LEN)
            else:
                params, ctx = nmt_slice["port"][mode]
                engine = ServingEngine(nmt_slice["model"], params, quant=ctx,
                                       max_len=MAX_LEN, device="cpu")
            if search == "greedy":
                res = engine.generate(nmt_slice["batch"],
                                      max_new_tokens=MAX_NEW)
            else:
                res = engine.generate_beam(nmt_slice["batch"], beam=BEAM,
                                           max_new_tokens=MAX_NEW)
            done[key] = [list(map(int, t)) for t in res.tokens]
        return done[key]

    return run


def _flat(tree, prefix=()):
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


@pytest.mark.parametrize("mode", ["int8_static", "int8_dynamic"])
def test_quantized_weights_equal_reference(nmt_slice, mode):
    """quantize_model on the carried fp weights and thresholds gives the
    reference's int8 codes and scales bit for bit, at the same sites."""
    want = {k: np.asarray(v) for k, v in
            _flatten_with_paths(nmt_slice["ref"][mode][0]).items()}
    got = _flat(nmt_slice["port"][mode][0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mode == "int8_static":
        assert len(nmt_slice["calibs"]) == 32       # every dense input site
        assert sum(k.endswith("w/0") for k in got) == sum(
            c.quantize for c in nmt_slice["calibs"].values())


# FP: f32 throughout; matmul summation order differs → ~1e-6 relative.
# INT8: a last-bit activation difference can move a code by one step at a
# rounding boundary (see test_torch_core.py), a bounded local shift.
LOGIT_ATOL = {"fp": 1e-4, "int8_static": 5e-2, "int8_dynamic": 5e-2}


@pytest.mark.parametrize("mode", MODES)
def test_trained_logits_match(nmt_slice, mode):
    """Teacher-forced logits and the first decode steps' logits."""
    jmodel, model = nmt_slice["jmodel"], nmt_slice["model"]
    jp, jctx = nmt_slice["ref"][mode]
    pp, pctx = nmt_slice["port"][mode]
    src = nmt_slice["batch"]["src_tokens"][:8]
    lens = nmt_slice["batch"]["src_lengths"][:8]
    tgt = np.tile(np.arange(3, 9, dtype=np.int32), (8, 1))
    want, _ = jmodel.forward(jp, {"src_tokens": jnp.asarray(src),
                                  "src_lengths": jnp.asarray(lens),
                                  "tgt_tokens": jnp.asarray(tgt)}, quant=jctx)
    got, _ = model.forward(pp, {"src_tokens": torch.from_numpy(src),
                                "src_lengths": torch.from_numpy(lens),
                                "tgt_tokens": torch.from_numpy(tgt)},
                           quant=pctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL[mode], rtol=0)

    quantized = mode != "fp"
    js = jmodel.init_decode_state(8, MAX_LEN, quantized=quantized)
    ps = model.init_decode_state(8, MAX_LEN, quantized=quantized)
    jl, js = jmodel.prefill(jp, {"src_tokens": jnp.asarray(src),
                                 "src_lengths": jnp.asarray(lens)}, js,
                            quant=jctx)
    pl, ps = model.prefill(pp, {"src_tokens": torch.from_numpy(src),
                                "src_lengths": torch.from_numpy(lens)}, ps,
                           quant=pctx)
    for step in range(4):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL[mode], rtol=0,
                                   err_msg=f"decode step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, js = jmodel.decode_step(jp, jnp.asarray(tok), js, quant=jctx)
        pl, ps = model.decode_step(pp, torch.from_numpy(tok), ps, quant=pctx)


@pytest.mark.parametrize("search", ["greedy", "beam4"])
@pytest.mark.parametrize("mode", MODES)
def test_tokens_identical_to_reference_engine(translate, mode, search):
    want = translate("ref", mode, search)
    got = translate("port", mode, search)
    diverged = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not diverged, (f"{len(diverged)}/{len(want)} sentences differ, "
                          f"first {diverged[0]}: {got[diverged[0]]} vs "
                          f"{want[diverged[0]]}")


@pytest.mark.parametrize("search", ["greedy", "beam4"])
def test_burst_length_does_not_change_tokens(nmt_slice, translate, search):
    """The burst only sets how often the host drains the ring buffer: the
    tokens are the same for every burst length (INT8 static)."""
    params, ctx = nmt_slice["port"]["int8_static"]
    engine = ServingEngine(nmt_slice["model"], params, quant=ctx,
                           max_len=MAX_LEN, device="cpu")
    for k in (1, 3):
        if search == "greedy":
            res = engine.generate(nmt_slice["batch"], max_new_tokens=MAX_NEW,
                                  burst_len=k)
        else:
            res = engine.generate_beam(nmt_slice["batch"], beam=BEAM,
                                       max_new_tokens=MAX_NEW, burst_len=k)
        got = [list(map(int, t)) for t in res.tokens]
        assert got == translate("port", "int8_static", search), k


@pytest.mark.parametrize("mode,search", [("int8_static", "greedy"),
                                         ("int8_static", "beam4"),
                                         ("int8_dynamic", "beam4")])
def test_int8_bleu_within_half_percent_of_fp(nmt_slice, translate, mode,
                                             search):
    refs = nmt_slice["refs"]
    bleu_fp = corpus_bleu(translate("port", "fp", search), refs)
    assert bleu_fp > 10.0, f"the FP model should translate (BLEU={bleu_fp})"
    bleu_q = corpus_bleu(translate("port", mode, search), refs)
    assert bleu_q >= bleu_fp * (1.0 - REL_DROP), (bleu_fp, bleu_q)


def test_int8_dynamic_greedy_bleu_is_the_references(nmt_slice, translate):
    """Dynamic per-row activation scales with greedy search drop BLEU by
    more than the paper's bar on this model (62.03 → 60.11 when measured),
    and the reference engine drops it identically: its tokens are the
    port's.  The port is held to the reference's score here."""
    refs = nmt_slice["refs"]
    port = corpus_bleu(translate("port", "int8_dynamic", "greedy"), refs)
    ref = corpus_bleu(translate("ref", "int8_dynamic", "greedy"), refs)
    assert port == ref
    assert port > 10.0
