"""The port's translation path end to end against the reference engine, on
the tiny trained NMT model (``conftest.trained_nmt``).

The trained weights are carried into the port with
``checkpoint/bridge.py``; for static activation quantization the reference
calibrates (KL, symmetric) and its thresholds are carried across, so both
sides quantize with identical thresholds.  On the first 48 sentences, with
``max_new_tokens=16``, greedy and beam-4 output must be token-identical to
the reference ``ServingEngine`` for FP, INT8 static and INT8 dynamic, and
for INT4 weights (``weight_bits=4``) with static and dynamic activation
scales, and so must the step count and the host syncs.  The INT4 weights
are the reference's own, carried across with their group size
(``bridge.block_meta_of``), so the comparison does not rest on the order of
``quantize_block``'s f32 sums; the port's own INT4 quantization is held to
the reference's routing and byte counts.  The port's quantized BLEU must
stay within the paper's 0.5% relative bar of its FP BLEU (as
``tests/test_int8_parity.py`` asks of the reference) in the cases where the
reference meets it; elsewhere the port is held to the reference's score.

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
from repro.core import count_quantized as jcount_quantized
from repro.core import quantize_model as jquantize_model
from repro.core import weight_bytes_by_site as jweight_bytes_by_site

from repro_torch.checkpoint.bridge import (
    block_meta_of,
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.configs import get_config
from repro_torch.core import (
    FP_CONTEXT,
    QuantContext,
    QuantPolicy,
    QTensor,
    count_quantized,
    quantize_model,
    weight_bytes_by_site,
)
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
MODES = ("fp", "int8_static", "int8_dynamic", "int4_static", "int4_dynamic")
# trained_nmt's overrides (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)


@pytest.fixture(scope="module")
def nmt_slice(trained_nmt):
    _, jmodel, jparams, corpus, _ = trained_nmt
    jcalibs = _reference_calibration(jmodel, jparams, corpus)
    calibs = calibrations_from_reference(jcalibs)
    act = {"static": jcalibs, "dynamic": {}}
    ref = {"fp": (jparams, JFP_CONTEXT)}
    for a, c in act.items():
        for bits in (8, 4):
            ref[f"int{bits}_{a}"] = jquantize_model(
                jparams, c, JQuantPolicy(act_quant=a), weight_bits=bits)
    model = EncDecLM(get_config("transformer-base").reduced(**NMT),
                     device="cpu")
    fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    port = {"fp": (fp, FP_CONTEXT)}
    for a in act:
        port[f"int8_{a}"] = quantize_model(
            fp, calibs if a == "static" else {}, QuantPolicy(act_quant=a),
            device="cpu")
        # the reference's INT4 tree, carried across leaf for leaf
        jq = ref[f"int4_{a}"][0]
        port[f"int4_{a}"] = (
            params_from_flat(_flatten_with_paths(jq), device="cpu",
                             block_meta=block_meta_of(jq)),
            QuantContext(policy=QuantPolicy(act_quant=a),
                         calibrations=dict(calibs if a == "static" else {})))
    test_set = corpus[:48]
    src, lens = pad_batch([s.src for s in test_set])
    return dict(jmodel=jmodel, model=model, ref=ref, port=port, fp=fp,
                batch={"src_tokens": src, "src_lengths": lens},
                refs=[list(s.tgt) for s in test_set], calibs=jcalibs)


@pytest.fixture(scope="module")
def translate(nmt_slice):
    """``translate(side, mode, search)`` → (token lists, (steps,
    host_syncs)), computed once."""
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
            done[key] = ([list(map(int, t)) for t in res.tokens],
                         (res.steps, res.host_syncs))
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


@pytest.mark.parametrize("mode", ["int4_static", "int4_dynamic"])
def test_int4_quantize_model_bytes_equal_reference(nmt_slice, mode):
    """The port's own ``quantize_model(weight_bits=4)`` on the carried fp
    weights: the same INT4 and INT8 sites with the same bytes as the
    reference's (8 INT4 linears: 2 decoder layers × the two output
    projections and the two FFN matrices)."""
    jq = nmt_slice["ref"][mode][0]
    act = mode.split("_")[1]
    pq, _ = quantize_model(
        nmt_slice["fp"],
        calibrations_from_reference(nmt_slice["calibs"])
        if act == "static" else {},
        QuantPolicy(act_quant=act), weight_bits=4, device="cpu")
    assert count_quantized(pq) == jcount_quantized(jq)
    assert weight_bytes_by_site(pq) == jweight_bytes_by_site(jq)
    assert count_quantized(pq)["int4_linears"] == 8


# FP: f32 throughout; matmul summation order differs → ~1e-6 relative.
# INT8: a last-bit activation difference can move a code by one step at a
# rounding boundary (see test_torch_core.py), a bounded local shift.
LOGIT_ATOL = {"fp": 1e-4, "int8_static": 5e-2, "int8_dynamic": 5e-2,
              "int4_static": 5e-2, "int4_dynamic": 5e-2}


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
    """Tokens, steps and host syncs (one per burst plus the first tokens)
    equal the reference engine's."""
    want, want_counts = translate("ref", mode, search)
    got, got_counts = translate("port", mode, search)
    diverged = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not diverged, (f"{len(diverged)}/{len(want)} sentences differ, "
                          f"first {diverged[0]}: {got[diverged[0]]} vs "
                          f"{want[diverged[0]]}")
    assert got_counts == want_counts


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
        assert got == translate("port", "int8_static", search)[0], k


@pytest.mark.parametrize("mode,search", [("int8_static", "greedy"),
                                         ("int8_static", "beam4"),
                                         ("int8_dynamic", "beam4")])
def test_int8_bleu_within_half_percent_of_fp(nmt_slice, translate, mode,
                                             search):
    refs = nmt_slice["refs"]
    bleu_fp = corpus_bleu(translate("port", "fp", search)[0], refs)
    assert bleu_fp > 10.0, f"the FP model should translate (BLEU={bleu_fp})"
    bleu_q = corpus_bleu(translate("port", mode, search)[0], refs)
    assert bleu_q >= bleu_fp * (1.0 - REL_DROP), (bleu_fp, bleu_q)


def test_int8_dynamic_greedy_bleu_is_the_references(nmt_slice, translate):
    """Dynamic per-row activation scales with greedy search drop BLEU by
    more than the paper's bar on this model (62.03 → 60.11 when measured),
    and the reference engine drops it identically: its tokens are the
    port's.  The port is held to the reference's score here."""
    refs = nmt_slice["refs"]
    port = corpus_bleu(translate("port", "int8_dynamic", "greedy")[0], refs)
    ref = corpus_bleu(translate("ref", "int8_dynamic", "greedy")[0], refs)
    assert port == ref
    assert port > 10.0



@pytest.mark.parametrize("search", ["greedy", "beam4"])
def test_int4_static_bleu_within_half_percent_of_fp(nmt_slice, translate,
                                                    search):
    """INT4 weights with calibrated activation scales meet the paper's bar
    (measured: greedy 62.03 → 62.90, beam-4 72.45 → 74.86), as they do in
    the reference engine, whose tokens are the port's."""
    refs = nmt_slice["refs"]
    bleu_fp = corpus_bleu(translate("port", "fp", search)[0], refs)
    bleu_q = corpus_bleu(translate("port", "int4_static", search)[0], refs)
    assert bleu_q >= bleu_fp * (1.0 - REL_DROP), (bleu_fp, bleu_q)


@pytest.mark.parametrize("search", ["greedy", "beam4"])
def test_int4_dynamic_bleu_is_the_references(nmt_slice, translate, search):
    """INT4 weights with dynamic per-row activation scales miss the bar on
    this model in the reference engine (measured: greedy 62.03 → 60.63,
    −2.3%; beam-4 72.45 → 72.04, −0.56%), and the port's tokens are the
    reference's: the port is held to the reference's score."""
    refs = nmt_slice["refs"]
    port = corpus_bleu(translate("port", "int4_dynamic", search)[0], refs)
    ref = corpus_bleu(translate("ref", "int4_dynamic", search)[0], refs)
    assert port == ref
    assert port > 10.0
