"""The serving engine's ``generate`` and ``generate_beam`` on the zoo's
reduced models against the reference engine (which runs jitted), on the
CPU: tokens, steps and host syncs, for the dense archs (``granite-8b``,
``yi-9b``, ``mistral-nemo-12b``, also with a head dim of 32,
``command-r-35b``) and ``qwen3-moe-30b-a3b`` in FP, INT8 dynamic and INT8
static; greedy from the VLM backbone's ``embeds``; and a SwiGLU
encoder-decoder from the audio stub's ``src_embeds`` with INT8 and
block-wise INT4 weights.  The models and tolerances are
``tests/_torch_zoo.py``'s.
"""

import numpy as np
import pytest

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model

from repro_torch.checkpoint.bridge import block_meta_of, params_from_flat
from repro_torch.core import (
    BlockQTensor,
    QuantPolicy,
    QTensor,
    count_quantized,
    quantize_model,
)
from repro_torch.serving import ServingEngine

from _torch_reference import import_reference_serving
from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    DECODERS,
    KINDS,
    MAX_LEN,
    MAX_NEW,
    decoder,
    first_divergence,
    flat_leaves,
    one_torch_thread,
    prompts,
    vlm_model,
    whisper,
)


@pytest.mark.parametrize("search", ["greedy", "beam2"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_generate_matches_reference_engine(name, kind, search):
    """Tokens, steps and host syncs of ``generate`` and ``generate_beam``
    (beam 2) equal the reference engine's on 6 right-padded prompts."""
    s = decoder(name)
    (jp, jctx), (pp, pctx) = s["sides"][kind]
    toks, lens = prompts(seed=3, n=6)
    batch = {"tokens": toks, "lengths": lens}
    jengine = import_reference_serving().ServingEngine(
        s["jmodel"], jp, quant=jctx, max_len=MAX_LEN)
    engine = ServingEngine(s["model"], pp, quant=pctx, max_len=MAX_LEN,
                           device="cpu")
    if search == "greedy":
        want = jengine.generate(batch, max_new_tokens=MAX_NEW)
        got = engine.generate(batch, max_new_tokens=MAX_NEW)
    else:
        want = jengine.generate_beam(batch, beam=2, max_new_tokens=MAX_NEW)
        got = engine.generate_beam(batch, beam=2, max_new_tokens=MAX_NEW)
    wt = [list(map(int, t)) for t in want.tokens]
    gt = [list(map(int, t)) for t in got.tokens]
    assert gt == wt, first_divergence(wt, gt)
    assert (got.steps, got.host_syncs) == (want.steps, want.host_syncs)




def test_vlm_generate_from_embeds_matches_reference_engine():
    """The engine's greedy ``generate`` from an ``embeds`` batch: tokens,
    steps and host syncs equal the reference engine's (INT8 static)."""
    vlm = vlm_model()
    (jp, jctx), (pp, pctx) = vlm["sides"]["int8_static"]
    batch = {"embeds": vlm["embeds"], "lengths": vlm["lens"]}
    want = import_reference_serving().ServingEngine(
        vlm["jmodel"], jp, quant=jctx, max_len=24).generate(
            batch, max_new_tokens=8)
    got = ServingEngine(vlm["model"], pp, quant=pctx, max_len=24,
                        device="cpu").generate(batch, max_new_tokens=8)
    wt = [list(map(int, t)) for t in want.tokens]
    gt = [list(map(int, t)) for t in got.tokens]
    assert gt == wt, first_divergence(wt, gt)
    assert (got.steps, got.host_syncs) == (want.steps, want.host_syncs)


@pytest.mark.parametrize("weight_bits", [8, 4])
def test_swiglu_encdec_generate_matches_reference_engine(weight_bits):
    """A SwiGLU encoder-decoder (reduced whisper-base with ``ffn="swiglu"``)
    fed ``src_embeds``: with ``weight_bits=4`` its decoder gate/up/down go
    block-wise INT4 (the port's plain INT4 matmul on the CPU), as in the
    reference; the quantized trees are the same bits and greedy
    ``generate`` gives the reference engine's tokens, steps and host
    syncs."""
    w = whisper("swiglu")
    jq, jctx = jquantize_model(w["jparams"], {},
                               JQuantPolicy(act_quant="dynamic"),
                               weight_bits=weight_bits)
    flat = _flatten_with_paths(jq)
    pq = params_from_flat(flat, device="cpu", block_meta=block_meta_of(jq))
    mine, pctx = quantize_model(w["fp"], {},
                                QuantPolicy(act_quant="dynamic"),
                                device="cpu", weight_bits=weight_bits)
    got = {k: v.numpy() for k, v in flat_leaves(mine).items()}
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    int4 = count_quantized(mine)["int4_linears"]
    assert int4 == (3 * w["cfg"].n_layers + w["cfg"].n_layers * 2
                    if weight_bits == 4 else 0)
    if weight_bits == 4:
        assert isinstance(mine["dec_blocks.0"]["ffn"]["gate"]["w"],
                          BlockQTensor)
        assert isinstance(mine["enc_blocks.0"]["ffn"]["gate"]["w"], QTensor)
    batch = {"src_embeds": w["frames"], "src_lengths": w["lens"]}
    want = import_reference_serving().ServingEngine(
        w["jmodel"], jq, quant=jctx, max_len=16).generate(
            batch, max_new_tokens=8)
    got = ServingEngine(w["model"], pq, quant=pctx, max_len=16,
                        device="cpu").generate(batch, max_new_tokens=8)
    wt = [list(map(int, t)) for t in want.tokens]
    gt = [list(map(int, t)) for t in got.tokens]
    assert gt == wt, first_divergence(wt, gt)
    assert (got.steps, got.host_syncs) == (want.steps, want.host_syncs)
