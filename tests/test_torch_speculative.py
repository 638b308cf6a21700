"""The port's self-speculative decoding (``generate/serve(speculative_k=k)``,
``ServingEngine(draft_quant=...)``) against the reference, on the reduced
model of the reference's own ``tests/test_speculative.py`` (random weights
from ``PRNGKey(0)``, carried into the port by the bridge).

The contract is lossless verification: the tokens equal plain greedy
decode's for every ``speculative_k`` × ``burst_len`` (fixed and ``"auto"``)
× fused/unfused × FP/INT8-paged cell, and the reference's.  Besides: the
accept rule against the reference's ``_spec_accept`` and that file's
pure-Python oracle (a hypothesis property), the draft, accept, step and
host-sync counters against the reference's speculative serve and
``generate``, a distinct draft context (static ``default_amax=4.0`` draft
under a dynamic verifier), an EOS inside an accepted window, page reclaim
after rollback, chaos × overcommit, and speculation with chunked prefill
under chaos against the reference engine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.core.ptq import QuantContext as JQuantContext
from repro.data import make_corpus as jmake_corpus
from repro.models import build_model as jbuild_model

import torch

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy, quantize_model
from repro_torch.core.ptq import QuantContext
from repro_torch.data.synthetic import pad_batch
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.serving import ServingEngine, make_chaos
from repro_torch.serving.engine import _spec_accept

from _torch_reference import import_reference_serving

MAX_LEN = 32
PAGE_SIZE = 8
BUDGETS = [3, 7, 0, 5, 7, 2, 6, 4, 7, 3]
SPEC_KS = [1, 2, 4]
BURST_LENS = [2, 64, "auto"]
REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=1, d_ff=96,
               n_heads=2, n_kv_heads=2, head_dim=24)
COUNTERS = ("decode_steps", "busy_slot_steps", "host_syncs", "draft_tokens",
            "accepted_tokens", "prefill_rounds", "prefill_dispatches",
            "encoder_tokens", "page_hwm", "pages_in_use")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small eager ops: one intra-op thread keeps this file
    from crowding the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_CACHED = {}


def _module_state():
    """The reference test's model, sources and engines ("fp" contiguous,
    "int8_paged" INT8 dynamic on the paged cache), one a side."""
    if "engines" not in _CACHED:
        jserving = import_reference_serving()
        jcfg = jget_config("transformer-base").reduced(**REDUCED)
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jq, jctx = jquantize_model(jparams, {},
                                   JQuantPolicy(act_quant="dynamic"))
        model = EncDecLM(get_config("transformer-base").reduced(**REDUCED),
                         device="cpu")
        fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        q, ctx = quantize_model(fp, {}, QuantPolicy(act_quant="dynamic"),
                                device="cpu")
        paged = dict(paged=True, page_size=PAGE_SIZE)
        _CACHED.update(
            jmodel=jmodel, jparams=jparams, jq=jq, jctx=jctx, model=model,
            fp=fp, q=q, ctx=ctx,
            engines={
                ("ref", "fp"): jserving.ServingEngine(jmodel, jparams,
                                                      max_len=MAX_LEN),
                ("ref", "int8_paged"): jserving.ServingEngine(
                    jmodel, jq, quant=jctx, max_len=MAX_LEN, **paged),
                ("port", "fp"): ServingEngine(model, fp, max_len=MAX_LEN,
                                              device="cpu"),
                ("port", "int8_paged"): ServingEngine(
                    model, q, quant=ctx, max_len=MAX_LEN, device="cpu",
                    **paged)},
            srcs=[np.asarray(r.src, np.int32) for r in jmake_corpus(
                len(BUDGETS), jcfg.vocab, seed=11, max_words=8)])
    return _CACHED


def _tokens(res):
    return [list(map(int, r.tokens)) for r in res.requests]


def _plain(side, quant):
    """The plain (non-speculative) serve's tokens, once per module."""
    key = ("plain", side, quant)
    if key not in _CACHED:
        s = _module_state()
        _CACHED[key] = _tokens(s["engines"][(side, quant)].serve(
            s["srcs"], n_slots=4, max_new_tokens=BUDGETS))
    return _CACHED[key]


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------

def _ref_accept(d_row, v_row, remaining, eos):
    """The reference test's pure-Python oracle for one row."""
    s = len(d_row)
    a = 0
    while a < s and d_row[a] == v_row[a]:
        a += 1
    cand = a + 1
    eos_first = next((i for i, t in enumerate(v_row) if t == eos), s + 1)
    stop = min(cand, eos_first + 1, remaining) if remaining > 0 else 0
    hit_eos = remaining > 0 and (eos_first + 1) <= min(cand, remaining)
    return stop, hit_eos, min(a, stop)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_spec_accept_matches_reference(s):
    """On seeded batches with many agreements, EOS and small budgets."""
    jaccept = import_reference_serving().engine._spec_accept
    rng = np.random.default_rng(s)
    B = 64
    v = rng.integers(0, 4, size=(B, s + 1)).astype(np.int32)
    d = np.where(rng.random((B, s)) < 0.7, v[:, :s],
                 rng.integers(0, 4, size=(B, s))).astype(np.int32)
    rem = rng.integers(0, s + 3, size=B).astype(np.int32)
    got = _spec_accept(*map(torch.from_numpy, (d, v, rem)), 2)
    want = jaccept(*map(jnp.asarray, (d, v, rem)), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=5),
                min_size=2, max_size=10),
       st.integers(min_value=0, max_value=12),
       st.integers(min_value=0, max_value=5))
def test_accept_rule_longest_agreeing_prefix(seq, remaining, eos):
    """The reference's property: the accepted prefix is the longest
    agreeing one, clamped by budget and EOS."""
    s = len(seq) - 1
    d_row = seq[:s]
    v_row = (list(seq[1:]) + [seq[0]]) if remaining % 2 \
        else list(d_row) + [seq[0]]
    stop, hit_eos, acc = _spec_accept(
        torch.tensor([d_row], dtype=torch.int32),
        torch.tensor([v_row], dtype=torch.int32),
        torch.tensor([remaining], dtype=torch.int32), eos)
    got = (int(stop[0]), bool(hit_eos[0]), int(acc[0]))
    assert got == _ref_accept(d_row, v_row, remaining, eos)
    if remaining > 0:
        assert 1 <= got[0] <= min(s + 1, remaining)
    else:
        assert got == (0, False, 0)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["fp", "int8_paged"])
def test_generate_speculative_matches_plain_and_reference(quant):
    """``generate(speculative_k=k)``: the plain tokens, and the reference's
    tokens, steps, host syncs and draft/accept counts."""
    s = _module_state()
    port, ref = s["engines"][("port", quant)], s["engines"][("ref", quant)]
    # the random model ends most sources at once: rows 2-5 hold one that
    # runs its whole budget
    src, lens = pad_batch(s["srcs"][2:6])
    batch = {"src_tokens": src, "src_lengths": lens}
    base = port.generate(batch, max_new_tokens=9)
    assert max(len(t) for t in base.tokens) == 9
    for k in SPEC_KS:
        got = port.generate(batch, max_new_tokens=9, speculative_k=k)
        want = ref.generate(batch, max_new_tokens=9, speculative_k=k)
        assert [t.tolist() for t in got.tokens] == \
            [t.tolist() for t in base.tokens]
        assert [t.tolist() for t in got.tokens] == \
            [np.asarray(t).tolist() for t in want.tokens]
        assert (got.steps, got.host_syncs, got.draft_tokens,
                got.accepted_tokens) == (want.steps, want.host_syncs,
                                         want.draft_tokens,
                                         want.accepted_tokens)
        assert got.speculative_k == k
        assert 0.0 < got.acceptance_rate <= 1.0


def test_speculation_needs_decode_step_multi():
    """The decoder-only family has no multi-position verify: the
    reference's ValueError."""
    model = DecoderLM(get_config("granite-moe-1b-a400m").reduced(),
                      device="cpu")
    eng = ServingEngine(model, {}, max_len=16, device="cpu")
    batch = {"tokens": np.ones((1, 4), np.int32),
             "lengths": np.array([4], np.int32)}
    with pytest.raises(ValueError, match="decode_step_multi"):
        eng.generate(batch, speculative_k=2)


def test_speculative_rejects_beam_and_bad_k():
    s = _module_state()
    eng = s["engines"][("port", "fp")]
    with pytest.raises(ValueError):
        eng.serve(s["srcs"][:2], n_slots=4, max_new_tokens=4, beam=2,
                  speculative_k=2)
    with pytest.raises(ValueError):
        eng.serve(s["srcs"][:2], n_slots=4, max_new_tokens=4,
                  speculative_k=-1)
    with pytest.raises(ValueError):
        eng.generate({"src_tokens": np.zeros((1, 4), np.int32),
                      "src_lengths": np.asarray([4], np.int32)},
                     speculative_k=-3)


# ---------------------------------------------------------------------------
# serve: the identity matrix, and the counters against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["fp", "int8_paged"])
@pytest.mark.parametrize("fused", [True, False])
def test_serve_speculative_identity_matrix(quant, fused):
    """Every k × burst cell gives the port's and the reference's plain
    tokens; the reference's speculative serve (one k a cell: each compiles
    a loop) gives the port's counters."""
    s = _module_state()
    eng = s["engines"][("port", quant)]
    plain = _plain("port", quant)
    assert plain == _plain("ref", quant)
    for k in SPEC_KS:
        for bl in BURST_LENS:
            res = eng.serve(s["srcs"], n_slots=4, max_new_tokens=BUDGETS,
                            burst_len=bl, fused_admission=fused,
                            speculative_k=k)
            assert _tokens(res) == plain, (k, bl)
            assert res.speculative_k == k and res.draft_tokens > 0
            assert 0 <= res.accepted_tokens <= res.draft_tokens
            assert res.metrics()["acceptance_rate"] == res.acceptance_rate
    k = 2 if fused else 4
    kw = dict(n_slots=4, max_new_tokens=BUDGETS, burst_len=2,
              fused_admission=fused, speculative_k=k)
    got = eng.serve(s["srcs"], **kw)
    want = s["engines"][("ref", quant)].serve(s["srcs"], **kw)
    assert _tokens(got) == _tokens(want)
    assert {c: getattr(got, c) for c in COUNTERS} == \
        {c: getattr(want, c) for c in COUNTERS}


def test_speculative_distinct_draft_context_matches_reference():
    """A crude static draft context (``default_amax=4.0``) under the
    dynamic INT8 verifier lowers acceptance, never a token; its draft and
    accept counts are the reference's."""
    s = _module_state()
    jserving = import_reference_serving()
    kw = dict(max_len=MAX_LEN, paged=True, page_size=PAGE_SIZE)
    port = ServingEngine(s["model"], s["q"], quant=s["ctx"], device="cpu",
                         draft_quant=QuantContext(policy=QuantPolicy(
                             act_quant="static", default_amax=4.0)), **kw)
    ref = jserving.ServingEngine(
        s["jmodel"], s["jq"], quant=s["jctx"],
        draft_quant=JQuantContext(policy=JQuantPolicy(
            act_quant="static", default_amax=4.0)), **kw)
    skw = dict(n_slots=4, max_new_tokens=BUDGETS, speculative_k=3)
    got, want = port.serve(s["srcs"], **skw), ref.serve(s["srcs"], **skw)
    assert _tokens(got) == _plain("port", "int8_paged")
    assert _tokens(got) == _tokens(want)
    assert (got.draft_tokens, got.accepted_tokens) == \
        (want.draft_tokens, want.accepted_tokens)
    assert got.acceptance_rate < 1.0


@pytest.mark.parametrize("quant", ["fp", "int8_paged"])
def test_speculative_eos_inside_accepted_window(quant):
    """The reference's test: an EOS the verifier emits inside an accepted
    window ends the row where sequential decode would (a frequent token
    made the EOS; the real EOS, which ends most rows of this random model
    at once, becomes an ordinary token, so the rows run long)."""
    s = _module_state()
    emitted = [t for r in _plain("port", "fp") for t in r]
    fake_eos = int(np.bincount(emitted).argmax())
    params, kw = ((s["fp"], {}) if quant == "fp" else
                  (s["q"], dict(quant=s["ctx"], paged=True,
                                page_size=PAGE_SIZE)))
    eng = ServingEngine(s["model"], params, max_len=MAX_LEN,
                        eos_id=fake_eos, device="cpu", **kw)
    base = eng.serve(s["srcs"], n_slots=4, max_new_tokens=BUDGETS)
    assert any(len(r.tokens) < r.max_new_tokens for r in base.requests)
    assert sum(len(r.tokens) for r in base.requests) > 10
    for k in (2, 4):
        res = eng.serve(s["srcs"], n_slots=4, max_new_tokens=BUDGETS,
                        speculative_k=k, burst_len=64)
        assert _tokens(res) == _tokens(base), k


def test_speculative_rollback_full_reclaim():
    """Rejected positions only touch KV past the accepted cursor: every
    page comes back and the high-water mark is the plain serve's."""
    s = _module_state()
    eng = s["engines"][("port", "int8_paged")]
    base = eng.serve(s["srcs"], n_slots=4, max_new_tokens=BUDGETS)
    res = eng.serve(s["srcs"], n_slots=4, max_new_tokens=BUDGETS,
                    speculative_k=4)
    assert res.pages_in_use == 0
    assert res.page_hwm == base.page_hwm
    assert _tokens(res) == _tokens(base)


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_chaos_identity(k):
    """The reference's test: forced preemption on an overcommitted pool
    (growth scaled by k + 1): the unloaded plain tokens, every page and
    spill reclaimed."""
    s = _module_state()
    eng = s["engines"][("port", "int8_paged")]
    budgets = [13, 17, 0, 15, 16, 12, 14, 13, 17, 15]
    base = eng.serve(s["srcs"], n_slots=4, max_new_tokens=budgets)
    res = eng.serve(s["srcs"], n_slots=4, max_new_tokens=budgets,
                    speculative_k=k, overcommit=1.5, burst_len=1,
                    chaos=make_chaos(4, n_rounds=64, preempt_every=1))
    assert res.preemptions > 0
    assert _tokens(res) == _tokens(base)
    assert res.pages_in_use == 0
    assert res.spill_events == res.restore_events


def test_speculative_chunked_chaos_matches_reference():
    """Speculation, chunked prefill and chaos at once: a staged slot rides
    the speculative bursts at budget 0; tokens and counters equal the
    reference engine's, tokens the plain serve's."""
    s = _module_state()
    port = s["engines"][("port", "int8_paged")]
    ref = s["engines"][("ref", "int8_paged")]
    kw = dict(n_slots=4, max_new_tokens=BUDGETS, burst_len=2,
              speculative_k=2, prefill_chunk=4)
    got, want = (e.serve(s["srcs"], chaos=make_chaos(
        3, n_rounds=64, preempt_every=1), **kw) for e in (port, ref))
    assert got.chunked_admissions > 0 and got.preemptions > 0
    assert _tokens(got) == _tokens(want) == _plain("port", "int8_paged")
    more = ("chunked_admissions", "chunk_rounds", "preemptions",
            "spill_events", "restore_events")
    assert {c: getattr(got, c) for c in COUNTERS + more} == \
        {c: getattr(want, c) for c in COUNTERS + more}
    assert got.pages_in_use == 0
