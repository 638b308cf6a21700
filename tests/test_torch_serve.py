"""The port's continuous serving against the reference engine, on the tiny
trained NMT model (``conftest.trained_nmt``), plus its scheduler and its
serving driver.

The trained weights and the reference's KL calibration are carried into the
port (``checkpoint/bridge.py``).  24 requests with skewed budgets (half of
them 0–3 tokens, half 10–16) go through 6 decode slots, for FP and INT8
static × contiguous and paged cache × fused and unfused admission × burst
lengths 1 and 8, and through a tight page pool; with INT4 weights (the
reference's own, carried across with their group size) over the
contiguous and the paged cache.  The port's tokens must be the
reference's, and so must its step, round, encoder-token, page and
host-sync counters.
"""

import numpy as np
import pytest

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.core import FP_CONTEXT as JFP_CONTEXT
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.models import kv_cache as jkv

import torch

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
    quantize_model,
)
from repro_torch.data import make_corpus
from repro_torch.launch import serve as serve_driver
from repro_torch.models import EncDecLM
from repro_torch.models import kv_cache as kv
from repro_torch.serving import (
    ContinuousScheduler,
    Request,
    ServingEngine,
    make_chaos,
)

from _torch_reference import import_reference_serving, reference_calibration

N_REQ = 24
N_SLOTS = 6
MAX_LEN = 32
PAGE = 4
TIGHT_POOL = 10           # pages; contiguous-equivalent is 6 × 8 = 48
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)
COUNTERS = ("decode_steps", "busy_slot_steps", "prefill_rounds",
            "prefill_dispatches", "encoder_tokens", "page_hwm",
            "pages_in_use", "peak_running", "host_syncs")


def _budgets():
    rng = np.random.default_rng(12)
    short = rng.integers(0, 4, N_REQ)
    long = rng.integers(10, 17, N_REQ)
    return [int(b) for b in np.where(rng.random(N_REQ) < 0.5, short, long)]


@pytest.fixture(scope="module")
def served(trained_nmt):
    """``served(side, mode, paged, fused, burst, n_pages)`` → (tokens per
    request, counters), computed once per key; one engine per side, mode
    and cache."""
    _, jmodel, jparams, corpus, _ = trained_nmt
    jcalibs = reference_calibration(jmodel, jparams, corpus)
    ref_params = {
        "fp": (jparams, JFP_CONTEXT),
        "int8_static": jquantize_model(jparams, jcalibs,
                                       JQuantPolicy(act_quant="static")),
        "int4_static": jquantize_model(jparams, jcalibs,
                                       JQuantPolicy(act_quant="static"),
                                       weight_bits=4)}
    model = EncDecLM(get_config("transformer-base").reduced(**NMT),
                     device="cpu")
    fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    calibs = calibrations_from_reference(jcalibs)
    jq4 = ref_params["int4_static"][0]
    port_params = {
        "fp": (fp, FP_CONTEXT),
        "int8_static": quantize_model(
            fp, calibs, QuantPolicy(act_quant="static"), device="cpu"),
        "int4_static": (
            params_from_flat(_flatten_with_paths(jq4), device="cpu",
                             block_meta=block_meta_of(jq4)),
            QuantContext(policy=QuantPolicy(act_quant="static"),
                         calibrations=dict(calibs)))}
    requests = corpus[:N_REQ]
    budgets = _budgets()
    engines, done = {}, {}

    def run(side, mode, paged, fused, burst, n_pages=None, **serve_kw):
        """``serve_kw``: more ``serve`` keywords; a run with any gets an
        engine of its own (the admission bucket is kept per engine)."""
        kw_key = tuple(sorted(serve_kw.items()))
        key = (side, mode, paged, fused, burst, n_pages, kw_key)
        if key in done:
            return done[key]
        ekey = (side, mode, paged, n_pages, kw_key)
        if ekey not in engines:
            kw = dict(max_len=MAX_LEN, paged=paged, page_size=PAGE,
                      n_pages=n_pages)
            if side == "ref":
                params, ctx = ref_params[mode]
                engines[ekey] = import_reference_serving().ServingEngine(
                    jmodel, params, quant=ctx, **kw)
            else:
                params, ctx = port_params[mode]
                engines[ekey] = ServingEngine(model, params, quant=ctx,
                                              device="cpu", **kw)
        res = engines[ekey].serve(requests, n_slots=N_SLOTS,
                                  max_new_tokens=budgets, burst_len=burst,
                                  fused_admission=fused, **serve_kw)
        done[key] = ([[int(t) for t in res.tokens_for(i)]
                      for i in range(N_REQ)],
                     {c: getattr(res, c) for c in COUNTERS})
        return done[key]

    return run


@pytest.mark.parametrize("burst", [1, 8])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", ["fp", "int8_static"])
def test_serve_matches_reference_engine(served, mode, paged, fused, burst):
    got_tokens, got = served("port", mode, paged, fused, burst)
    want_tokens, want = served("ref", mode, paged, fused, burst)
    diverged = [i for i, (a, b) in enumerate(zip(got_tokens, want_tokens))
                if a != b]
    assert not diverged, (f"{len(diverged)}/{N_REQ} requests differ, first "
                          f"{diverged[0]}: {got_tokens[diverged[0]]} vs "
                          f"{want_tokens[diverged[0]]}")
    assert got == want
    assert got["pages_in_use"] == 0
    if paged:
        assert 0 < got["page_hwm"] <= N_SLOTS * MAX_LEN // PAGE


@pytest.mark.parametrize("paged", [False, True])
def test_int4_serve_matches_reference_engine(served, paged):
    """INT4 weights with static activation scales, fused admission, burst
    8: the reference's tokens and counters, contiguous and paged."""
    got_tokens, got = served("port", "int4_static", paged, True, 8)
    want_tokens, want = served("ref", "int4_static", paged, True, 8)
    assert got_tokens == want_tokens
    assert got == want
    assert got["pages_in_use"] == 0


@pytest.mark.parametrize("fused", [True, False])
def test_tight_page_pool_matches_reference_engine(served, fused):
    """A pool of 10 pages paces admission by pages, not slots: fewer rows
    run at once, and the tokens stay the same."""
    got_tokens, got = served("port", "int8_static", True, fused, 8,
                             TIGHT_POOL)
    want_tokens, want = served("ref", "int8_static", True, fused, 8,
                               TIGHT_POOL)
    assert got_tokens == want_tokens
    assert got == want
    assert got["page_hwm"] <= TIGHT_POOL
    _, roomy = served("port", "int8_static", True, fused, 8)
    assert got["peak_running"] < roomy["peak_running"]
    assert got_tokens == served("port", "int8_static", False, fused, 8)[0]


# admission keywords the reference's serve takes: a source-token budget per
# round, hysteresis (wait for 3 free slots) and enc_len padded to 16
ADMISSION_KW = dict(prefill_token_budget=20, admit_min_free=3,
                    pad_to_multiple=16)


@pytest.mark.parametrize("paged,fused", [(False, True), (True, False)])
def test_admission_keywords_match_reference_engine(served, paged, fused):
    """``prefill_token_budget``, ``admit_min_free`` and ``pad_to_multiple``
    behave as the reference's: the same tokens, decode steps, host syncs,
    admission rounds and encoder tokens; and they change the admission
    (the budget splits rounds: more of them than with the defaults).""" 
    got_tokens, got = served("port", "int8_static", paged, fused, 8,
                             **ADMISSION_KW)
    want_tokens, want = served("ref", "int8_static", paged, fused, 8,
                               **ADMISSION_KW)
    assert got_tokens == want_tokens
    assert got == want
    _, default = served("port", "int8_static", paged, fused, 8)
    assert got["prefill_rounds"] > default["prefill_rounds"]
    assert got_tokens == served("port", "int8_static", paged, fused, 8)[0]


def test_paged_and_contiguous_serve_agree(served):
    """Every port configuration gives the same tokens (greedy decode is
    batch-independent, the paged view has the contiguous shape)."""
    base = served("port", "int8_static", False, True, 8)[0]
    for paged in (False, True):
        for fused in (True, False):
            for burst in (1, 8):
                assert served("port", "int8_static", paged, fused,
                              burst)[0] == base


# ---------------------------------------------------------------------------
# ContinuousScheduler: the same plans as the reference's
# ---------------------------------------------------------------------------

def _plan_key(plan):
    return ([r.req_id for r in plan.requests], [r.slot for r in plan.requests],
            [r.req_id for r in plan.released], plan.src_tokens.tolist(),
            plan.src_lengths.tolist(), plan.base_rows.tolist(), plan.width)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_plans_equal_reference(paged, seed):
    """Admission rounds (fused plans and unfused admits, alternating) with a
    prefill token budget, deadlines, priorities and zero budgets, over a
    page pool when ``paged``: the same requests in the same slots, the same
    padded arrays, the same shed requests and allocator state."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(seed)
    corpus = make_corpus(30, 40, max_words=8, seed=seed)
    budgets = rng.integers(0, 20, 30)
    deadlines = np.where(rng.random(30) < 0.3, rng.random(30) * 8, np.nan)
    prio = np.where(rng.random(30) < 0.2, 1.0, 0.0)

    def build(Req, Sched, Alloc):
        reqs = [Req(req_id=i, src=s.src, max_new_tokens=int(b),
                    deadline_s=None if np.isnan(d) else float(d),
                    priority=float(p))
                for i, (s, b, d, p) in enumerate(zip(corpus, budgets,
                                                     deadlines, prio))]
        kw = {}
        if paged:
            alloc = Alloc(24, 4)
            kw = dict(allocator=alloc, pages_per_request=lambda r:
                      kv.pages_per_row(min(r.max_new_tokens, 32), 4))
        sched = Sched(5, prefill_token_budget=40, **kw)
        sched.submit_many(reqs)
        return sched, reqs

    got, greqs = build(Request, ContinuousScheduler, kv.PageAllocator)
    want, wreqs = build(jserving.Request, jserving.ContinuousScheduler,
                        jkv.PageAllocator)
    for rnd in range(40):
        now = 0.25 * rnd
        if rnd % 2:
            g = got.plan_admission(now, step=rnd, enc_len=24, oob_row=5)
            w = want.plan_admission(now, step=rnd, enc_len=24, oob_row=5)
            assert _plan_key(g) == _plan_key(w)
        else:
            g = [r.req_id for r in got.admit(now, step=rnd)]
            w = [r.req_id for r in want.admit(now, step=rnd)]
            assert g == w
        # finish a seeded choice of the running requests on both sides
        running = sorted(want.slot_map)
        for slot in running:
            if rng.random() < 0.4:
                got.release(got.slot_map[slot], now, step=rnd)
                want.release(want.slot_map[slot], now, step=rnd)
        assert sorted(got.slot_map) == sorted(want.slot_map)
        assert [r.req_id for r in got.rejected] == \
            [r.req_id for r in want.rejected]
        assert (got.n_free, got.n_running, got.n_waiting, got.all_done) == (
            want.n_free, want.n_running, want.n_waiting, want.all_done)
        if paged:
            assert (got.allocator.in_use, got.allocator.hwm,
                    got.allocator.reserved) == (
                want.allocator.in_use, want.allocator.hwm,
                want.allocator.reserved)
    for g, w in zip(greqs, wreqs):
        assert (g.status, g.slot, g.pages, g.admitted_step, g.finish_step,
                g.reject_reason) == (w.status, w.slot, w.pages,
                                     w.admitted_step, w.finish_step,
                                     w.reject_reason)


def test_pack_batches_token_budget_equals_reference():
    from repro.data import pack_batches_token_budget as jpack
    from repro.data import padding_stats as jstats
    from repro_torch.data import pack_batches_token_budget, padding_stats
    corpus = make_corpus(50, 100, seed=4)
    for budget, rows in ((64, None), (128, 3), (10, None)):
        got = pack_batches_token_budget(corpus, budget, max_rows=rows)
        assert got == jpack(corpus, budget, max_rows=rows)
        assert padding_stats(corpus, got) == jstats(corpus, got)


# ---------------------------------------------------------------------------
# the options of later slices run; the driver runs in both modes on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(prefill_chunk=8),
                                dict(speculative_k=2),
                                dict(beam=2, prefill_chunk=8)])
def test_later_slice_serve_options_run(kw):
    """Chunked prefill and speculative decoding, once refused, run and give
    the tokens of the unchunked, non-speculative serve.  (They are held to
    the reference in ``test_torch_chunked_prefill.py`` and
    ``test_torch_speculative.py``.)"""
    model = EncDecLM(get_config("transformer-base").reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServingEngine(model, params, max_len=16, device="cpu")
    srcs = [np.arange(3, 15), np.arange(4, 10), np.arange(5, 16),
            np.arange(3, 8)]
    serve_kw = dict(n_slots=2 * kw.get("beam", 1), max_new_tokens=6,
                    burst_len=2, beam=kw.get("beam"))
    base = engine.serve(srcs, **serve_kw)
    res = engine.serve(srcs, **dict(serve_kw, **kw))
    assert [r.tokens for r in res.requests] == \
        [r.tokens for r in base.requests]
    if "prefill_chunk" in kw:
        # the two sources longer than 8 tokens stage, one layer a round
        assert res.chunked_admissions == 2
        assert res.chunk_rounds == 2 * model.cfg.n_enc_layers
    else:
        assert res.speculative_k == 2 and res.draft_tokens > 0


@pytest.mark.parametrize("kw", [dict(beam=2, overcommit=1.5),
                                dict(prefix_cache=True),
                                dict(overcommit=1.5),
                                dict(chaos=True)])
def test_prefix_and_overload_options_run(kw):
    """The options that used to be refused run on a tight paged pool, give
    the unloaded serve's tokens and reclaim every page and spill.  (They
    are held to the reference in ``test_torch_prefix_cache.py`` and
    ``test_torch_preemption.py``.)"""
    model = EncDecLM(get_config("transformer-base").reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServingEngine(model, params, max_len=16, paged=True,
                           page_size=4, n_pages=4 * kw.get("beam", 1),
                           device="cpu")
    srcs = [np.arange(3, 8), np.arange(4, 10), np.arange(3, 8),
            np.arange(5, 9)]
    serve_kw = dict(n_slots=2 * kw.get("beam", 1), max_new_tokens=12,
                    burst_len=2, beam=kw.get("beam"))
    base = engine.serve(srcs, **serve_kw)
    if kw.get("chaos"):
        kw = dict(chaos=make_chaos(3, n_rounds=64, preempt_every=1))
    res = engine.serve(srcs, **dict(serve_kw, **kw))
    assert all(r.status == "finished" for r in res.requests)
    assert [r.tokens for r in res.requests] == \
        [r.tokens for r in base.requests]
    assert res.pages_in_use == 0
    assert res.spill_events == res.restore_events
    if "prefix_cache" in kw:
        assert res.prefix_hits == 1 and res.prefix_misses == 3
    if "chaos" in kw:
        assert res.preemptions > 0
    if "overcommit" in kw:
        # one request's worst case fills the pool: only overcommit runs two
        assert res.overcommit == 1.5 and res.preemptions > 0
        assert res.peak_running > base.peak_running == 1


def test_generate_and_serve_speculative_run():
    """``generate`` and ``serve`` with ``speculative_k=2`` run and give the
    plain tokens (``alpha`` is accepted); a negative ``speculative_k``
    raises, as in the reference."""
    model = EncDecLM(get_config("transformer-base").reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServingEngine(model, params, max_len=16, device="cpu")
    batch = {"src_tokens": np.ones((1, 4), np.int32),
             "src_lengths": np.array([4], np.int32)}
    base = engine.generate(batch, max_new_tokens=8)
    res = engine.generate(batch, max_new_tokens=8, speculative_k=2)
    assert [t.tolist() for t in res.tokens] == \
        [t.tolist() for t in base.tokens]
    assert res.speculative_k == 2
    assert 0 <= res.accepted_tokens <= res.draft_tokens
    plain = engine.serve([np.arange(3, 8)], max_new_tokens=8, alpha=0.8)
    spec = engine.serve([np.arange(3, 8)], max_new_tokens=8,
                        speculative_k=2, alpha=0.8)
    assert spec.requests[0].tokens == plain.requests[0].tokens
    with pytest.raises(ValueError, match="speculative_k"):
        engine.generate(batch, speculative_k=-1)
    with pytest.raises(ValueError, match="speculative_k"):
        engine.serve([np.arange(3, 8)], speculative_k=-1)


@pytest.mark.parametrize("argv", [
    ["--mode", "continuous", "--paged", "--requests", "10", "--slots", "3",
     "--max-new-tokens", "6", "--page-size", "8", "--n-pages", "20"],
    ["--mode", "continuous", "--unfused-admission", "--requests", "8",
     "--slots", "3", "--max-new-tokens", "5", "--quant", "none",
     "--burst-len", "2", "--deadline-ms", "60000"],
    ["--mode", "static", "--streams", "2", "--requests", "10",
     "--batch-size", "4", "--max-new-tokens", "5", "--quant", "none"],
    ["--mode", "static", "--streams", "1", "--requests", "4", "--beam", "2",
     "--max-new-tokens", "4", "--quant", "none"],
    ["--weight-bits", "4", "--mode", "continuous", "--paged", "--requests",
     "6", "--slots", "3", "--max-new-tokens", "4", "--weight-group-size",
     "64"],
    ["--mode", "continuous", "--prefix-cache", "--prefix-pages", "32",
     "--requests", "6", "--slots", "3", "--max-new-tokens", "4"],
    ["--mode", "continuous", "--paged", "--overcommit", "1.5",
     "--chaos-seed", "3", "--n-pages", "4", "--requests", "6", "--slots",
     "3", "--max-new-tokens", "20", "--burst-len", "4"],
])
def test_serve_driver_runs_on_cpu(argv, capsys):
    serve_driver.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    n = argv[argv.index("--requests") + 1]
    assert f"served {n} requests" in out
    if "--paged" in argv:
        assert "0 leaked" in out
    if "--weight-bits" in argv:
        # the reduced transformer-base: 2 decoder layers × 4 INT4 linears
        assert "INT4 weights: 8 decoder linears" in out
        assert "(group_size=64)" in out
    if "--prefix-cache" in argv:
        assert "prefix cache: 0 hits / 6 admissions" in out
    if "--chaos-seed" in argv:
        assert "overload: overcommit=1.5" in out
        assert " 0 preemptions" not in out


@pytest.mark.parametrize("flag", [["--mode", "continuous",
                                   "--prefill-chunk", "8"],
                                  ["--mode", "continuous", "--mesh", "1,2",
                                   "--quant", "none"],
                                  ["--mode", "continuous", "--beam", "4",
                                   "--prefill-chunk", "8"],
                                  ["--mode", "continuous", "--replicas", "2"]])
def test_serve_driver_flags_run_or_refuse(flag, capfd):
    """``--mesh 1,2`` serves on two gloo ranks (rank 0 prints),
    ``--replicas 2`` through the router; ``--prefill-chunk``, once refused,
    runs and reports its staged admissions."""
    serve_driver.main(["--device", "cpu", *flag, "--requests", "6",
                       "--slots", "4", "--max-new-tokens", "4"])
    out = capfd.readouterr().out
    if "--replicas" in flag:
        assert "router x2: 6 requests" in out
        assert "assignment counts [3, 3]" in out
        return
    assert "served 6 requests" in out
    if "--mesh" in flag:
        assert "2 ranks over gloo" in out
        assert "tensor-parallel: mesh (1, 2) (tp=2)" in out
        assert out.count("served 6 requests") == 1      # rank 0 prints
        return
    line = next(x for x in out.splitlines() if "chunked admissions" in x)
    n = int(line.split()[0])
    assert n > 0 and f"({n * 2} staged encoder rounds)" in line
