"""The port's overload machinery (``serve(overcommit=...)``,
``serve(chaos=...)``: preempt-by-page-spill, page growth, admission-driven
preemption) against the reference, on the reduced model of the reference's
own ``tests/test_preemption.py`` (random weights from ``PRNGKey(0)``,
carried into the port by the bridge).

Host side: ``SpillStore``, ``pick_victims``, ``make_chaos`` /
``ChaosSchedule.victims_for``, ``StepWatchdog`` and the scheduler's
overcommit reservations, ``preempt``, ``victim_key`` and
``admission_shortfall``, on seeded operation sequences, equal to the
reference's.  End to end: the reference test's chaos matrix (greedy and
beam 2, FP and INT8 dynamic, fused and unfused, mixed widths, the
``"auto"`` burst, a victim admitted through a prefix-cache hit) and its
overcommit runs: the port's tokens and step, page, prefix and overload
counters equal the reference engine's under the same schedule, its tokens
equal its own unloaded serve's, and every serve ends with every page
reclaimed and every spill restored.
"""

import dataclasses

import numpy as np
import pytest

import jax

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.data import make_corpus as jmake_corpus
from repro.distributed.fault import StepWatchdog as JStepWatchdog
from repro.models import build_model as jbuild_model
from repro.models import kv_cache as jkv

import torch

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy, quantize_model
from repro_torch.distributed import StepWatchdog
from repro_torch.models import EncDecLM
from repro_torch.models import kv_cache as kv
from repro_torch.serving import (
    ChaosSchedule,
    ContinuousScheduler,
    Request,
    ServingEngine,
    SpilledRequest,
    SpillStore,
    make_chaos,
    pick_victims,
)

from _torch_reference import import_reference_serving

MAX_LEN = 32
PAGE_SIZE = 8
BUDGETS = [13, 17, 0, 15, 16, 12]
REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=2, d_ff=96,
               n_heads=2, n_kv_heads=2, head_dim=24)
COUNTERS = ("decode_steps", "busy_slot_steps", "prefill_rounds",
            "prefill_dispatches", "encoder_tokens", "page_hwm",
            "pages_in_use", "peak_running", "host_syncs", "reorder_bytes",
            "prefix_cache", "prefix_hits", "prefix_misses", "prefix_inserts",
            "prefix_evictions", "prefix_hit_pages", "prefix_pages_allocated",
            "prefix_chains", "overcommit", "preemptions", "spill_events",
            "restore_events", "spilled_bytes", "rejected", "deadline_misses",
            "free_lwm", "fragmentation")


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
    """The reference test's model, sources and two paged engines a side
    (FP and INT8 dynamic), kept across tests so each compiles once."""
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
        kw = dict(max_len=MAX_LEN, paged=True, page_size=PAGE_SIZE)
        _CACHED.update(
            jmodel=jmodel, jparams=jparams, model=model, fp=fp,
            engines={
                ("ref", "fp"): jserving.ServingEngine(jmodel, jparams, **kw),
                ("ref", "int8"): jserving.ServingEngine(jmodel, jq,
                                                        quant=jctx, **kw),
                ("port", "fp"): ServingEngine(model, fp, device="cpu",
                                              **kw),
                ("port", "int8"): ServingEngine(model, q, quant=ctx,
                                                device="cpu", **kw)},
            srcs=[np.asarray(r.src, np.int32) for r in jmake_corpus(
                len(BUDGETS), jcfg.vocab, seed=11, max_words=8)])
    return _CACHED


def _fresh_engine(side, **kw):
    """A new FP paged engine (its own pool size or prefix cache)."""
    s = _module_state()
    kw = dict(kw, max_len=MAX_LEN, paged=True, page_size=PAGE_SIZE)
    if side == "ref":
        return import_reference_serving().ServingEngine(
            s["jmodel"], s["jparams"], **kw)
    return ServingEngine(s["model"], s["fp"], device="cpu", **kw)


def _outcome(res):
    return ([list(map(int, r.tokens)) for r in res.requests],
            [r.score for r in res.requests],
            {c: getattr(res, c) for c in COUNTERS})


def _assert_reclaimed(res):
    assert res.pages_in_use == 0
    assert res.spill_events == res.restore_events   # the store drained


def _assert_same(got, want):
    """Port against reference: tokens, counters, scores to 1e-4."""
    (gt, gs, gc), (wt, ws, wc) = _outcome(got), _outcome(want)
    assert gt == wt
    assert gc == wc
    assert [s is None for s in gs] == [s is None for s in ws]
    np.testing.assert_allclose([s for s in gs if s is not None],
                               [s for s in ws if s is not None],
                               rtol=1e-4, atol=1e-6)
    _assert_reclaimed(got)


def _assert_identity(base, res):
    """An interrupted serve against the unloaded one: the same tokens; the
    same score bits on beam serves."""
    for a, b in zip(base.requests, res.requests):
        assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)
        assert a.score == b.score


def _both(engines, srcs, **kw):
    """The same serve on the port's engine and the reference's."""
    return (engines[0].serve(srcs, **kw), engines[1].serve(srcs, **kw))


# ---------------------------------------------------------------------------
# the chaos identity matrix
# ---------------------------------------------------------------------------

MATRIX = [
    ("fp", None, True), ("fp", None, False), ("int8", None, True),
    ("fp", 2, True), ("fp", 2, False), ("int8", 2, True),
]


@pytest.mark.parametrize("quant,beam,fused", MATRIX)
def test_chaos_matches_reference(quant, beam, fused):
    s = _module_state()
    eng = [s["engines"][("port", quant)], s["engines"][("ref", quant)]]
    kw = dict(n_slots=4, max_new_tokens=BUDGETS, burst_len=4,
              fused_admission=fused)
    if beam:
        kw["beam"] = beam
    base = eng[0].serve(s["srcs"], **kw)
    got, want = _both(eng, s["srcs"], chaos=make_chaos(
        4, n_rounds=64, preempt_every=1), **kw)
    assert got.preemptions > 0          # the schedule fired
    _assert_same(got, want)
    _assert_identity(base, got)


def test_chaos_mixed_beam_widths_matches_reference():
    s = _module_state()
    eng = [s["engines"][("port", "int8")], s["engines"][("ref", "int8")]]
    kw = dict(n_slots=6, max_new_tokens=BUDGETS, burst_len=4,
              beam=[2, 1, 3, 2, 1, 2])
    base = eng[0].serve(s["srcs"], **kw)
    got, want = _both(eng, s["srcs"], chaos=make_chaos(
        2, n_rounds=64, preempt_every=1), **kw)
    assert got.preemptions > 0
    _assert_same(got, want)
    _assert_identity(base, got)


def test_chaos_auto_burst_matches_reference():
    """``burst_len="auto"`` adapts to wall times, so the reference's steps
    may differ; the tokens and the spill accounting may not."""
    s = _module_state()
    eng = [s["engines"][("port", "int8")], s["engines"][("ref", "int8")]]
    kw = dict(n_slots=4, max_new_tokens=BUDGETS, burst_len="auto")
    base = eng[0].serve(s["srcs"], **kw)
    got, want = _both(eng, s["srcs"], chaos=make_chaos(
        6, n_rounds=64, preempt_every=1), **kw)
    assert got.preemptions > 0
    assert _outcome(got)[0] == _outcome(want)[0]
    _assert_reclaimed(got)
    _assert_identity(base, got)


def test_chaos_preempts_prefix_cache_hit_matches_reference():
    """A victim admitted through a prefix-cache hit spills chain-backed
    cross K/V and restores it bit for bit; its chain reference is dropped
    at the preemption."""
    s = _module_state()
    eng = [_fresh_engine("port"), _fresh_engine("ref")]
    kw = dict(n_slots=4, max_new_tokens=BUDGETS, burst_len=4,
              prefix_cache=True)
    _both(eng, s["srcs"], **kw)                    # cold: inserts chains
    base, _ = _both(eng, s["srcs"], **kw)          # warm: all hits
    assert base.prefix_hits > 0
    got, want = _both(eng, s["srcs"], chaos=make_chaos(
        4, n_rounds=64, preempt_every=1), **kw)
    assert got.prefix_hits > 0 and got.preemptions > 0
    _assert_same(got, want)
    _assert_identity(base, got)
    pc = eng[0]._prefix_cache_obj
    assert pc.allocator.in_use == pc.pages_held   # only the tree's refs


@pytest.mark.parametrize("beam", [None, 2])
def test_overcommit_matches_reference(beam):
    """Overcommit past the worst-case reservation raises concurrency on a
    starved pool, stays token-identical through growth and spills, and
    reclaims everything."""
    s = _module_state()
    eng = [_fresh_engine("port", n_pages=6 * (beam or 1)),
           _fresh_engine("ref", n_pages=6 * (beam or 1))]
    kw = dict(n_slots=4 * (beam or 1), max_new_tokens=BUDGETS, burst_len=4)
    if beam:
        kw["beam"] = beam
    base = eng[0].serve(s["srcs"], **kw)
    got, want = _both(eng, s["srcs"], overcommit=1.5, **kw)
    assert got.peak_running > base.peak_running
    _assert_same(got, want)
    _assert_identity(base, got)


def test_chaos_plus_overcommit_matches_reference():
    """Forced preemptions on an overcommitted pool, unfused."""
    s = _module_state()
    eng = [_fresh_engine("port", n_pages=8), _fresh_engine("ref", n_pages=8)]
    kw = dict(n_slots=4, max_new_tokens=BUDGETS, burst_len=4,
              fused_admission=False)
    base = eng[0].serve(s["srcs"], **kw)
    got, want = _both(eng, s["srcs"], overcommit=1.5, chaos=make_chaos(
        9, n_rounds=64, preempt_every=2), **kw)
    assert got.preemptions > 0
    _assert_same(got, want)
    _assert_identity(base, got)


@pytest.mark.parametrize("fused", [True, False])
def test_beam_chaos_plus_overcommit_matches_reference(fused):
    """Forced preemptions of beam groups on an overcommitted pool: group
    growth, spill and resume with the host search state, fused and
    unfused."""
    s = _module_state()
    eng = [_fresh_engine("port", n_pages=16),
           _fresh_engine("ref", n_pages=16)]
    kw = dict(n_slots=8, max_new_tokens=BUDGETS, burst_len=4, beam=2,
              fused_admission=fused)
    base = eng[0].serve(s["srcs"], **kw)
    got, want = _both(eng, s["srcs"], overcommit=1.5, chaos=make_chaos(
        9, n_rounds=64, preempt_every=2), **kw)
    assert got.preemptions > 0
    _assert_same(got, want)
    _assert_identity(base, got)


def test_expired_deadline_is_shed_as_reference():
    s = _module_state()
    out = []
    for side, Req in (("port", Request),
                      ("ref", import_reference_serving().Request)):
        rs = [Req(req_id=i, src=src, max_new_tokens=6)
              for i, src in enumerate(s["srcs"][:3])]
        rs[1].deadline_s = -1.0        # unmeetable before the start
        out.append(s["engines"][(side, "fp")].serve(rs, n_slots=2,
                                                    burst_len=4))
    got, want = out
    assert [r.status for r in got.requests] == \
        ["finished", "rejected", "finished"]
    assert got.requests[1].reject_reason
    assert got.rejected == 1 and got.deadline_misses >= 1
    _assert_same(got, want)


def test_overload_arg_validation():
    """The reference's ValueErrors; a valid ``prefill_chunk`` runs."""
    s = _module_state()
    eng = s["engines"][("port", "fp")]
    unpaged = ServingEngine(s["model"], s["fp"], max_len=MAX_LEN,
                            device="cpu")
    one = dict(max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.serve(s["srcs"][:1], overcommit=0.5, **one)
    with pytest.raises(ValueError, match="paged"):
        unpaged.serve(s["srcs"][:1], overcommit=1.5, **one)
    with pytest.raises(ValueError, match="paged"):
        unpaged.serve(s["srcs"][:1], chaos=ChaosSchedule(seed=1), **one)
    with pytest.raises(ValueError, match="paged"):
        unpaged.serve(s["srcs"][:1], overcommit=1.5, beam=2, **one)
    with pytest.raises(ValueError):
        eng.serve(s["srcs"][:1], prefill_chunk=0, **one)
    with pytest.raises(ValueError):
        eng.serve(s["srcs"][:1], prefill_chunk=4, fused_admission=False,
                  **one)
    for beam in (None, 2):
        res = eng.serve(s["srcs"][:1], prefill_chunk=4, beam=beam, **one)
        assert res.requests[0].status == "finished"
        assert res.chunked_admissions == int(len(s["srcs"][0]) > 4)


# ---------------------------------------------------------------------------
# host units against the reference
# ---------------------------------------------------------------------------

def _spill(rng, req_id, quantized):
    k = rng.integers(-127, 128, (1, 2, 8, 1, 2)).astype(np.int8)
    scale = (rng.random((1, 2, 8, 1)).astype(np.float32)
             if quantized else None)
    return dict(req_id=req_id, n_rows=2, k=k, v=k.copy(), k_scale=scale,
                v_scale=scale, lengths=np.asarray([5, 3], np.int32),
                tokens_row=np.asarray([7, 4], np.int32),
                cross_k=np.zeros((1, 2, 4, 1, 2), np.uint16),
                cross_v=np.zeros((1, 2, 4, 1, 2), np.uint16),
                src_lengths=np.asarray([4, 4], np.int32), n_pages=2)


@pytest.mark.parametrize("quantized", [False, True])
def test_spill_store_equals_reference(quantized):
    """Byte counts (a bfloat16 payload travels as its uint16 bits, the same
    bytes), events, double spills and empty restores."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(quantized)
    stores = SpillStore(), jserving.SpillStore()
    for i in range(3):
        fields = _spill(rng, i, quantized)
        a = SpilledRequest(**fields)
        b = jserving.SpilledRequest(**fields)
        assert a.n_bytes == b.n_bytes > 0
        for st, sp in zip(stores, (a, b)):
            st.put(sp)
            with pytest.raises(ValueError):
                st.put(sp)
    for st in stores:
        assert st.pop(1).req_id == 1 and 1 not in st and len(st) == 2
        with pytest.raises(ValueError):
            st.pop(1)
    got, want = stores
    assert (got.spill_events, got.restore_events, got.spilled_bytes) == (
        want.spill_events, want.restore_events, want.spilled_bytes)


@pytest.mark.parametrize("seed", range(4))
def test_pick_victims_equals_reference(seed):
    """Random running sets (deadlines, priorities, admission steps, pages
    held), needs, exclusions and anti-thrash keys: the same victims in the
    same order and the same coverage flag."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(seed)
    for _ in range(40):
        reqs = []
        for i in range(int(rng.integers(0, 7))):
            r = Request(req_id=i, src=np.arange(2, dtype=np.int32),
                        deadline_s=(None if rng.random() < 0.4
                                    else float(rng.integers(0, 4))),
                        priority=float(rng.integers(0, 2)))
            r.pages = list(range(int(rng.integers(0, 4))))
            r.admitted_step = (None if rng.random() < 0.2
                               else int(rng.integers(0, 5)))
            reqs.append(r)
        sched = ContinuousScheduler(2)
        kw = dict(pages_needed=int(rng.integers(-1, 9)),
                  key_fn=sched.victim_key,
                  pages_held_fn=lambda r: len(r.pages),
                  exclude=[r for r in reqs if rng.random() < 0.2],
                  min_key=(None if rng.random() < 0.5
                           else float(rng.integers(0, 4)) + 1e6 * (
                               rng.random() < 0.3)))
        got = pick_victims(reqs, **kw)
        want = jserving.pick_victims(reqs, **kw)
        assert ([r.req_id for r in got[0]], got[1]) == \
            ([r.req_id for r in want[0]], want[1])


def test_pick_victims_least_urgent_first():
    key_fn = lambda r: r.deadline_s
    held = lambda r: len(r.pages)

    def running(req_id, key, pages, step):
        r = Request(req_id=req_id, src=np.arange(2, dtype=np.int32),
                    deadline_s=key)
        r.pages, r.admitted_step = list(range(pages)), step
        return r

    a, b, c = running(0, 1.0, 2, 0), running(1, 9.0, 2, 1), \
        running(2, 5.0, 2, 2)
    got, covered = pick_victims([a, b, c], pages_needed=3, key_fn=key_fn,
                                pages_held_fn=held)
    assert [r.req_id for r in got] == [1, 2] and covered
    assert pick_victims([a, b], pages_needed=1, key_fn=key_fn,
                        pages_held_fn=held, min_key=9.0) == ([], False)
    got, covered = pick_victims([a, b], pages_needed=99, key_fn=key_fn,
                                pages_held_fn=held)
    assert [r.req_id for r in got] == [1, 0] and not covered


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_chaos_schedule_equals_reference(seed):
    """The same rounds, victims (whatever order the running ids come in)
    and slow seconds as the reference's schedule of the same seed."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(seed)
    for kw in (dict(n_rounds=12, preempt_every=3, victims_per_round=2,
                    slow_every=4, slow_s=1.5),
               dict(n_rounds=256, preempt_every=2),
               dict(n_rounds=64, preempt_every=1)):
        got, want = make_chaos(seed, **kw), jserving.make_chaos(seed, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_preemptions_planned == want.n_preemptions_planned
        for rnd in range(kw["n_rounds"]):
            ids = [int(x) for x in rng.choice(40, int(rng.integers(0, 6)),
                                              replace=False)]
            assert got.victims_for(rnd, ids) == \
                want.victims_for(rnd, ids) == \
                got.victims_for(rnd, ids[::-1])
            assert got.slow_for(rnd) == want.slow_for(rnd)
    with pytest.raises(ValueError):
        make_chaos(0, preempt_every=0)


def test_watchdog_equals_reference():
    """Seeded round times with stragglers: the same flags and straggler
    steps as the reference's watchdog."""
    rng = np.random.default_rng(2)
    got, want = StepWatchdog(threshold=2.0, window=8), \
        JStepWatchdog(threshold=2.0, window=8)
    for dt in np.where(rng.random(60) < 0.1, 1.0, rng.random(60) * 0.2):
        assert got.observe(float(dt)) == want.observe(float(dt))
    assert got.straggler_steps == want.straggler_steps != []
    assert got.durations == want.durations and got.step == want.step


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_preemption_equals_reference(seed):
    """Admits, preemptions (with and without a spill) and releases over an
    overcommitted pool, with deadlines and priorities: the same admissions,
    shortfalls, victim keys, queue order and allocator state as the
    reference's scheduler, every request finished and every page,
    reservation and spill returned."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(seed)
    budgets = rng.integers(0, 11, 12)

    def build(Req, Sched, Alloc):
        alloc = Alloc(12, 4, overcommit_limit=1.5)
        sched = Sched(
            3, allocator=alloc,
            pages_per_request=lambda r: kv.pages_per_row(
                min(r.max_new_tokens, 16), 4),
            initial_pages=lambda r: kv.pages_per_row(
                min(4, max(r.max_new_tokens, 1)), 4))
        reqs = [Req(req_id=i, src=np.arange(1 + i % 3, dtype=np.int32),
                    max_new_tokens=int(m),
                    deadline_s=(None if i % 3 else 100.0 + i),
                    priority=float(i % 2))
                for i, m in enumerate(budgets)]
        sched.submit_many(reqs)
        return sched, reqs, alloc

    (got, greqs, ga), (want, wreqs, wa) = (
        build(Request, ContinuousScheduler, kv.PageAllocator),
        build(jserving.Request, jserving.ContinuousScheduler,
              jkv.PageAllocator))
    state = lambda s, a: (
        sorted((k, r.req_id) for k, r in s.slot_map.items()),
        [r.req_id for r in s._waiting], a.in_use, a.reserved, a.spilled,
        a.free_lwm, a.hwm, s.admission_shortfall())
    for t in range(200):
        if want.all_done:
            break
        assert [r.req_id for r in got.admit(float(t))] == \
            [r.req_id for r in want.admit(float(t))]
        running = sorted(want.slot_map)
        if running and rng.random() < 0.4:
            slot = running[int(rng.integers(len(running)))]
            spilled = rng.random() < 0.5
            for s, a in ((got, ga), (want, wa)):
                victim = s.slot_map[slot]
                assert s.victim_key(victim) == want.victim_key(
                    want.slot_map[slot])
                held = len(victim.pages or [])
                if spilled and victim.pages:
                    victim.spill = object()      # the engine's host copy
                assert s.preempt(victim, float(t)) == slot
                if victim.spill is not None:     # the engine's restore
                    a.unspill(held)
                    victim.spill = None
        for slot in sorted(want.slot_map):
            if rng.random() < 0.6:
                assert got.release(got.slot_map[slot], float(t)) == \
                    want.release(want.slot_map[slot], float(t))
        assert state(got, ga) == state(want, wa)
    assert got.all_done and want.all_done
    for g, w in zip(greqs, wreqs):
        assert (g.status, g.preemptions, g.pages, g.reserved_pages) == (
            w.status, w.preemptions, w.pages, w.reserved_pages)
    assert ga.in_use == ga.reserved == ga.spilled == 0
