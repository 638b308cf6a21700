"""The port's chunked prefill (``serve(prefill_chunk=...)``) against the
reference, on the reduced model of the reference's own
``tests/test_preemption.py`` (random weights from ``PRNGKey(0)``, carried
into the port by the bridge; its ``long_srcs`` plus two short sources).

Model: ``encode_staged_begin`` / ``_layer`` / ``_finish`` against ``jax.jit``
of the reference's, stage by stage, and the staged chain against the port's
own monolithic ``encode_cross_kv`` with 0 differing elements.  Scheduler:
``plan_admission``'s staged routing (prefix hits and misses, resumed
requests, zero budgets) against the reference's.  End to end: greedy and
beam (mixed widths), contiguous and paged, fixed and ``"auto"`` bursts, FP
and INT8 dynamic, with the prefix cache, and under chaos and overcommit:
the port's tokens and counters equal the reference engine's, its tokens
equal its own unchunked serve's, and every page and spill is reclaimed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.data import make_corpus as jmake_corpus
from repro.models import build_model as jbuild_model

import torch

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy, quantize_model
from repro_torch.data.synthetic import pad_batch
from repro_torch.models import EncDecLM
from repro_torch.models import kv_cache as kv
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import (
    ContinuousScheduler,
    PrefixCache,
    Request,
    ServingEngine,
    make_chaos,
)

from _torch_reference import import_reference_serving

MAX_LEN = 32
PAGE_SIZE = 8
CHUNK = 6
REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=2, d_ff=96,
               n_heads=2, n_kv_heads=2, head_dim=24)
COUNTERS = ("decode_steps", "busy_slot_steps", "prefill_rounds",
            "prefill_dispatches", "encoder_tokens", "host_syncs",
            "chunked_admissions", "chunk_rounds", "page_hwm",
            "pages_in_use", "peak_running", "reorder_bytes", "prefix_hits",
            "prefix_misses", "prefix_inserts", "prefix_hit_pages",
            "preemptions", "spill_events", "restore_events",
            "spilled_bytes", "free_lwm")
# each stage against jax.jit of the reference's, FP and INT8 dynamic: torch
# and XLA reduce the f32 sums (matmuls, norms, softmax) in other orders
STAGE_ATOL = 1e-5


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
    """The reference test's model and sources, and each side's FP and INT8
    dynamic engines, paged and contiguous, kept across tests."""
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
        engines = {}
        for paged in (True, False):
            kw = dict(max_len=MAX_LEN, paged=paged, page_size=PAGE_SIZE)
            engines.update({
                ("ref", "fp", paged): jserving.ServingEngine(
                    jmodel, jparams, **kw),
                ("ref", "int8", paged): jserving.ServingEngine(
                    jmodel, jq, quant=jctx, **kw),
                ("port", "fp", paged): ServingEngine(
                    model, fp, device="cpu", **kw),
                ("port", "int8", paged): ServingEngine(
                    model, q, quant=ctx, device="cpu", **kw)})
        long_srcs = [np.asarray(r.src, np.int32) for r in jmake_corpus(
            4, jcfg.vocab, seed=7, max_words=14)]
        short = [np.asarray(r.src, np.int32) for r in jmake_corpus(
            6, jcfg.vocab, seed=11, max_words=8)]
        _CACHED.update(
            jmodel=jmodel, model=model, engines=engines,
            params={"fp": (jparams, None, fp, None),
                    "int8": (jq, jctx, q, ctx)},
            srcs=long_srcs + short[:2])
    return _CACHED


def _fresh_engines(**kw):
    """A new FP paged engine a side (its own pool or prefix cache)."""
    s = _module_state()
    jp, _, fp, _ = s["params"]["fp"]
    kw = dict(kw, max_len=MAX_LEN, paged=True, page_size=PAGE_SIZE)
    return (ServingEngine(s["model"], fp, device="cpu", **kw),
            import_reference_serving().ServingEngine(s["jmodel"], jp, **kw))


def _tokens(res):
    return [list(map(int, r.tokens)) for r in res.requests]


def _assert_same(got, want):
    """Port against reference: tokens, counters, beam scores to 1e-4."""
    assert _tokens(got) == _tokens(want)
    assert {c: getattr(got, c) for c in COUNTERS} == \
        {c: getattr(want, c) for c in COUNTERS}
    gs = [r.score for r in got.requests]
    ws = [r.score for r in want.requests]
    assert [x is None for x in gs] == [x is None for x in ws]
    np.testing.assert_allclose([x for x in gs if x is not None],
                               [x for x in ws if x is not None],
                               rtol=1e-4, atol=1e-6)


def _assert_reclaimed(res):
    assert res.pages_in_use == 0
    assert res.spill_events == res.restore_events   # the store drained


# ---------------------------------------------------------------------------
# the staged encode
# ---------------------------------------------------------------------------

def _src_batch(s, width):
    return pad_batch(s["srcs"][:width], length=32)


@pytest.mark.parametrize("quant", ["fp", "int8"])
def test_staged_stages_match_reference(quant):
    """Each stage against ``jax.jit`` of the reference's, fed the same
    input (the reference's previous stage)."""
    s = _module_state()
    jp, jctx, pp, pctx = s["params"][quant]
    jm, pm = s["jmodel"], s["model"]
    jkw = {} if jctx is None else {"quant": jctx}
    pkw = {} if pctx is None else {"quant": pctx}
    src, lens = _src_batch(s, 3)
    tl = torch.from_numpy(lens)
    want = jax.jit(lambda p, t, l: jm.encode_staged_begin(
        p, {"src_tokens": t, "src_lengths": l}))(
            jp, jnp.asarray(src), jnp.asarray(lens))
    got = pm.encode_staged_begin(pp, {"src_tokens": torch.from_numpy(src)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STAGE_ATOL)
    for i in range(pm.cfg.n_enc_layers):
        x = np.asarray(want)
        want = jax.jit(lambda p, x, l, i=i: jm.encode_staged_layer(
            p, x, i, src_lengths=l, **jkw))(jp, jnp.asarray(x),
                                            jnp.asarray(lens))
        got = pm.encode_staged_layer(pp, torch.from_numpy(x.copy()), i,
                                     src_lengths=tl, **pkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=STAGE_ATOL,
                                   err_msg=f"layer {i}")
    x = np.asarray(want)
    want = jax.jit(lambda p, x, l: jm.encode_staged_finish(
        p, x, src_lengths=l, **jkw))(jp, jnp.asarray(x), jnp.asarray(lens))
    got = pm.encode_staged_finish(pp, torch.from_numpy(x.copy()),
                                  src_lengths=tl, **pkw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STAGE_ATOL)


@pytest.mark.parametrize("quant", ["fp", "int8"])
@pytest.mark.parametrize("width", [1, 3])
def test_staged_chain_equals_monolithic_encode(quant, width):
    """begin → every layer → finish is the port's ``encode_cross_kv``: 0
    differing elements."""
    s = _module_state()
    _, _, pp, pctx = s["params"][quant]
    pm = s["model"]
    kw = {} if pctx is None else {"quant": pctx}
    src, lens = _src_batch(s, width)
    batch = {"src_tokens": torch.from_numpy(src),
             "src_lengths": torch.from_numpy(lens)}
    x = pm.encode_staged_begin(pp, batch)
    for i in range(pm.cfg.n_enc_layers):
        x = pm.encode_staged_layer(pp, x, i, src_lengths=batch["src_lengths"],
                                   **kw)
    staged = pm.encode_staged_finish(pp, x, src_lengths=batch["src_lengths"],
                                     **kw)
    whole = pm.encode_cross_kv(pp, batch, **kw)
    for a, b in zip(staged, whole):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert int((a != b).sum()) == 0


# ---------------------------------------------------------------------------
# the scheduler's staged routing
# ---------------------------------------------------------------------------

def _plan_view(plan):
    ids = lambda rs: [r.req_id for r in rs]
    return (ids(plan.requests), ids(plan.staged), ids(plan.hits),
            ids(plan.released), ids(plan.resumed), plan.width,
            plan.hit_width, plan.base_rows.tolist(),
            plan.src_lengths.tolist(), plan.ins_pages.tolist(),
            plan.hit_pages.tolist(), plan.n_admitted)


def test_plan_admission_staged_routing_matches_reference():
    """Long sources stage and bypass the prefix cache both ways (a staged
    source neither hits nor inserts); resumed requests and zero budgets
    route as before; all of it equal to the reference's scheduler, round
    by round."""
    jserving = import_reference_serving()
    jsched_mod = jserving.scheduler
    rng = np.random.default_rng(3)
    srcs = [rng.integers(3, 30, size=n).astype(np.int32)
            for n in (9, 4, 12, 4, 3, 9, 7, 4)]
    srcs[3] = srcs[1].copy()                 # a short source twice: a hit
    srcs[5] = srcs[0].copy()                 # a long one twice: no hit
    budgets = [5, 4, 6, 3, 0, 5, 4, 2]
    sides = []
    for mod, Req, Cache in (
            (None, Request, PrefixCache),
            (jsched_mod, jserving.Request, jserving.PrefixCache)):
        if mod is None:
            Sched, Alloc = ContinuousScheduler, kv.PageAllocator
        else:
            Sched = mod.ContinuousScheduler
            Alloc = jserving.engine.kvc.PageAllocator
        pc = Cache(Alloc(32, 4))
        sched = Sched(4, prefix_cache=pc, prefill_chunk=CHUNK)
        sched.submit_many([Req(req_id=i, src=x, max_new_tokens=b)
                           for i, (x, b) in enumerate(zip(srcs, budgets))])
        sides.append((sched, {}))
    got, want = [], []
    for rnd in range(6):
        for (sched, live), out in zip(sides, (got, want)):
            plan = sched.plan_admission(float(rnd), step=rnd, enc_len=16,
                                        oob_row=4)
            out.append(_plan_view(plan))
            for r in plan.requests + plan.hits + plan.staged:
                live[r.req_id] = r
            if rnd in (1, 2):
                # preempt a staged request (it restages on re-admission),
                # then a short one that spilled (it resumes)
                victim = next(r for r in live.values()
                              if r.status == "running"
                              and (r.n_src_tokens > CHUNK) == (rnd == 1))
                if rnd == 2:
                    victim.spill = "payload"
                sched.preempt(victim, float(rnd))
            else:
                # finish the oldest running request
                run = sorted((r for r in live.values()
                              if r.status == "running"),
                             key=lambda r: r.req_id)
                if run:
                    sched.release(run[0], float(rnd), step=rnd)
    assert got == want
    staged = [set(v[1]) for v in got]
    assert {0, 2, 5} <= set().union(*staged)        # every long source
    assert any(v[2] for v in got)                   # a prefix hit
    assert any(v[4] for v in got)                   # a resumed request


# ---------------------------------------------------------------------------
# end to end against the reference engine
# ---------------------------------------------------------------------------

MATRIX = [
    # quant, paged, beam, burst_len
    ("fp", True, None, 4),
    ("int8", True, None, "auto"),
    ("fp", False, None, "auto"),
    ("int8", False, None, 4),
    ("fp", True, 2, 4),
    ("int8", True, [2, 1, 2, 2, 1, 2], "auto"),
    ("fp", False, [1, 2, 2, 1, 2, 1], 4),
]


@pytest.mark.parametrize("quant,paged,beam,burst", MATRIX)
def test_chunked_serve_matches_reference(quant, paged, beam, burst):
    s = _module_state()
    port = s["engines"][("port", quant, paged)]
    ref = s["engines"][("ref", quant, paged)]
    srcs = s["srcs"]
    kw = dict(n_slots=4, max_new_tokens=[8] * len(srcs), burst_len=burst,
              beam=beam)
    base = port.serve(srcs, **kw)
    got = port.serve(srcs, prefill_chunk=CHUNK, **kw)
    want = ref.serve(srcs, prefill_chunk=CHUNK, **kw)
    n_long = sum(len(x) > CHUNK for x in srcs)
    assert got.chunked_admissions == n_long
    assert got.chunk_rounds == n_long * s["model"].cfg.n_enc_layers
    if burst == "auto":
        # the adaptive cap follows wall times: tokens only
        assert _tokens(got) == _tokens(want)
    else:
        _assert_same(got, want)
    assert _tokens(got) == _tokens(base)
    _assert_reclaimed(got)


@pytest.mark.parametrize("beam", [None, 2])
def test_chunked_serve_with_prefix_cache_matches_reference(beam):
    """Cold then warm: the short sources hit on the warm serve, the staged
    ones never do."""
    s = _module_state()
    eng = _fresh_engines(prefix_cache=True)
    srcs = s["srcs"]
    kw = dict(n_slots=4, max_new_tokens=[8] * len(srcs), burst_len=4,
              beam=beam, prefill_chunk=CHUNK)
    for _ in range(2):
        got, want = (e.serve(srcs, **kw) for e in eng)
        _assert_same(got, want)
    assert got.prefix_hits == sum(len(x) <= CHUNK for x in srcs)
    assert got.chunked_admissions == len(srcs) - got.prefix_hits
    plain = eng[0].serve(srcs, **dict(kw, prefill_chunk=None,
                                      prefix_cache=False))
    assert _tokens(got) == _tokens(plain)
    _assert_reclaimed(got)


@pytest.mark.parametrize("beam", [None, 2])
def test_chaos_preempts_staged_chunked_prefill(beam):
    """The reference's test: victims caught mid-stage drop the stage and
    restage on re-admission; the port equals the reference engine."""
    s = _module_state()
    port = s["engines"][("port", "fp", True)]
    ref = s["engines"][("ref", "fp", True)]
    srcs = s["srcs"]
    kw = dict(n_slots=4, max_new_tokens=[8] * len(srcs), burst_len=4,
              beam=beam)
    base = port.serve(srcs, **kw)
    got, want = (e.serve(srcs, prefill_chunk=CHUNK, chaos=make_chaos(
        9, n_rounds=64, preempt_every=1), **kw) for e in (port, ref))
    assert got.chunked_admissions > 0 and got.preemptions > 0
    _assert_same(got, want)
    assert _tokens(got) == _tokens(base)
    _assert_reclaimed(got)


def test_chaos_plus_overcommit_plus_chunked():
    """The reference's test: all three overload mechanisms at once."""
    s = _module_state()
    eng = _fresh_engines(n_pages=8)
    srcs = s["srcs"]
    kw = dict(n_slots=4, max_new_tokens=[8] * len(srcs), burst_len=4)
    base = eng[0].serve(srcs, **kw)
    got, want = (e.serve(srcs, overcommit=1.5, prefill_chunk=CHUNK,
                         chaos=make_chaos(9, n_rounds=64, preempt_every=2),
                         **kw) for e in eng)
    assert got.preemptions > 0 and got.chunked_admissions > 0
    _assert_same(got, want)
    assert _tokens(got) == _tokens(base)
    _assert_reclaimed(got)


def test_chunked_metrics_and_pure_staging_rounds():
    """A serve of long sources only: its first rounds stage and decode
    nothing, and the counters reach ``metrics()``."""
    s = _module_state()
    port = s["engines"][("port", "fp", True)]
    srcs = s["srcs"][:4]
    kw = dict(n_slots=4, max_new_tokens=6, burst_len=4)
    got = port.serve(srcs, prefill_chunk=CHUNK, **kw)
    base = port.serve(srcs, **kw)
    assert _tokens(got) == _tokens(base)
    n_long = sum(len(x) > CHUNK for x in srcs)
    met = got.metrics()
    assert met["chunked_admissions"] == n_long
    assert met["chunk_rounds"] == n_long * s["model"].cfg.n_enc_layers
    # the rounds that only stage run no burst and drain nothing
    assert got.host_syncs == base.host_syncs


@pytest.mark.parametrize("beam", [None, 1])
def test_staging_only_tail_round_frees_dead_rows(beam, monkeypatch):
    """Two rows release in one drain and the last source is admitted alone
    and staged, so no prologue resets the dead rows: the other dead row
    keeps stepping through its old table, whose pages now belong to the
    staged request.  Staging frees released rows at once, so no append
    lands on a page in another row's table and paged tokens equal
    contiguous tokens; without the freeing (the reference's behaviour)
    such appends happen, so the case reaches the fault."""
    s = _module_state()
    _, _, fp, _ = s["params"]["fp"]
    srcs = s["srcs"]
    short, early, long_ = srcs[4], srcs[1], srcs[0]
    budgets = [3, 20, 20]
    probe = ServingEngine(s["model"], fp, max_len=MAX_LEN, eos_id=-1,
                          device="cpu").serve([early], n_slots=1,
                                              max_new_tokens=20)
    first = list(map(int, probe.requests[0].tokens))
    # EOS: the first token ``early`` emits that differs from its first, so
    # it releases inside the first burst with most of its pages unwritten
    eos = next(t for t in first if t != first[0])

    foreign = []
    append = kv.append_tokens_paged

    def spy(k_store, v_store, ks, vs, tables, k_new, v_new, lengths):
        P, ps = k_store.shape[0] - 1, k_store.shape[1]
        rows = tables.tolist()
        for b, n in enumerate(lengths.tolist()):
            for t in range(k_new.shape[1]):
                j = (n + t) // ps
                page = rows[b][j] if j < len(rows[b]) else P
                foreign.append(page < P and any(
                    page in r for o, r in enumerate(rows) if o != b))
        return append(k_store, v_store, ks, vs, tables, k_new, v_new,
                      lengths)

    monkeypatch.setattr(kv, "append_tokens_paged", spy)

    def tokens(paged):
        engine = ServingEngine(s["model"], fp, max_len=MAX_LEN, paged=paged,
                               page_size=PAGE_SIZE, eos_id=eos, burst_len=8,
                               device="cpu")
        res = engine.serve([short, early, long_], n_slots=2,
                           max_new_tokens=budgets, beam=beam,
                           prefill_chunk=len(early))
        assert res.chunked_admissions == 1
        assert res.pages_in_use == 0
        return _tokens(res)

    assert len(long_) > len(early) >= len(short)
    contiguous = tokens(False)
    assert len(contiguous[1]) < budgets[1]      # released by EOS
    assert tokens(True) == contiguous
    assert foreign and not any(foreign)
    foreign.clear()
    monkeypatch.setattr(engine_mod._ServeRun, "free",
                        lambda self, bases: None)
    tokens(True)
    assert any(foreign)
