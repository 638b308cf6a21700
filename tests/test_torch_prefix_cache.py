"""The port's prefix cache (``serve(prefix_cache=True)``) against the
reference, on the reduced model of the reference's own
``tests/test_prefix_cache.py`` (random weights from ``PRNGKey(0)``, carried
into the port by the bridge).

Host side: ``PrefixCache`` (roles, chains, stats, LRU evictions, refcounts)
on seeded operation sequences, and the scheduler's prefix routing
(``assign_prefix``, ``chain_pages_matrix``, ``shape_hits``, the hit fields
of ``plan_admission``), equal to the reference's.  Device side:
``insert_chain_pages`` and ``gather_chain_pages``, exact.
End to end: six requests (three sources, each twice) through 8 rows with
the cache warm from the first occurrence, greedy and beam (uniform and
mixed widths), FP and INT8 dynamic and one INT4 case, fused and unfused,
fixed and ``"auto"`` burst, contiguous and paged: the port's tokens and its
step, page, prefix and overload counters equal the reference engine's
(scores within 1e-4 relative, as in ``test_torch_beam_serve.py``), and equal
the port's own cold-cache serve.
"""

import dataclasses

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
from repro.models import kv_cache as jkv

import torch

from repro_torch.checkpoint.bridge import block_meta_of, params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import QuantContext, QuantPolicy, quantize_model
from repro_torch.models import EncDecLM
from repro_torch.models import kv_cache as kv
from repro_torch.serving import (
    ContinuousScheduler,
    PrefixCache,
    Request,
    ServingEngine,
)

from _torch_reference import import_reference_serving

MAX_LEN = 32
PAGE_SIZE = 8
N_SLOTS = 8
BUDGETS = [3, 7, 5, 3, 7, 5]            # repeated sources → repeated budgets
MIXED = [4, 2, 1, 4, 2, 1]
REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=1, d_ff=96,
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
    """The reference test's model and sources, and the same weights in the
    port: FP, INT8 dynamic, and INT4 (group 16) with dynamic scales."""
    if "model" not in _CACHED:
        jcfg = jget_config("transformer-base").reduced(**REDUCED)
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        dynamic = JQuantPolicy(act_quant="dynamic")
        jq8 = jquantize_model(jparams, {}, dynamic)
        jq4 = jquantize_model(jparams, {}, dynamic, weight_bits=4,
                              weight_group_size=16)
        model = EncDecLM(get_config("transformer-base").reduced(**REDUCED),
                         device="cpu")
        fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        q4 = params_from_flat(_flatten_with_paths(jq4[0]), device="cpu",
                              block_meta=block_meta_of(jq4[0]))
        corpus = jmake_corpus(3, jcfg.vocab, seed=11, max_words=8)
        _CACHED.update(
            jmodel=jmodel, model=model,
            ref={"fp": (jparams, None), "int8": jq8, "int4": jq4},
            port={"fp": (fp, None),
                  "int8": quantize_model(fp, {}, QuantPolicy(
                      act_quant="dynamic"), device="cpu"),
                  "int4": (q4, QuantContext(policy=QuantPolicy(
                      act_quant="dynamic")))},
            srcs=[np.asarray(r.src, np.int32) for r in corpus] * 2)
    return _CACHED


def _engine(side, quant, paged, warm=True, **kw):
    s = _module_state()
    params, ctx = s[side][quant]
    kw = dict(kw, max_len=MAX_LEN, paged=paged, page_size=PAGE_SIZE)
    if ctx is not None:
        kw["quant"] = ctx
    if warm:
        kw.update(prefix_cache=True, prefix_pages=64)
    if side == "ref":
        return import_reference_serving().ServingEngine(s["jmodel"], params,
                                                        **kw)
    return ServingEngine(s["model"], params, device="cpu", **kw)


def _serve(eng, *, beam=None, fused=True, burst=4, **kw):
    return eng.serve(_module_state()["srcs"], max_new_tokens=BUDGETS,
                     n_slots=N_SLOTS, beam=beam, burst_len=burst,
                     fused_admission=fused, **kw)


def _outcome(res):
    return ([list(map(int, r.tokens)) for r in res.requests],
            [r.score for r in res.requests],
            {c: getattr(res, c) for c in COUNTERS})


def _assert_same(got, want):
    (gt, gs, gc), (wt, ws, wc) = _outcome(got), _outcome(want)
    assert gt == wt
    assert gc == wc
    assert [s is None for s in gs] == [s is None for s in ws]
    np.testing.assert_allclose([s for s in gs if s is not None],
                               [s for s in ws if s is not None],
                               rtol=1e-4, atol=1e-6)
    assert gc["pages_in_use"] == 0
    assert gc["spill_events"] == gc["restore_events"]


# ---------------------------------------------------------------------------
# PrefixCache: the host structure
# ---------------------------------------------------------------------------

def _pc(n_pages=16, page_size=4):
    return PrefixCache(kv.PageAllocator(n_pages, page_size))


def test_exact_match_only():
    """A strict prefix or an extension of a cached source is a miss (the
    bidirectional encoder makes partial reuse change tokens)."""
    pc = _pc()
    src = np.arange(1, 8, dtype=np.int32)            # 7 tokens, ps=4
    role, chain = pc.admit(src)
    assert role == "insert" and chain.n_pages == 2
    assert pc.lookup(src) is chain
    assert pc.lookup(src[:4]) is None                # page-aligned prefix
    assert pc.lookup(src[:6]) is None                # same chunk count
    assert pc.lookup(np.concatenate([src, [8]])) is None     # extension
    role2, chain2 = pc.admit(src)
    assert role2 == "hit" and chain2 is chain
    other = np.concatenate([src[:4], [9, 9]]).astype(np.int32)
    role3, chain3 = pc.admit(other)
    assert role3 == "insert" and chain3 is not chain
    assert pc.lookup(src) is chain and pc.lookup(other) is chain3


def test_refcount_lifecycle_and_skip_under_pressure():
    """The tree holds one reference a chain and every reader another; a
    chain being read is never evicted, and a full pool degrades to
    "skip"."""
    pc = _pc()
    src = np.arange(1, 6, dtype=np.int32)
    _, chain = pc.admit(src)                         # tree + inserter
    assert all(pc.allocator.refcount(p) == 2 for p in chain.pages)
    _, c2 = pc.admit(src)                            # a second reader
    assert all(pc.allocator.refcount(p) == 3 for p in chain.pages)
    pc.finish(chain)
    pc.finish(c2)
    assert pc.allocator.in_use == chain.n_pages      # the tree keeps it
    pc.clear()
    assert pc.allocator.in_use == 0
    small = _pc(n_pages=4, page_size=4)
    held = [small.admit(np.full(6, v, np.int32))[1] for v in (1, 2)]
    assert small.admit(np.full(6, 3, np.int32)) == ("skip", None)
    small.finish(held[1])
    assert small.admit(np.full(6, 3, np.int32))[0] == "insert"
    assert small.stats.evictions == 1 and small.lookup(np.full(6, 1)) \
        is held[0]


def _chain(c):
    return None if c is None else (c.key, c.pages, c.src_len, c.n_pages)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_operations_equal_reference(seed):
    """A seeded sequence of admits, finishes, clears and lookups over a
    small pool: the same roles, chains, stats, evictions, refcounts and
    free pages as the reference's ``PrefixCache``."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(seed)
    n_pages, ps = int(rng.integers(4, 12)), int(rng.integers(2, 5))
    got = PrefixCache(kv.PageAllocator(n_pages, ps))
    want = jserving.PrefixCache(jkv.PageAllocator(n_pages, ps))
    sources = [rng.integers(1, 4, int(rng.integers(0, 11))).astype(np.int32)
               for _ in range(8)]
    held = []
    for _ in range(150):
        r = rng.random()
        if r < 0.6:
            src = sources[int(rng.integers(len(sources)))]
            (rg, cg), (rw, cw) = got.admit(src), want.admit(src)
            assert (rg, _chain(cg)) == (rw, _chain(cw))
            if cg is not None:
                held.append((cg, cw))
        elif r < 0.9 and held:
            cg, cw = held.pop(int(rng.integers(len(held))))
            got.finish(cg)
            want.finish(cw)
        elif r < 0.93:
            got.clear()
            want.clear()
        else:
            src = sources[int(rng.integers(len(sources)))]
            assert _chain(got.lookup(src)) == _chain(want.lookup(src))
        assert dataclasses.asdict(got.stats) == dataclasses.asdict(
            want.stats)
        assert (got.n_chains, got.pages_held) == (want.n_chains,
                                                  want.pages_held)
        assert [got.allocator.refcount(p) for p in range(n_pages)] == \
            [want.allocator.refcount(p) for p in range(n_pages)]
        assert got.allocator.n_free == want.allocator.n_free
    # the sequence reaches every role and both eviction paths
    st = got.stats
    assert st.hits and st.inserts and st.skipped_inserts and st.evictions


# ---------------------------------------------------------------------------
# chain pages on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_pages_equal_reference(dtype):
    """``insert_chain_pages`` (a partial last page; a padding row and a
    row's unused tail all sentinel, dropped) then ``gather_chain_pages``
    (sentinels clamped into the pool, a padding row replaying row 0), bit
    for bit."""
    rng = np.random.default_rng(3)
    L, P, ps, S, HKV, dh = 2, 9, 4, 10, 2, 3         # nP = 3, last page 2/4
    pool0 = rng.standard_normal((L, P, ps, HKV, dh)).astype(np.float32)
    part = rng.standard_normal((L, 4, S, HKV, dh)).astype(np.float32)
    pages = np.array([[4, 0, 7], [2, 5, P], [P, P, P], [8, 1, 3]], np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    pool = torch.as_tensor(pool0).to(tdt)
    kv.insert_chain_pages(pool, torch.as_tensor(part).to(tdt), pages)
    jpool = jkv.insert_chain_pages(jnp.asarray(pool0, jdt),
                                   jnp.asarray(part, jdt),
                                   jnp.asarray(pages))
    as_f32 = lambda t: t.to(torch.float32).numpy()
    np.testing.assert_array_equal(as_f32(pool),
                                  np.asarray(jpool.astype(jnp.float32)))
    reads = np.array([[2, 5, P], [4, 0, 7], [4, 0, 7]], np.int32)
    for seq_len in (S, 7):
        got = kv.gather_chain_pages(pool, reads, seq_len)
        want = jkv.gather_chain_pages(jpool, jnp.asarray(reads), seq_len)
        assert tuple(got.shape) == want.shape == (L, 3, seq_len, HKV, dh)
        np.testing.assert_array_equal(as_f32(got),
                                      np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the scheduler's prefix routing
# ---------------------------------------------------------------------------

def _plan_key(plan):
    ids = lambda rs: [(r.req_id, r.slot, r.prefix_role) for r in rs]
    return (ids(plan.requests), ids(plan.hits), ids(plan.released),
            plan.src_tokens.tolist(), plan.src_lengths.tolist(),
            plan.base_rows.tolist(), plan.width, plan.hit_rows.tolist(),
            plan.hit_lengths.tolist(), plan.hit_pages.tolist(),
            plan.hit_width, plan.ins_pages.tolist(), plan.prefix_hit_pages,
            plan.n_admitted)


@pytest.mark.parametrize("group", [1, 2])
def test_scheduler_prefix_routing_equals_reference(group):
    """Repeated sources (some zero budgets) through a small chain pool,
    alternating fused plans with unfused admits routed by hand
    (``assign_prefix``, ``shape_hits``, ``chain_pages_matrix`` at the
    group stride), and releases: the same roles, hit and insert matrices,
    chains and allocator states as the reference's scheduler."""
    jserving = import_reference_serving()
    rng = np.random.default_rng(20 + group)
    base = [rng.integers(1, 30, int(rng.integers(1, 12))).astype(np.int32)
            for _ in range(5)]
    srcs = [base[int(i)] for i in rng.integers(0, 5, 24)]
    budgets = rng.integers(0, 6, 24)

    def build(Req, Sched, Cache, Alloc):
        reqs = [Req(req_id=i, src=s, max_new_tokens=int(b))
                for i, (s, b) in enumerate(zip(srcs, budgets))]
        sched = Sched(6 * group, group_size=group, prefill_token_budget=40,
                      prefix_cache=Cache(Alloc(9, 4)))
        sched.submit_many(reqs)
        return sched, reqs

    got, greqs = build(Request, ContinuousScheduler, PrefixCache,
                       kv.PageAllocator)
    want, wreqs = build(jserving.Request, jserving.ContinuousScheduler,
                        jserving.PrefixCache, jkv.PageAllocator)
    for rnd in range(40):
        if rnd % 2:
            g = got.plan_admission(rnd, step=rnd, enc_len=16, oob_row=99)
            w = want.plan_admission(rnd, step=rnd, enc_len=16, oob_row=99)
            assert _plan_key(g) == _plan_key(w)
        else:
            ga, wa = got.admit(rnd, step=rnd), want.admit(rnd, step=rnd)
            assert [(r.req_id, r.slot) for r in ga] == \
                [(r.req_id, r.slot) for r in wa]
            (gm, gh), (wm, wh) = got.assign_prefix(ga), \
                want.assign_prefix(wa)
            assert [(r.req_id, r.prefix_role) for r in gm + gh] == \
                [(r.req_id, r.prefix_role) for r in wm + wh]
            np.testing.assert_array_equal(
                got.chain_pages_matrix(gm, 8 * group, 16, stride=group),
                want.chain_pages_matrix(wm, 8 * group, 16, stride=group))
            if gh:
                for a, b in zip(got.shape_hits(gh, enc_len=16, oob_row=99),
                                want.shape_hits(wh, enc_len=16, oob_row=99)):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
        for slot in sorted(want.slot_map):
            if rng.random() < 0.5:
                assert got.release(got.slot_map[slot], rnd) == \
                    want.release(want.slot_map[slot], rnd)
        gpc, wpc = got.prefix_cache, want.prefix_cache
        assert dataclasses.asdict(gpc.stats) == dataclasses.asdict(wpc.stats)
        assert [gpc.allocator.refcount(p) for p in range(9)] == \
            [wpc.allocator.refcount(p) for p in range(9)]
    assert got.all_done and want.all_done
    assert got.prefix_cache.stats.hits > 0
    for g, w in zip(greqs, wreqs):
        assert (g.status, g.prefix_chain, g.admitted_step) == (
            w.status, w.prefix_chain, w.admitted_step)


# ---------------------------------------------------------------------------
# serve(prefix_cache=True) against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,paged,fused,burst", [
    ("fp", False, True, 4),
    ("fp", True, False, 4),
    ("int8", True, True, "auto"),
    ("int8", False, False, 1),
    ("int4", True, True, 4),
])
def test_greedy_serve_with_hits_matches_reference(quant, paged, fused, burst):
    warm = _serve(_engine("port", quant, paged), fused=fused, burst=burst)
    _assert_same(warm, _serve(_engine("ref", quant, paged), fused=fused,
                              burst=burst))
    assert warm.prefix_hits >= len(BUDGETS) // 2
    assert warm.prefix_hit_pages >= warm.prefix_hits
    cold = _serve(_engine("port", quant, paged, warm=False), fused=fused,
                  burst=burst)
    assert _outcome(warm)[0] == _outcome(cold)[0]


@pytest.mark.parametrize("quant,paged,beam,fused,burst", [
    ("fp", True, 4, True, 4),
    ("int8", True, 4, False, 4),
    ("fp", False, MIXED, False, 4),
    ("int8", False, MIXED, True, "auto"),
])
def test_beam_serve_with_hits_matches_reference(quant, paged, beam, fused,
                                                burst):
    warm = _serve(_engine("port", quant, paged), beam=beam, fused=fused,
                  burst=burst)
    _assert_same(warm, _serve(_engine("ref", quant, paged), beam=beam,
                              fused=fused, burst=burst))
    assert warm.prefix_hits >= 1
    cold = _serve(_engine("port", quant, paged, warm=False), beam=beam,
                  fused=fused, burst=burst)
    assert _outcome(warm)[0] == _outcome(cold)[0]
    np.testing.assert_array_equal([r.score for r in warm.requests],
                                  [r.score for r in cold.requests])


def test_cache_persists_across_serves():
    """A second serve on the same engine: every request hits, no chain page
    is allocated, the encoder runs on nothing, the tokens are the first
    serve's; the counters are the reference's."""
    port, ref = _engine("port", "fp", True), _engine("ref", "fp", True)
    first = _serve(port)
    _assert_same(first, _serve(ref))
    second = _serve(port)
    _assert_same(second, _serve(ref))
    n = len(BUDGETS)
    assert second.prefix_hits == n and second.prefix_misses == 0
    assert second.prefix_pages_allocated == 0 and second.encoder_tokens == 0
    assert _outcome(second)[0] == _outcome(first)[0]
    m = second.metrics()
    assert m["prefix_hit_rate"] == 1.0 and m["prefix_cache"] == 1.0


def test_serve_flag_overrides_engine_default():
    """``serve(prefix_cache=False)`` on a cache-enabled engine bypasses the
    cache (no stats, no prefix fields, no pool); ``serve(prefix_cache=
    True)`` on a plain engine builds it."""
    eng = _engine("port", "fp", False)
    res = _serve(eng, prefix_cache=False)
    assert not res.prefix_cache and res.prefix_hits == res.prefix_misses == 0
    assert eng._prefix_cache_obj is None and eng._prefix_pool is None
    plain = _engine("port", "fp", False, warm=False)
    res = _serve(plain, prefix_cache=True)
    assert res.prefix_cache and res.prefix_hits >= len(BUDGETS) // 2


def test_chain_pool_reads_back_a_fresh_encode():
    """The pool is in the activation dtype, not the INT8 cache's, and a
    cached chain gathers back bit for bit what ``encode_cross_kv`` gives."""
    s = _module_state()
    eng = _engine("port", "int8", True)
    _serve(eng)
    pk, pv = eng._prefix_pool
    assert pk.dtype == s["model"].cfg.activation_dtype
    pc = eng._prefix_cache_obj
    params, ctx = s["port"]["int8"]
    for src in s["srcs"][:3]:
        chain = pc.lookup(src)
        pages = np.asarray([chain.pages], np.int32)
        padded = np.zeros((1, eng._enc_bucket_hwm), np.int32)
        padded[0, :len(src)] = src
        ck, cv, _ = s["model"].encode_cross_kv(params, {
            "src_tokens": torch.as_tensor(padded),
            "src_lengths": torch.as_tensor([len(src)], dtype=torch.int32)},
            quant=ctx)
        for pool, want in ((pk, ck), (pv, cv)):
            got = kv.gather_chain_pages(pool, pages, len(src))
            np.testing.assert_array_equal(
                got.numpy(), want[:, :, :len(src)].to(pool.dtype).numpy())
