"""The port's ``ReplicaRouter`` against the reference's, and the
reference's five router tests (``tests/test_sharded_serve.py``) on the
port's engines.

``route`` gives the reference router's assignment on the same requests
(shallowest queue, then the most estimated free pages), exactly.  The
merged tokens equal a single engine's serve, with and without per-replica
chaos, threaded and serial, exactly.  The model is the reference test's
reduced one (``PRNGKey(0)``), carried into the port.
"""

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.data import make_corpus as jmake_corpus
from repro.models import build_model as jbuild_model

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy, quantize_model
from repro_torch.models import EncDecLM
from repro_torch.serving import ReplicaRouter, ServingEngine, make_chaos

from _torch_reference import import_reference_serving

MAX_LEN = 32
PAGE_SIZE = 8
N_SLOTS = 8
BUDGETS = [3, 7, 24, 5, 16, 2, 4, 9]
REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=1, d_ff=96,
               n_heads=4, n_kv_heads=4, head_dim=16)
_CACHED = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state():
    if "model" not in _CACHED:
        jcfg = jget_config("transformer-base").reduced(**REDUCED)
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        _CACHED.update(
            jmodel=jmodel, jparams=jparams,
            model=EncDecLM(get_config("transformer-base").reduced(**REDUCED),
                           device="cpu"),
            params={"fp": (fp, None),
                    "int8": quantize_model(fp, {}, QuantPolicy(
                        act_quant="dynamic"), device="cpu")},
            srcs=[np.asarray(r.src, np.int32) for r in
                  jmake_corpus(len(BUDGETS), jcfg.vocab, seed=3,
                               max_words=6)])
    return _CACHED


def _engine(quant, **kw):
    s = _state()
    params, ctx = s["params"][quant]
    kw.setdefault("paged", True)
    kw.setdefault("page_size", PAGE_SIZE)
    if ctx is not None:
        kw["quant"] = ctx
    return ServingEngine(s["model"], params, max_len=MAX_LEN, device="cpu",
                         **kw)


@pytest.mark.parametrize("n,pages,paged", [(2, None, True), (3, 7, True),
                                           (3, 5, True), (2, None, False)])
def test_route_equals_reference(n, pages, paged):
    """The same requests, the same replica per request."""
    s = _state()
    rng = np.random.default_rng(n + (pages or 0))
    srcs = [s["srcs"][i % len(s["srcs"])] for i in range(20)]
    budgets = [int(b) for b in rng.integers(1, 30, size=len(srcs))]
    kw = dict(paged=paged, page_size=PAGE_SIZE, n_pages=pages)
    jserving = import_reference_serving()
    jengines = [jserving.ServingEngine(s["jmodel"], s["jparams"],
                                       max_len=MAX_LEN, **kw)
                for _ in range(n)]
    engines = [_engine("fp", **kw) for _ in range(n)]
    want = jserving.ReplicaRouter(jengines).route(
        jengines[0]._as_requests(srcs, budgets), n_slots=4)
    got = ReplicaRouter(engines).route(
        engines[0]._as_requests(srcs, budgets), n_slots=4)
    assert got == want


def test_router_balances_and_matches_single_engine():
    s = _state()
    ref = _engine("fp").serve(s["srcs"], n_slots=N_SLOTS,
                              max_new_tokens=BUDGETS)
    router = ReplicaRouter([_engine("fp"), _engine("fp")])
    res = router.serve(s["srcs"], n_slots=N_SLOTS, max_new_tokens=BUDGETS)
    for r in res.requests:
        np.testing.assert_array_equal(ref.tokens_for(r.req_id),
                                      res.tokens_for(r.req_id))
    counts = [res.assignment.count(i) for i in range(2)]
    even = len(s["srcs"]) / 2
    assert abs(counts[0] - counts[1]) <= 1
    assert all(abs(p - even) <= 1 for p in res.peak_running_per_replica)
    assert all(r.replicas == 2 for r in res.results)
    assert res.metrics()["replicas"] == 2.0
    assert res.results[0].metrics()["replicas"] == 2.0


def test_router_chaos_per_replica_token_identity():
    """Preemption chaos inside each replica leaves the merged tokens."""
    s = _state()
    ref = _engine("int8").serve(s["srcs"], n_slots=N_SLOTS,
                                max_new_tokens=BUDGETS)
    router = ReplicaRouter([_engine("int8"), _engine("int8")])
    res = router.serve(
        s["srcs"], n_slots=N_SLOTS, max_new_tokens=BUDGETS,
        overcommit=1.5,
        chaos=[make_chaos(2, n_rounds=64, preempt_every=2),
               make_chaos(7, n_rounds=64, preempt_every=3)])
    for r in res.requests:
        np.testing.assert_array_equal(ref.tokens_for(r.req_id),
                                      res.tokens_for(r.req_id))
    assert sum(r.preemptions for r in res.results) > 0
    # chaos'd pools still reclaim fully per replica
    assert all(r.pages_in_use == 0 for r in res.results)


def test_router_prefix_cache_per_replica():
    s = _state()
    srcs = [s["srcs"][i % 2] for i in range(6)]
    router = ReplicaRouter([_engine("fp", prefix_cache=True)
                            for _ in range(2)])
    cold = router.serve(srcs, n_slots=4, max_new_tokens=6)
    warm = router.serve(srcs, n_slots=4, max_new_tokens=6)
    for r in warm.requests:
        np.testing.assert_array_equal(cold.tokens_for(r.req_id),
                                      warm.tokens_for(r.req_id))
    assert sum(r.prefix_hits for r in warm.results) == len(srcs)


def test_router_rejects_empty_and_mismatched_chaos():
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])
    router = ReplicaRouter([_engine("fp"), _engine("fp")])
    with pytest.raises(ValueError, match="chaos"):
        router.serve(_state()["srcs"], chaos=[None])


def test_router_serial_matches_parallel():
    s = _state()
    par = ReplicaRouter([_engine("fp"), _engine("fp")]).serve(
        s["srcs"], n_slots=N_SLOTS, max_new_tokens=BUDGETS)
    ser = ReplicaRouter([_engine("fp"), _engine("fp")]).serve(
        s["srcs"], n_slots=N_SLOTS, max_new_tokens=BUDGETS, parallel=False)
    assert par.assignment == ser.assignment
    for r in par.requests:
        np.testing.assert_array_equal(par.tokens_for(r.req_id),
                                      ser.tokens_for(r.req_id))


def test_router_surfaces_a_replica_failure():
    """A replica's exception is raised after every thread ended."""
    s = _state()
    router = ReplicaRouter([_engine("fp"), _engine("fp", paged=False)])
    with pytest.raises(ValueError, match="paged"):
        router.serve(s["srcs"], n_slots=N_SLOTS, max_new_tokens=BUDGETS,
                     overcommit=1.5)
