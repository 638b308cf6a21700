"""Tensor-parallel serving (``ServingEngine(mesh=...)``) against the
unsharded engine, on the reference test's model and matrix
(``tests/test_sharded_serve.py``: GREEDY_CASES, BEAM_CASES, unpaged, the
GQA fallback, the prefix cache, the mesh fields).

The reference's tier-1 run skips every ``tp > 1`` case (it sees one CPU
device).  Here tp 2 and tp 4 run in gloo process groups on the CPU: ranks
are spawned once per tp per file (``tests/_torch_sharded.py``), each rank
serves every case of its tp, and the tests read the cached results.  The
contract is the reference's: the tokens and ``host_syncs`` of every rank
equal the port's unsharded engine exactly (no tolerance), and so do the
decode steps, prefix hits, preemptions and leaked pages.  One greedy INT8
and one beam case are also held to the reference's unsharded engine
(tokens and ``host_syncs``, exact); the other port test files hold the
unsharded engine to the reference for the rest.  tp 2 adds an INT4
serve (replicated out-projections behind gathered inputs) and a serve
under overcommit and chaos, tp 4 the GQA fallback (2 kv heads on 4
ranks).
"""

import tempfile

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.data import make_corpus as jmake_corpus
from repro.models import build_model as jbuild_model

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy, quantize_model
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import EncDecLM
from repro_torch.serving import ServingEngine

import _torch_sharded as sh
from _torch_reference import import_reference_serving

REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=1, d_ff=96,
               n_heads=4, n_kv_heads=4, head_dim=16)
RANK_TIMEOUT_S = 240
_CACHED = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup():
    """The reference test's models (``PRNGKey(0)``, and the GQA one with
    ``PRNGKey(1)``) carried into the port, its sources, and the port's
    INT8-dynamic and INT4 (group 16, dynamic scales) trees."""
    if "setup" not in _CACHED:
        models, params, ref = {}, {}, {}
        for name, hkv, key, n_src, seed in (("main", 4, 0, len(sh.BUDGETS), 3),
                                            ("gqa", 2, 1, 4, 5)):
            over = dict(REDUCED, n_kv_heads=hkv)
            jcfg = jget_config("transformer-base").reduced(**over)
            jmodel = jbuild_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(key))
            fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
            srcs = [np.asarray(r.src, np.int32) for r in
                    jmake_corpus(n_src, jcfg.vocab, seed=seed, max_words=6)]
            models[name] = (EncDecLM(get_config("transformer-base")
                                     .reduced(**over), device="cpu"), srcs)
            params[(name, "fp")] = (fp, None)
            ref[name] = (jmodel, jparams)
        for quant, kw in (("int8", {}), ("int4", dict(
                weight_bits=4, weight_group_size=16))):
            params[("main", quant)] = quantize_model(
                params[("main", "fp")][0], {},
                QuantPolicy(act_quant="dynamic"), device="cpu", **kw)
        main, srcs = models["main"]
        models["prefix"] = (main, [srcs[i % 3] for i in range(6)])
        params[("prefix", "fp")] = params[("main", "fp")]
        _CACHED["setup"] = {"models": models, "params": params}
        _CACHED["ref"] = ref
    return _CACHED["setup"]


def _unsharded():
    if "unsharded" not in _CACHED:
        _CACHED["unsharded"] = sh.run_cases(_setup(), None)
    return _CACHED["unsharded"]


def _ranks(tp):
    """Every rank's results at ``tp``: one spawn of ``tp`` gloo ranks per
    file (a ``file://`` rendezvous in a fresh directory, so concurrent
    test workers never meet); a rank's traceback fails the test."""
    key = ("ranks", tp)
    if key not in _CACHED:
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=sh.rank_main,
                                 args=(r, tp, f"file://{tmp}/rdzv", _setup(),
                                       queue))
                     for r in range(tp)]
            for p in procs:
                p.start()
            try:
                got = dict(queue.get(timeout=RANK_TIMEOUT_S)
                           for _ in range(tp))
            finally:
                for p in procs:
                    p.join(timeout=30)
                    if p.is_alive():
                        p.kill()
        for r, res in sorted(got.items()):
            if isinstance(res, str):
                pytest.fail(f"rank {r} of {tp} failed:\n{res}")
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        _CACHED[key] = [got[r] for r in range(tp)]
    return _CACHED[key]


def _assert_identical(want, got, tp):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g["tokens"] == w["tokens"]
        assert g["host_syncs"] == w["host_syncs"], "sharding added host syncs"
        for c in ("decode_steps", "prefix_hits", "preemptions",
                  "pages_in_use"):
            assert g.get(c) == w.get(c), c
        if "mesh_shape" not in w:           # generate / generate_beam
            continue
        assert g["tp_degree"] == tp and g["mesh_shape"] == (1, tp)
        assert (g["collective_bytes_per_step"] > 0) == (tp > 1)


def _case_ids(tp):
    return [(tp, c[0]) for c in sh.cases(tp)]


@pytest.mark.parametrize("tp,case", _case_ids(2) + _case_ids(4))
def test_sharded_serve_equals_unsharded(tp, case):
    """Every rank's serve equals the unsharded engine's: tokens, host
    syncs and counters, exactly."""
    want = _unsharded()[case]
    for rank_results in _ranks(tp):
        _assert_identical(want, rank_results[case], tp)


def test_prefix_cache_all_hits_on_the_sharded_pool():
    got = _ranks(2)[0]["prefix"]
    assert got[1]["prefix_hits"] == 6 and got[0]["tokens"] == got[1]["tokens"]


def test_overload_preempts_on_the_sharded_pool():
    got = _ranks(2)[0]["overload"][0]
    assert got["preemptions"] > 0 and got["pages_in_use"] == 0


@pytest.mark.parametrize("case", ["greedy-int8-True-auto-0",
                                  "beam-4-int8-False"])
def test_unsharded_cases_equal_the_reference_engine(case):
    """The cases the ranks are held to, held to the reference's unsharded
    engine (tokens and host syncs, exact)."""
    _setup()
    jmodel, jparams = _CACHED["ref"]["main"]
    jq = jquantize_model(jparams, {}, JQuantPolicy(act_quant="dynamic"))
    name, _, _, _, serves = next(c for c in sh.cases(None) if c[0] == case)
    eng = import_reference_serving().ServingEngine(
        jmodel, jq[0], quant=jq[1], max_len=sh.MAX_LEN, paged=True,
        page_size=sh.PAGE_SIZE)
    want = eng.serve(_setup()["models"]["main"][1], **serves[0])
    got = _unsharded()[case][0]
    assert got["tokens"] == [list(map(int, r.tokens)) for r in want.requests]
    assert got["host_syncs"] == want.host_syncs


def test_serve_result_mesh_fields_default_off():
    s = _setup()
    model, srcs = s["models"]["main"]
    res = ServingEngine(model, s["params"][("main", "fp")][0],
                        max_len=sh.MAX_LEN, device="cpu").serve(
        srcs[:2], n_slots=2, max_new_tokens=4)
    assert res.mesh_shape == () and res.tp_degree == 1
    assert res.replicas == 1 and res.collective_bytes_per_step == 0
    m = res.metrics()
    assert m["tp_degree"] == 1.0 and m["replicas"] == 1.0
    assert m["collective_bytes_per_step"] == 0.0


def test_serve_result_mesh_fields_on_mesh_tp1():
    """A (1, 1) mesh in this process (a world-size-1 gloo group) runs the
    whole placement path and equals the unsharded serve."""
    s = _setup()
    model, srcs = s["models"]["main"]
    fp = s["params"][("main", "fp")][0]
    kw = dict(max_len=sh.MAX_LEN, paged=True, page_size=sh.PAGE_SIZE,
              device="cpu")
    res = ServingEngine(model, fp, mesh=make_host_mesh(1, 1), **kw).serve(
        srcs, n_slots=sh.N_SLOTS, max_new_tokens=sh.BUDGETS)
    assert res.mesh_shape == (1, 1)
    assert res.tp_degree == 1
    assert res.collective_bytes_per_step == 0
    want = ServingEngine(model, fp, **kw).serve(
        srcs, n_slots=sh.N_SLOTS, max_new_tokens=sh.BUDGETS)
    assert [list(r.tokens) for r in res.requests] == \
        [list(r.tokens) for r in want.requests]
    assert res.host_syncs == want.host_syncs


class _Mesh:
    """A stand-in for a ``(1, tp)`` mesh: axis names and sizes only (the
    refusal comes before the engine touches a rank or a group)."""
    axis_names = ("data", "model")

    def __init__(self, tp):
        self.shape = {"data": 1, "model": tp}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b",
                                  "moe-6-experts-tp4"])
def test_mesh_refuses_other_families(arch):
    """The recurrent families, and MoE experts that do not divide the
    tensor axis (6 experts on 4 ranks: the reference would split their
    features, which needs a split K7), raise naming the ROADMAP item."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import build_model
    if arch.startswith("moe"):
        cfg = get_config("qwen3-moe-30b-a3b").reduced(
            moe=MoEConfig(n_experts=6, top_k=2, group_size=32))
        mesh = _Mesh(4)
    else:
        cfg = get_config(arch).reduced()
        mesh = make_host_mesh(1, 1)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="multi-GPU and the cost accounting"):
        ServingEngine(model, {}, device="cpu", mesh=mesh)
