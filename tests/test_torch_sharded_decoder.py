"""Tensor-parallel ``ServingEngine(mesh=...)`` for the decoder-only
attention families against the unsharded engine: the zoo's reduced dense
``mistral-nemo-12b`` (SwiGLU, rope, 4 query heads over 2 kv heads, so tp 4
takes the GQA fallback) and MoE ``qwen3-moe-30b-a3b`` (4 experts top-2, so
tp 4 puts one expert on a rank; a vocab of 128, split over the ranks and
tied), from ``tests/_torch_zoo.py``.

Ranks are spawned once per tp per file in gloo groups on the CPU
(``tests/_torch_sharded_decoder.py``, which imports no JAX); each runs
every case of its tp, and the tests read the cached results.  At tp 2 and
4, FP, INT8 dynamic and INT8 static, greedy ``generate`` and
``generate_beam`` at beam 2, one greedy case from ``embeds``, and INT4
weights at tp 2: every rank's tokens, steps and host syncs equal the
unsharded engine's exactly, and the first decode steps' logits equal them
within the tolerances below.  Two cases are also held to the reference's
unsharded engine.  A probe of ``moe_ffn`` shows each rank's expert
linears get exactly its experts' rows of the dispatch, and the layer's
output is the unsharded one bit for bit.
"""

import copy
import tempfile

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core.ptq import quantize_weight_block
from repro_torch.core.qtensor import BlockQTensor

import _torch_sharded_decoder as sd
from _torch_reference import import_reference_serving
from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    ATOL,
    decoder,
    first_divergence,
    one_torch_thread,
    prompts,
)

ZOO = {"dense": "mistral-nemo-12b", "moe": "qwen3-moe-30b-a3b"}
RANK_TIMEOUT_S = 240
# logits against the unsharded engine's: INT8 bit for bit but at tp 4 with
# dynamic scales, where the plain attention's float sums over one query
# head a rank round a last bit differently and a dynamic scale carries it
# into the logits (at most 2e-7 seen); FP within the zoo's tolerance
# (float partial sums over the ranks)
LOGIT_ATOL = {"fp": ATOL["fp"], "int8_dynamic": 1e-5, "int8_static": 1e-5,
              "int4": 1e-5}
_CACHED = {}


def _int4_tree(fp, int8):
    """The INT8 tree with every SwiGLU ``gate``/``up``/``down`` and
    ``o_proj`` weight block-wise INT4 (group 16).  The reference's policy
    drops only encoder-decoder sites to INT4, so the decoder-only tree is
    made here; the unsharded engine is the oracle."""
    out = copy.copy(int8)
    for key, block in fp.items():
        if not key.startswith("blocks."):
            continue
        qb = copy.deepcopy(int8[key])
        for node, names in (("ffn", ("gate", "up", "down")),
                            ("attn", ("o_proj",))):
            for n in names:
                qb[node][n]["w"] = quantize_weight_block(
                    block[node][n]["w"], group_size=16)
        out[key] = qb
    return out


def _setup():
    """The two models and their port trees, the prompts, an ``embeds``
    batch, and the expert probe's input."""
    if "setup" not in _CACHED:
        models, params = {}, {}
        for m, arch in ZOO.items():
            s = decoder(arch)
            models[m] = s["model"]
            for kind, (_, port) in s["sides"].items():
                params[(m, kind)] = port
        fp = params[("dense", "fp")][0]
        int8, ctx = params[("dense", "int8_dynamic")]
        params[("dense", "int4")] = (_int4_tree(fp, int8), ctx)
        toks, lens = prompts(seed=3, n=6)
        rng = np.random.default_rng(17)
        d = models["dense"].cfg.d_model
        embeds = (rng.standard_normal((4, 11, d)) * 0.5).astype(np.float32)
        probe_x = torch.as_tensor(
            rng.standard_normal((2, 20, models["moe"].cfg.d_model)) * 0.5,
            dtype=torch.float32)
        _CACHED["setup"] = {
            "models": models, "params": params,
            "batches": {"tokens": {"tokens": toks, "lengths": lens},
                        "embeds": {"embeds": embeds, "lengths": np.array(
                            [11, 7, 4, 9], np.int32)}},
            "probe_x": probe_x}
    return _CACHED["setup"]


def _unsharded():
    if "unsharded" not in _CACHED:
        s = _setup()
        _CACHED["unsharded"] = sd.run_cases(s, None)
        params, _ = s["params"][("moe", "int8_dynamic")]
        _CACHED["unsharded"]["probe"] = sd.expert_probe(
            s["models"]["moe"], params, s["probe_x"])
    return _CACHED["unsharded"]


def _ranks(tp):
    """Every rank's results at ``tp``: one spawn of ``tp`` gloo ranks per
    file (a ``file://`` rendezvous in a fresh directory); a rank's
    traceback fails the test."""
    key = ("ranks", tp)
    if key not in _CACHED:
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=sd.rank_main,
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


@pytest.mark.parametrize("tp,case", [(tp, c[0]) for tp in (2, 4)
                                     for c in sd.cases(tp)])
def test_sharded_decoder_equals_unsharded(tp, case):
    """Every rank's tokens, steps and host syncs equal the unsharded
    engine's, exactly."""
    want = _unsharded()[case]
    for r, got in enumerate(_ranks(tp)):
        g = got[case]
        assert g["tokens"] == want["tokens"], \
            (r, first_divergence(want["tokens"], g["tokens"]))
        assert (g["steps"], g["host_syncs"]) == \
            (want["steps"], want["host_syncs"]), r


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", sd.KINDS)
@pytest.mark.parametrize("model", sd.MODELS)
def test_sharded_decoder_logits(model, kind, tp):
    """The prefill's and the first decode steps' logits of every rank
    equal the unsharded engine's within ``LOGIT_ATOL``, and each other's
    bit for bit."""
    key = f"{model}-{kind}-logits"
    want = _unsharded()[key]
    ranks = _ranks(tp)
    for r, got in enumerate(ranks):
        for step, (g, w) in enumerate(zip(got[key], want)):
            assert g.shape == w.shape
            d = float(np.abs(g - w).max())
            assert d <= LOGIT_ATOL[kind], (r, step, d)
            assert np.array_equal(g, ranks[0][key][step]), (r, step)


@pytest.mark.parametrize("tp", [2, 4])
def test_experts_split_rows(tp):
    """On every rank the expert linears get exactly its ``E/tp`` experts'
    rows of the unsharded dispatch, gate and up the same rows, down their
    hidden rows; the gathered layer output equals the unsharded one bit
    for bit (INT8 dynamic: K2 codes and the K7 sums are per expert)."""
    y, rows = _unsharded()["probe"]
    E = rows["gate"].shape[0]
    n = E // tp
    for r, got in enumerate(_ranks(tp)):
        gy, grows = got["probe"]
        assert set(grows) == {"gate", "up", "down"}
        for site in ("gate", "up", "down"):
            assert grows[site].shape[0] == n, site
            assert np.array_equal(grows[site],
                                  rows[site][r * n:(r + 1) * n]), (r, site)
        assert np.array_equal(gy, y), r


@pytest.mark.parametrize("case", ["dense-int8_static-generate",
                                  "moe-int8_dynamic-generate_beam"])
def test_unsharded_cases_equal_the_reference_engine(case):
    """The cases the ranks are held to, held to the reference's unsharded
    engine: tokens, steps and host syncs, exactly."""
    _, mname, kind, call, _ = next(c for c in sd.cases(None)
                                   if c[0] == case)
    s = decoder(ZOO[mname])
    (jp, jctx), _ = s["sides"][kind]
    batch = _setup()["batches"]["tokens"]
    eng = import_reference_serving().ServingEngine(
        s["jmodel"], jp, quant=jctx, max_len=sd.MAX_LEN)
    want = (eng.generate(batch, max_new_tokens=sd.MAX_NEW)
            if call == "generate" else
            eng.generate_beam(batch, beam=sd.BEAM, max_new_tokens=sd.MAX_NEW))
    got = _unsharded()[case]
    wt = [list(map(int, t)) for t in want.tokens]
    assert got["tokens"] == wt, first_divergence(wt, got["tokens"])
    assert (got["steps"], got["host_syncs"]) == \
        (want.steps, want.host_syncs)


def test_int4_tree_has_block_weights():
    """The INT4 case runs INT4 weights: gate/up column-parallel, down and
    o_proj whole behind a gathered input."""
    tree, _ = _setup()["params"][("dense", "int4")]
    blk = tree["blocks.0"]
    assert all(isinstance(blk["ffn"][n]["w"], BlockQTensor)
               for n in ("gate", "up", "down"))
    assert isinstance(blk["attn"]["o_proj"]["w"], BlockQTensor)
