"""The port's training substrate against the JAX package, on numpy inputs
made from a seed: the LR schedules, AdamW, the cross entropy, the data
pipeline, the checkpointer (restored across packages both ways), the
watchdog and restart wrapper, and the rest of the quantizers
(``quantize_dynamic``, ``quantize_weight``, ``quantize_naive``,
``fake_quant``, ``fake_quant_dynamic``, ``quantize_tensor_minmax``,
``QuantContext.quantize_activations``, ``summarize``,
``reference_translation``).

No model here: the training step, the loop and the driver are in
``tests/test_torch_train.py``.
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantMode as JQuantMode
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import SiteCalibration as JSiteCalibration
from repro.core import Thresholds as JThresholds
from repro.core import fake_quant as jfake_quant
from repro.core import fake_quant_dynamic as jfake_quant_dynamic
from repro.core import quantize_dynamic as jquantize_dynamic
from repro.core import quantize_model as jquantize_model
from repro.core import quantize_naive as jquantize_naive
from repro.core import summarize as jsummarize
from repro.core.histogram import HistogramClass as JHistogramClass
from repro.core.ptq import QuantContext as JQuantContext
from repro.core.qtensor import quantize_tensor_minmax as jquantize_tensor_minmax
from repro.core.quantize import quantize_weight as jquantize_weight_axis
from repro.data import LMBatches as JLMBatches
from repro.data import Prefetcher as JPrefetcher
from repro.data import TranslationBatches as JTranslationBatches
from repro.data import make_corpus as jmake_corpus
from repro.data.synthetic import reference_translation as jreference_translation
from repro.distributed.fault import StepWatchdog as JStepWatchdog
from repro.distributed.fault import run_with_restarts as jrun_with_restarts
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import global_norm as jglobal_norm
from repro.optim import inverse_sqrt as jinverse_sqrt
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import softmax_cross_entropy as jsoftmax_cross_entropy

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.bridge import block_meta_of, params_from_flat
from repro_torch.core import (
    QuantMode,
    QuantPolicy,
    SiteCalibration,
    Thresholds,
    fake_quant,
    fake_quant_dynamic,
    quantize_dynamic,
    quantize_naive,
    summarize,
)
from repro_torch.core.histogram import HistogramClass
from repro_torch.core.ptq import QuantContext
from repro_torch.core.qtensor import BlockQTensor, QTensor, \
    quantize_tensor_minmax
from repro_torch.core.quantize import quantize_weight as quantize_weight_axis
from repro_torch.data import (
    LMBatches,
    Prefetcher,
    TranslationBatches,
    make_corpus,
    reference_translation,
)
from repro_torch.distributed import StepWatchdog, run_with_restarts
from repro_torch.optim import AdamW, AdamWState, global_norm, inverse_sqrt, \
    warmup_cosine
from repro_torch.train import softmax_cross_entropy
from repro_torch.tree import leaves_with_paths, tree_leaves


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "inverse_sqrt_512": (lambda m: m.inverse_sqrt(512), 5000, 4000),
    "inverse_sqrt_128_w200": (lambda m: m.inverse_sqrt(128, warmup=200),
                              1000, 200),
    "warmup_cosine_2_20": (lambda m: m.warmup_cosine(2e-3, 2, 20), 40, 2),
    "warmup_cosine_20_200": (lambda m: m.warmup_cosine(2e-3, 20, 200), 260,
                             20),
    "warmup_cosine_100_1000": (lambda m: m.warmup_cosine(1e-3, 100, 1000,
                                                         floor=0.05),
                               1100, 100),
}


class _Mod:
    """The schedule factories of one package under one attribute name."""

    def __init__(self, inverse_sqrt, warmup_cosine):
        self.inverse_sqrt, self.warmup_cosine = inverse_sqrt, warmup_cosine


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    """Every step 0…N, the port's schedule on a scalar int32 step (as the
    optimizer calls it) against the reference's, eager and jitted.

    inverse_sqrt: 0 ulp against both during warmup (the linear branch);
    past it, the inverse square root differs: XLA's float32 ``pow``/
    ``rsqrt`` and torch's ``rsqrt`` are each within an ulp of the correctly
    rounded value, so at most 2 ulp.  warmup_cosine: 0 ulp against the
    eager reference during warmup; past it, ``cos`` differs from XLA's in
    the last bit and ``1 + cos`` near −1 magnifies that, and the jitted
    reference turns its divisions by constants into products by their
    reciprocals (7–9 ulp from its own eager values here): at most 16 ulp
    (2e-6 relative)."""
    make, n, warmup = SCHEDULES[name]
    jf = make(_Mod(jinverse_sqrt, jwarmup_cosine))
    tf = make(_Mod(inverse_sqrt, warmup_cosine))
    steps = np.arange(n + 1, dtype=np.int32)
    got = np.array([tf(torch.tensor(int(s), dtype=torch.int32)).item()
                    for s in steps], np.float32)
    eager = np.array([np.asarray(jf(jnp.asarray(s))) for s in steps],
                     np.float32)
    jitted = np.asarray(jax.jit(jax.vmap(jf))(jnp.asarray(steps)))
    tol = 2 if name.startswith("inverse_sqrt") else 16
    assert _ulps(got[:warmup], eager[:warmup]).max() == 0
    assert _ulps(got, eager).max() <= tol
    assert _ulps(got, jitted).max() <= tol
    assert got.dtype == np.float32 and np.all(got >= 0)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _random_tree(rng):
    shapes = {"emb": {"table": (9, 4)}, "blocks.0": {"w": (4, 6),
              "b": (6,)}, "blocks.1": {"w": (2, 6, 3), "b": (3,)},
              "norm": {"scale": (4,)}}
    return {k: {n: rng.normal(size=s).astype(np.float32) * 0.5
                for n, s in v.items()} for k, v in shapes.items()}


def _to_torch(tree):
    return {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
            for k, v in tree.items()}


def _to_jax(tree):
    return {k: {n: jnp.asarray(a) for n, a in v.items()}
            for k, v in tree.items()}


def _np_leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in leaves_with_paths(tree)}


@pytest.mark.parametrize("clip_norm", [None, 1.0, 0.05])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("lr", ["float", "schedule"])
def test_adamw_update_matches_reference(rng, clip_norm, weight_decay, lr):
    """Three updates on a random tree: parameters, m and v, the step and the
    global norm against the reference's eager update.  Elementwise math is
    the reference's op for op; the bias-correction ``pow`` and the global
    norm's summation order may move the last bits, so the state is held to
    2e-6 relative to each leaf's largest value (a few float32 ulps)."""
    kw = dict(weight_decay=weight_decay, clip_norm=clip_norm, b2=0.98)
    jopt = JAdamW(lr=1e-2 if lr == "float" else jinverse_sqrt(64, warmup=3),
                  **kw)
    opt = AdamW(lr=1e-2 if lr == "float" else inverse_sqrt(64, warmup=3),
                **kw)
    params = _random_tree(rng)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), opt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for _ in range(3):
        grads = _random_tree(rng)
        jp, js = jopt.update(_to_jax(grads), js, jp)
        tp, ts = opt.update(_to_torch(grads), ts, tp)
        np.testing.assert_allclose(float(global_norm(_to_torch(grads))),
                                   float(jglobal_norm(_to_jax(grads))),
                                   rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    want = _np_leaves((jp, js.m, js.v))
    got = {k: v.numpy() for k, v in leaves_with_paths((tp, ts.m, ts.v))}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2e-6 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_adamw_decays_matrices_only(rng):
    """With zero gradients only the rank-≥2 leaves move (decay), and the
    inputs are left as they were."""
    opt = AdamW(lr=0.1, weight_decay=0.5, clip_norm=None)
    params = _to_torch(_random_tree(rng))
    before = {k: v.clone() for k, v in leaves_with_paths(params)}
    state = opt.init(params)
    zeros = {k: {n: torch.zeros_like(a) for n, a in v.items()}
             for k, v in params.items()}
    new, new_state = opt.update(zeros, state, params)
    for k, v in leaves_with_paths(new):
        assert torch.equal(dict(leaves_with_paths(params))[k], before[k])
        moved = not torch.equal(v, before[k])
        assert moved == (v.dim() >= 2), k
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert isinstance(new_state, AdamWState)


def test_adamw_reduces_quadratic():
    """The reference's ``test_adamw_reduces_quadratic`` case in the port."""
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(100):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state = opt.update({"w": g}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


# ---------------------------------------------------------------------------
# the cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["ones", "random", "padded_rows",
                                       "empty"])
def test_softmax_cross_entropy_matches_reference(rng, mask_kind):
    """Mean CE over a mask against the reference's, with its gradient
    w.r.t. the logits (float32, 1e-6 relative)."""
    B, S, V = 3, 7, 11
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = {"ones": np.ones((B, S)),
            "random": rng.random((B, S)) < 0.6,
            "padded_rows": np.arange(S)[None, :] < np.array([[7], [3], [1]]),
            "empty": np.zeros((B, S))}[mask_kind].astype(np.float32)
    jl, jg = jax.value_and_grad(jsoftmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = softmax_cross_entropy(x, torch.from_numpy(labels),
                               torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tl, [x])
    tl = tl.detach()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    if mask_kind == "empty":
        assert float(tl) == 0.0


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("sort_mode", ["none", "words", "tokens"])
def test_translation_batches_match_reference(sort_mode):
    """50 batches of 8 over a 64-sentence corpus (several epochs) equal the
    reference's, and a stream resumed from any ``state_dict`` continues on
    the reference's next batch."""
    corpus = make_corpus(64, 64, seed=3)
    jcorpus = jmake_corpus(64, 64, seed=3)
    a = TranslationBatches(corpus, 8, sort_mode=sort_mode, seed=5)
    ja = JTranslationBatches(jcorpus, 8, sort_mode=sort_mode, seed=5)
    states, want = [], []
    for _ in range(50):
        states.append(a.state_dict())
        assert states[-1] == ja.state_dict()
        want.append(ja.next_batch())
        _assert_batches_equal(a.next_batch(), want[-1])
    assert a.epoch >= 5
    for i in (0, 7, 8, 23, 49):
        b = TranslationBatches(corpus, 8, sort_mode=sort_mode, seed=0)
        b.load_state_dict(states[i])
        _assert_batches_equal(b.next_batch(), want[i])


def test_lm_batches_match_reference():
    a, ja = LMBatches(97, 4, 16, seed=2), JLMBatches(97, 4, 16, seed=2)
    states, want = [], []
    for _ in range(50):
        states.append(a.state_dict())
        want.append(ja.next_batch())
        _assert_batches_equal(a.next_batch(), want[-1])
    for i in (0, 13, 49):
        b = LMBatches(97, 4, 16)
        b.load_state_dict(states[i])
        _assert_batches_equal(b.next_batch(), want[i])


def test_prefetcher_yields_the_same_sequence_and_stops():
    """A finite iterator through the port's and the reference's Prefetcher:
    the same items in order, then StopIteration; after ``close`` an endless
    one ends once the consumer has taken what its queue held."""
    corpus = make_corpus(40, 64, seed=1)
    src = TranslationBatches(corpus, 8, seed=1)
    jsrc = JTranslationBatches(jmake_corpus(40, 64, seed=1), 8, seed=1)
    items = [src.next_batch() for _ in range(12)]
    jitems = [jsrc.next_batch() for _ in range(12)]
    got = list(Prefetcher(iter(items), depth=2))
    want = list(JPrefetcher(iter(jitems), depth=2))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    endless = Prefetcher(iter(src), depth=2)
    next(endless)
    endless.close()
    assert len(list(endless)) <= 3
    endless._thread.join(timeout=5)
    assert not endless._thread.is_alive()


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(rng):
    tree = {"w": torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32)),
            "nested": {"b": torch.arange(3), "h": torch.ones(
                2, dtype=torch.bfloat16)}}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for step in (1, 2, 3):
            ck.save(step, tree, extra={"k": step})
        assert ck.all_steps() == [2, 3]
        out = ck.restore(tree)
        for k, v in leaves_with_paths(tree):
            got = dict(leaves_with_paths(out))[k]
            assert got.dtype == v.dtype and torch.equal(got, v), k
        assert ck.read_meta()["extra"] == {"k": 3}
        assert ck.read_meta(2)["step"] == 2


def test_checkpoint_async_save_and_no_visible_tmp(rng):
    tree = {"w": torch.zeros(8)}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_save=True)
        for step in (7, 8):
            ck.save(step, {"w": tree["w"] + step})
        ck.wait()
        assert not any(n.startswith("tmp") for n in os.listdir(d))
        assert ck.latest_step() == 8
        assert torch.equal(ck.restore(tree)["w"], torch.full((8,), 8.0))
        assert torch.equal(ck.restore(tree, step=7)["w"], torch.full((8,), 7.))
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            Checkpointer(d).restore(tree)
        Checkpointer(d).save(1, {"x": torch.zeros(1)})
        with pytest.raises(KeyError, match="missing leaf w"):
            Checkpointer(d).restore(tree)


def _reduced_enc_dec():
    """A reduced enc-dec model's reference params and their port copy."""
    jcfg = jget_config("transformer-base").reduced()
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    return jparams, params_from_flat(_flatten_with_paths(jparams),
                                     device="cpu")


def _opt_states():
    jopt, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    return jopt, opt


def test_checkpoint_keys_are_the_references():
    """``(params, AdamWState)`` is written under the reference's keys
    (``0/...``, ``1/.step``, ``1/.m/...``, ``1/.v/...``)."""
    jparams, params = _reduced_enc_dec()
    jopt, opt = _opt_states()
    want = _flatten_with_paths((jparams, jopt.init(jparams)))
    got = dict(leaves_with_paths((params, opt.init(params))))
    assert set(got) == set(want)
    assert "1/.step" in got and "1/.m/dec_blocks.0/ffn/in/w" in got
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_cross_restore(rng, writer):
    """One package writes ``(params, opt_state)`` after a perturbation, the
    other restores it into its own tree: every leaf equal, dtypes kept."""
    jparams, params = _reduced_enc_dec()
    jopt, opt = _opt_states()
    jstate, state = jopt.init(jparams), opt.init(params)
    noise = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in _flatten_with_paths(jparams).items()}
    # the written tree: params + noise, m = noise, v = noise², step 5
    jtree = (jax.tree_util.tree_map_with_path(
        lambda p, a: a + noise["/".join(str(getattr(q, "key", q))
                                        for q in p)], jparams),
        jstate._replace(step=jnp.asarray(5, jnp.int32)))
    ttree = (params, state._replace(step=torch.tensor(5, dtype=torch.int32)))
    tp = dict(leaves_with_paths(ttree[0]))
    for k, v in tp.items():
        v.add_(torch.from_numpy(noise[k]))
    with tempfile.TemporaryDirectory() as d:
        if writer == "reference":
            JCheckpointer(d).save(3, jtree, extra={"data_state": {"e": 1}})
            out = Checkpointer(d).restore((params, opt.init(params)))
            meta = Checkpointer(d).read_meta()
            want = _flatten_with_paths(jtree)
            got = {k: v for k, v in leaves_with_paths(out)}
        else:
            Checkpointer(d).save(3, ttree, extra={"data_state": {"e": 1}})
            out = JCheckpointer(d).restore((jparams, jopt.init(jparams)))
            meta = JCheckpointer(d).read_meta()
            want = {k: v.numpy() for k, v in leaves_with_paths(ttree)}
            got = {k: torch.from_numpy(np.array(v)) for k, v in
                   _flatten_with_paths(out).items()}
    assert meta["step"] == 3 and meta["extra"]["data_state"] == {"e": 1}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["1/.step"]) == 5


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_quantized_tree_cross_restore(writer):
    """A quantized tree (INT8 ``QTensor`` and INT4 ``BlockQTensor``
    weights) written by one package restores into the other's, bit for
    bit."""
    jcfg = jget_config("transformer-base").reduced()
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    jq, _ = jquantize_model(jparams, {}, JQuantPolicy(act_quant="dynamic"),
                            weight_bits=4, weight_group_size=32)
    tq = params_from_flat(_flatten_with_paths(jq), device="cpu",
                          block_meta=block_meta_of(jq))
    n_block = sum(isinstance(n.get("w"), BlockQTensor) for n in
                  _nodes(tq))
    n_int8 = sum(isinstance(n.get("w"), QTensor) for n in _nodes(tq))
    assert n_block > 0 and n_int8 > 0
    with tempfile.TemporaryDirectory() as d:
        if writer == "reference":
            JCheckpointer(d).save(1, jq)
            out = Checkpointer(d).restore(tq)
        else:
            Checkpointer(d).save(1, tq)
            out = params_from_flat(
                _flatten_with_paths(JCheckpointer(d).restore(jq)),
                device="cpu", block_meta=block_meta_of(jq))
    want = _flatten_with_paths(jq)
    got = dict(leaves_with_paths(out))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for a, b in zip(_nodes(out), _nodes(tq)):
        if isinstance(b.get("w"), BlockQTensor):
            assert (a["w"].group_size, a["w"].k_dim) == (
                b["w"].group_size, b["w"].k_dim)


def _nodes(tree):
    """Every dict node of a nested tree."""
    out = [tree]
    for v in tree.values():
        if isinstance(v, dict):
            out.extend(_nodes(v))
    return out


# ---------------------------------------------------------------------------
# the watchdog and the restart wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [
    [0.01] * 8 + [0.2],
    [0.01, 0.02, 0.01, 0.5, 0.01, 0.01, 0.03, 0.2, 0.01, 0.09],
    [0.1] * 60 + [0.3, 0.1, 0.26],
])
def test_watchdog_matches_reference(seq):
    """The same durations give the same straggler flags and summary."""
    wd, jwd = StepWatchdog(threshold=2.5, window=50), \
        JStepWatchdog(threshold=2.5, window=50)
    flags = [wd.observe(dt) for dt in seq]
    assert flags == [jwd.observe(dt) for dt in seq]
    assert wd.summary() == jwd.summary()
    assert wd.straggler_steps == jwd.straggler_steps
    assert StepWatchdog().summary() == JStepWatchdog().summary() == \
        {"steps": 0}


def test_watchdog_flags_straggler():
    """The reference's ``test_watchdog_flags_straggler`` case: timed steps
    through ``start``/``stop``."""
    wd = StepWatchdog(threshold=2.0)
    for _ in range(8):
        wd.start()
        time.sleep(0.002)
        wd.stop()
    wd.start()
    time.sleep(0.05)
    assert wd.stop() is True
    assert wd.summary()["stragglers"] >= 1
    assert wd.summary()["steps"] == 9


def test_watchdog_stop_without_start_raises():
    for cls in (StepWatchdog, JStepWatchdog):
        wd = cls()
        with pytest.raises(RuntimeError, match="without start"):
            wd.stop()
        wd.start()
        wd.stop()
        with pytest.raises(RuntimeError, match="without start"):
            wd.stop()


@pytest.mark.parametrize("fails,max_restarts,exc", [
    (2, 5, RuntimeError), (0, 0, RuntimeError), (3, 2, OSError),
    (1, 3, ValueError)])
def test_run_with_restarts_matches_reference(fails, max_restarts, exc):
    """Retries on the retryable errors up to ``max_restarts``, calls
    ``on_restart`` each time, re-raises past the limit, and lets other
    errors through at once, as the reference does."""
    def outcome(runner):
        calls, restarts = {"n": 0}, []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise exc("preempted")

        try:
            runner(flaky, max_restarts=max_restarts,
                   on_restart=lambda a, e: restarts.append((a, str(e))))
            raised = None
        except Exception as e:          # the outcome is compared
            raised = type(e)
        return calls["n"], restarts, raised

    assert outcome(run_with_restarts) == outcome(jrun_with_restarts)


def test_run_with_restarts_retries():
    """The reference's ``test_run_with_restarts_retries`` case."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("preempted")

    run_with_restarts(flaky, max_restarts=5)
    assert calls["n"] == 3


# ---------------------------------------------------------------------------
# the rest of the quantizers
# ---------------------------------------------------------------------------

def _x(rng, shape=(6, 10), scale=2.0, shift=0.3):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _assert_qtensor_equal(got: QTensor, want):
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    for g, w in ((got.scale, want.scale), (got.zero_point, want.zero_point)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.float32(g)
        np.testing.assert_array_equal(np.broadcast_to(g, np.shape(w)),
                                      np.asarray(w))
    assert got.axis == want.axis


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_dynamic_matches_reference(rng, axis):
    x = _x(rng)
    _assert_qtensor_equal(quantize_dynamic(torch.from_numpy(x), axis=axis),
                          jquantize_dynamic(jnp.asarray(x), axis=axis))
    np.testing.assert_array_equal(
        fake_quant_dynamic(torch.from_numpy(x), axis=axis).numpy(),
        np.asarray(jfake_quant_dynamic(jnp.asarray(x), axis=axis)))


@pytest.mark.parametrize("channel_axis", [-1, 0])
def test_quantize_weight_by_axis_matches_reference(rng, channel_axis):
    w = _x(rng, (12, 5), scale=0.1, shift=0.0)
    _assert_qtensor_equal(
        quantize_weight_axis(torch.from_numpy(w), channel_axis=channel_axis),
        jquantize_weight_axis(jnp.asarray(w), channel_axis=channel_axis))


@pytest.mark.parametrize("axis", [None, 1])
def test_quantize_naive_and_minmax_match_reference(rng, axis):
    x = _x(rng, shift=1.5)
    want = jquantize_naive(jnp.asarray(x), axis=axis)
    _assert_qtensor_equal(quantize_naive(torch.from_numpy(x), axis=axis),
                          want)
    _assert_qtensor_equal(
        quantize_tensor_minmax(torch.from_numpy(x), axis=axis),
        jquantize_tensor_minmax(jnp.asarray(x), axis=axis))
    np.testing.assert_array_equal(
        quantize_naive(torch.from_numpy(x), axis=axis).dequantize().numpy(),
        np.asarray(want.dequantize()))


@pytest.mark.parametrize("thr", [(-1.5, 1.5), (-0.7, 2.2), (0.0, 3.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_matches_reference(rng, thr, dtype):
    """The quantize → dequantize round trip, symmetric and affine
    thresholds, in the input's dtype."""
    x = _x(rng)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = fake_quant(tx, Thresholds(*thr))
    want = jfake_quant(jx, JThresholds(*thr))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _calib(cls, hcls, name, kind="dense", quantize=True):
    return cls(name=name, thresholds=(Thresholds if cls is SiteCalibration
                                      else JThresholds)(-1.0, 1.0),
               classification=hcls(kind=kind, zero_fraction=0.1,
                                   occupancy=0.9, p999_over_amax=0.5),
               quantize=quantize)


SITES = {"dec_blocks.0/self_attn/q_proj": ("dense", True),
         "dec_blocks.1/ffn/in": ("sparse", True),
         "blocks.0/moe/router": ("dense", True),
         "enc_blocks.0/attn/o_proj": ("dense", False),
         "logits": ("dense", True)}


@pytest.mark.parametrize("policy", [
    dict(), dict(act_quant="dynamic"), dict(mode="none"),
    dict(mode="naive"), dict(skip_sparse=False),
    dict(allow_only=("dec_blocks.*",))])
@pytest.mark.parametrize("enabled", [True, False])
def test_quantize_activations_and_summarize_match_reference(policy, enabled):
    """``QuantContext.quantize_activations`` for calibrated, uncalibrated,
    sparse, denied and layer-agnostic sites, and ``summarize`` of the
    calibrations, against the reference's."""
    kw = dict(policy)
    if "mode" in kw:
        kw_t = dict(kw, mode=QuantMode(kw["mode"]))
        kw_j = dict(kw, mode=JQuantMode(kw["mode"]))
    else:
        kw_t = kw_j = kw
    recs = {s: _calib(SiteCalibration, HistogramClass, s, k, q)
            for s, (k, q) in SITES.items()}
    jrecs = {s: _calib(JSiteCalibration, JHistogramClass, s, k, q)
             for s, (k, q) in SITES.items()}
    ctx = QuantContext(policy=QuantPolicy(**kw_t), calibrations=dict(recs),
                       enabled=enabled)
    jctx = JQuantContext(policy=JQuantPolicy(**kw_j),
                         calibrations=dict(jrecs), enabled=enabled)
    queries = list(SITES) + ["dec_blocks.*/self_attn/q_proj",
                             "dec_blocks.3/self_attn/q_proj",
                             "enc_blocks.1/ffn/out", "blocks.2/moe/router"]
    assert [ctx.quantize_activations(s) for s in queries] == \
        [jctx.quantize_activations(s) for s in queries]
    assert summarize(QuantPolicy(**kw_t), recs) == \
        jsummarize(JQuantPolicy(**kw_j), jrecs)


def test_reference_translation_matches_reference():
    for vocab in (64, 37000):
        src = np.asarray([3, 4, 17, vocab - 1, 60 % vocab], np.int32)
        got = reference_translation(src, vocab)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jreference_translation(src, vocab))
    corpus = make_corpus(5, 64, seed=0)
    for s in corpus:
        np.testing.assert_array_equal(reference_translation(s.src, 64), s.tgt)


def test_tree_helpers_follow_jax_order():
    """``tree_leaves`` gives ``jax.tree_util.tree_leaves``'s order (dict
    keys sorted) on a mixed tree."""
    tree = {"b": [torch.tensor(1.0), {"z": torch.tensor(2.0),
                                      "a": torch.tensor(3.0)}],
            "a": (torch.tensor(4.0), None)}
    jtree = {"b": [1.0, {"z": 2.0, "a": 3.0}], "a": (4.0, None)}
    assert [float(x) for x in tree_leaves(tree)] == \
        jax.tree_util.tree_leaves(jtree)
