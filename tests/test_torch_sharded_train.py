"""``make_train_step(grad_shardings=...)`` on ``(data, model)`` meshes of
gloo ranks on the CPU: FSDP × tensor parallel, with the vocab-parallel
cross-entropy, against the unsharded step.

Three reduced families, each from the reference's ``model.init(PRNGKey(0))``
carried across with ``checkpoint/bridge.py``: the enc-dec translation model
(``trained_nmt``'s configuration, on ``TranslationBatches``), and dense
decoders with a GELU FFN (reduced ``granite-moe-1b-a400m`` without experts)
and with SwiGLU (reduced ``mistral-nemo-12b``, 4 query heads over 2 kv
heads, from ``tests/_torch_zoo.py``), on ``LMBatches``.  Meshes ``(2, 1)``
and ``(1, 2)`` run in one spawn of 2 ranks, ``(2, 2)`` and, for the SwiGLU
model alone, ``(1, 4)`` (its kv heads do not divide 4: the GQA fallback) and
a ``(pod, data, model)`` mesh of ``(1, 2, 2)`` (two batch axes, taken
together) in one spawn of 4 (``tests/_torch_sharded_train.py``, which
imports no JAX).

* Each family's plain run (3 steps) is held to the reference's unsharded
  ``jax.jit(make_train_step(...))`` on the same global batches.
* The ``accum_steps=2``, ``mixed_precision`` and active-clip runs (one step
  each) are held to the port's unsharded step, which
  ``tests/test_torch_train.py`` holds to the reference.

Tolerances are ``tests/test_torch_train.py``'s: loss and metrics 1e-5
relative (the gradient norm 5e-3 under ``mixed_precision``); every gradient
leaf, read as the first moment ``0.1 ×`` the clipped gradient after the
first step, by the per-leaf rule ``|Δ| ≤ rel·max|g| + 1e-8·‖g‖`` (rel 1e-4,
2e-2 under ``mixed_precision``); the gathered parameters after each step by
``_assert_params_close``'s rule, with the learning rates summed over the
steps so far and the tight bound only where the first moment has been far
above its tolerance at every step so far (an element whose gradient is
within its tolerance of zero may step either way at that step, and carries
the difference on).
"""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.data import LMBatches, TranslationBatches, make_corpus
from repro_torch.distributed.sharding import (
    MESH_ITEM,
    TreeSharding,
    param_specs,
)
from repro_torch.launch.specs import train_arg_specs
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves

import _torch_sharded_train as st

# (arch, reduced() overrides) of each family; the enc-dec one is the
# trained_nmt fixture's configuration (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)
FAMILIES = {"encdec": ("transformer-base", NMT),
            "gelu": ("granite-moe-1b-a400m", dict(moe=None, ffn="gelu")),
            "swiglu": ("mistral-nemo-12b", {})}
RANK_TIMEOUT_S = 240
_CACHED = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the reference's XLA threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup():
    """``{family: (port config, port params, batches)}`` and the reference
    side ``{family: (model, params)}``."""
    if "setup" not in _CACHED:
        port, ref = {}, {}
        for f, (arch, kw) in FAMILIES.items():
            jmodel = jbuild_model(jget_config(arch).reduced(**kw))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            cfg = get_config(arch).reduced(**kw)
            params = params_from_flat(_flatten_with_paths(jparams),
                                      device="cpu")
            src = (TranslationBatches(make_corpus(400, 64, max_words=5,
                                                  seed=0), 32, seed=0)
                   if f == "encdec" else LMBatches(cfg.vocab, 8, 16))
            port[f] = (cfg, params, [src.next_batch()
                                     for _ in range(st.STEPS)])
            ref[f] = (jmodel, jparams)
        _CACHED["setup"] = (port, ref)
    return _CACHED["setup"]


def _reference(family):
    """The reference's jitted unsharded plain run: each step's metrics,
    flattened parameters and first moment."""
    key = ("reference", family)
    if key not in _CACHED:
        port, ref = _setup()
        jmodel, jparams = ref[family]
        batches = port[family][2]
        jopt = JAdamW(lr=jwarmup_cosine(2e-3, 2, 20))
        jstep = jax.jit(jmake_train_step(jmodel, jopt))
        p, s = jparams, jopt.init(jparams)
        out = {"metrics": [], "params": [], "m": []}
        for b in batches[:st.VARIANTS["plain"][2]]:
            (p, s), m = jstep(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["params"].append({k: np.asarray(v) for k, v in
                                  _flatten_with_paths(p).items()})
            out["m"].append({k: np.asarray(v) for k, v in
                             _flatten_with_paths(s.m).items()})
        _CACHED[key] = out
    return _CACHED[key]


def _unsharded(family, variant):
    key = ("unsharded", family, variant)
    if key not in _CACHED:
        cfg, params, batches = _setup()[0][family]
        _CACHED[key] = st.run_unsharded(cfg, params, batches, variant)
    return _CACHED[key]


def _ranks(world):
    """Every rank's results of one spawn of ``world`` ranks."""
    key = ("ranks", world)
    if key not in _CACHED:
        got, codes = st.spawn(st.train_main, world, _setup()[0],
                              RANK_TIMEOUT_S)
        for r, res in enumerate(got):
            if isinstance(res, str):
                pytest.fail(f"rank {r} of {world} failed:\n{res}")
        assert codes == [0] * world, codes
        _CACHED[key] = got
    return _CACHED[key]


def _assert_grads_close(got: dict, want: dict, rel: float):
    """``|Δ| ≤ rel·max|g| + 1e-8·‖g‖`` leaf by leaf."""
    assert set(got) == set(want)
    norm = float(np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                             for v in want.values())))
    for k in want:
        w = np.asarray(want[k], np.float32)
        tol = rel * np.abs(w).max() + 1e-8 * norm
        assert np.abs(got[k] - w).max() <= tol, \
            (k, np.abs(got[k] - w).max(), tol)


def _assert_params_close(got: dict, want: dict, want_m: dict, lr: float,
                         rel: float, sure_so_far: dict):
    """Within ``1e-2·lr`` where the first moment has been 100 times its
    tolerance or more at every step so far (``sure_so_far``, updated
    here), ``2.5·lr`` elsewhere, ``1e-6·max|p|`` on top; ``lr``: the
    learning rates summed over the steps so far."""
    assert set(got) == set(want)
    norm = float(np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                             for v in want_m.values())))
    for k, v in got.items():
        w, m = np.asarray(want[k]), np.abs(np.asarray(want_m[k]))
        err = np.abs(v - w)
        pad = 1e-6 * np.abs(w).max()
        sure = m > 100 * (rel * m.max() + 1e-8 * norm)
        sure = sure_so_far[k] = sure & sure_so_far.get(k, True)
        assert err.max() <= 2.5 * lr + pad, (k, err.max() / lr)
        assert not sure.any() or err[sure].max() <= 1e-2 * lr + pad, \
            (k, err[sure].max() / lr)


def _assert_run_close(got: dict, want: dict, mixed: bool):
    """Every step's metrics, gathered parameters and first moment."""
    rel = 2e-2 if mixed else 1e-4
    assert len(got["metrics"]) == len(want["metrics"])
    lr, sure_so_far = 0.0, {}
    for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        assert sorted(gm) == sorted(wm) == ["ce_loss", "grad_norm",
                                             "load_balance_loss", "loss",
                                             "lr"]
        for k in wm:
            rtol = 5e-3 if mixed and k == "grad_norm" else 1e-5
            np.testing.assert_allclose(gm[k], wm[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")
        lr += wm["lr"]
        if i == 0:
            _assert_grads_close(got["m"][i], want["m"][i], rel)
        _assert_params_close(got["params"][i], want["params"][i],
                             want["m"][i], lr, rel, sure_so_far)


def _world(case: str) -> int:
    return next(w for w in (2, 4) if case in [c[0] for c in st.cases(w)])


def _plain_cases():
    return [(c[0], c[1]) for w in (2, 4) for c in st.cases(w)
            if c[3] == "plain"]


@pytest.mark.parametrize("case,family", _plain_cases())
def test_sharded_plain_run_matches_reference(case, family):
    """Three steps on the mesh: the metrics (equal on every rank), every
    gradient leaf and the gathered parameters after each step against the
    reference's unsharded jitted step."""
    _assert_run_close(_ranks(_world(case))[0][case], _reference(family),
                      False)


@pytest.mark.parametrize("case,family,variant", [
    (c[0], c[1], c[3]) for w in (2, 4) for c in st.cases(w)
    if c[3] != "plain"])
def test_sharded_variant_matches_unsharded(case, family, variant):
    """``accum_steps=2``, ``mixed_precision`` and an active clip on the
    mesh against the port's unsharded step."""
    got = _ranks(_world(case))[0][case]
    want = _unsharded(family, variant)
    if variant == "clip":
        assert want["metrics"][0]["grad_norm"] > st.CLIP_NORM
    _assert_run_close(got, want, variant == "mixed")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_unsharded_plain_run_matches_reference(family):
    """The port's unsharded plain run, the variants' oracle, over the same
    three steps against the reference."""
    _assert_run_close(_unsharded(family, "plain"), _reference(family), False)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_reports_the_same_metrics(world):
    """``loss``, ``ce_loss``, ``grad_norm`` and ``lr`` are equal on every
    rank, bit for bit."""
    ranks = _ranks(world)
    for name, *_ in st.cases(world):
        for r in range(1, world):
            assert ranks[r][name]["metrics"] == ranks[0][name]["metrics"], \
                (name, r)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(st.COLLECTIVES))
def test_collective_forward_and_backward(name, world):
    """Each autograd-visible collective on every rank: its output, and the
    gradient at its input of ``sum(output · upstream)`` with another
    upstream on each rank (``fsdp_gather``: the SUM of the upstreams' row
    blocks of this rank; ``tp_enter``: their SUM; ``tp_row_sum``: this
    rank's upstream; ``vocab_gather``: this rank's columns of it;
    ``tp_gather``: this rank's rows of it; ``tp_split``, this rank's
    columns of its input: the upstreams side by side; ``data_sum``: the
    SUM of the upstreams)."""
    xs = [st.probe_input(r) for r in range(world)]
    n = 4 // world
    want_y = {"fsdp_gather": lambda r: torch.cat(xs, 0),
              "tp_enter": lambda r: xs[r],
              "tp_row_sum": lambda r: sum(xs),
              "vocab_gather": lambda r: torch.cat(xs, -1),
              "tp_gather": lambda r: torch.cat(xs, 0),
              "tp_split": lambda r: xs[r][:, n * r:n * r + n],
              "data_sum": lambda r: sum(xs)}[name]
    ups = [st.probe_upstream(r, want_y(r).shape) for r in range(world)]
    want_g = {"fsdp_gather": lambda r: sum(u[3 * r:3 * r + 3] for u in ups),
              "tp_enter": lambda r: sum(ups),
              "tp_row_sum": lambda r: ups[r],
              "vocab_gather": lambda r: ups[r][:, 4 * r:4 * r + 4],
              "tp_gather": lambda r: ups[r][3 * r:3 * r + 3],
              "tp_split": lambda r: torch.cat(ups, -1),
              "data_sum": lambda r: sum(ups)}[name]
    for r, res in enumerate(_ranks(world)):
        y, g = res["collectives"][name]
        np.testing.assert_allclose(y, want_y(r).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(g, want_g(r).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_gather_params_inverts_shard_params(world):
    """``gather_params(shard_params(p))`` is ``p`` exactly on every rank,
    every family and mesh."""
    for r, res in enumerate(_ranks(world)):
        for name, *_ in st.cases(world):
            assert res[name]["roundtrip"], (name, r)


def test_train_arg_specs():
    """Parameters by ``param_specs`` with the mesh's FSDP axes and the
    config's kv heads, AdamW's moments mirroring them, the step counter
    replicated, the batch rows over the data axis."""
    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

    cfg, params, batches = _setup()[0]["swiglu"]
    p, o, b = train_arg_specs(cfg, params, batches[0], Mesh())
    assert p == param_specs(params, Mesh(), tensor="model", fsdp=("data",),
                            kv_heads=cfg.n_kv_heads)
    assert o.step == () and o.m is p and o.v is p
    assert b == {"tokens": (("data",), None), "labels": (("data",), None)}
    q = p["blocks.0"]["attn"]["q_proj"]["w"]
    assert q == (("data",), "model")


class _OnePlace:
    """A ``(1, 1)`` mesh of this process alone: every group of one rank,
    so every collective is the identity."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}
    coords = {"data": 0, "model": 0}

    def group(self, axis):
        return None


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b",
                                  "xlstm-1.3b"])
def test_mesh_step_refuses_moe_and_recurrent(arch):
    """The recurrent families' mesh step is refused, naming the ROADMAP
    item; MoE's runs (``tests/test_torch_mesh_train.py`` on 2 and 4
    ranks): on a mesh of one place its step is the unsharded step, bit for
    bit."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    if cfg.moe is None:
        with pytest.raises(NotImplementedError, match=MESH_ITEM):
            make_train_step(model, AdamW(),
                            grad_shardings=TreeSharding(None, None))
        return
    params = model.init(torch.Generator().manual_seed(0))
    batch = LMBatches(cfg.vocab, 8, 16).next_batch()
    specs = train_arg_specs(cfg, params, batch, _OnePlace())[0]
    opt = AdamW()
    got = make_train_step(model, opt, grad_shardings=TreeSharding(
        _OnePlace(), specs))(params, opt.init(params), batch)
    want = make_train_step(model, opt)(params, opt.init(params), batch)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_a_step_leaves_no_reference_cycles():
    """A training step frees its trees as it goes: no cyclic garbage is
    left for the collector (a cycle that held a list of leaves kept a
    whole tree of card memory alive until the collector ran)."""
    cfg, params, batches = _setup()[0]["swiglu"]
    opt = AdamW()
    step = make_train_step(build_model(cfg, device="cpu"), opt)
    state = opt.init(params)
    gc.collect()
    gc.disable()
    try:
        step(params, state, batches[0])
        assert gc.collect() == 0
    finally:
        gc.enable()
