"""A sharded training job as the reference runs its published configs, on
``(data, model)`` meshes of gloo ranks on the CPU: whole-array checkpoints
of a mesh run with elastic restore, ``remat`` (each block recomputed in
the backward), a gather a layer, the sequence-split residual, and MoE on
a training mesh.

One spawn of 2 ranks (meshes ``(2, 1)`` and ``(1, 2)``) and one of 4
(``(2, 2)``), through ``tests/_torch_mesh_train.py``, which imports no JAX;
the reference's runs and checkpointer run in this process.
``tests/test_torch_sharded_train.py`` holds every family of the dense
mesh step, which now runs a gather a layer and the sequence-split
residual, to the reference on ``(2, 1)``, ``(1, 2)``, ``(2, 2)``, ``(1,
4)`` and ``(1, 2, 2)``; this file adds:

* the checkpoint of a ``(2, 1)`` ``train_loop``: whole arrays, with the
  unsharded run's keys, shapes and dtypes, read by the reference's
  ``Checkpointer``; restored onto ``(1, 2)``, ``(1, 1)`` and unsharded and
  back onto ``(2, 1)``, each taking a further step within
  ``tests/test_torch_sharded_train.py``'s tolerances of the unsharded run;
  async save and retention on the mesh; the reference's checkpoint
  restored onto both meshes bit for bit;
* ``remat`` on against off bit for bit, unsharded (enc-dec, SwiGLU, MoE)
  and on ``(1, 2)``, and no cyclic garbage from a remat step;
* the sequence-split step against the same step with the residual whole:
  the loss and every gradient bit for bit but the norms' parameters,
  whose sums over the rows split across the ranks; and a sequence length
  the tensor axis does not divide (the stream whole);
* MoE on ``(2, 1)``, ``(1, 2)`` and ``(2, 2)`` against the unsharded step,
  the dropped fraction of every layer too; rows that are not whole routing
  groups refused;
* each family at ``reduced(n_layers=3, remat=True)`` on ``(2, 2)`` against
  the reference's jitted step at ``reduced(n_layers=3, scan_layers=True,
  remat=True)``, its stacked tree carried across by the bridge.
"""

import atexit
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import LMBatches
from repro_torch.distributed import context
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train import make_loss_fn, make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

import _torch_mesh_train as mt
import _torch_sharded_train as st
from test_torch_sharded_train import (
    NMT,
    _assert_grads_close,
    _assert_params_close,
    _assert_run_close,
)

# family -> (arch, reduced() overrides); the "3" families at the
# reference's published execution settings, three layers deep
FAMILIES = {
    "encdec": ("transformer-base", NMT),
    "swiglu": ("mistral-nemo-12b", {}),
    "moe": ("granite-moe-1b-a400m", {}),
    "encdec3": ("transformer-base", dict(NMT, n_layers=3, n_enc_layers=3)),
    "gelu3": ("granite-moe-1b-a400m", dict(moe=None, ffn="gelu",
                                           n_layers=3)),
    "swiglu3": ("mistral-nemo-12b", dict(n_layers=3)),
    "moe3": ("granite-moe-1b-a400m", dict(n_layers=3)),
}
STEPS = 3
RANK_TIMEOUT_S = 240
_CACHED = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the reference's XLA threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scanned(family) -> bool:
    return family.endswith("3")


def _setup():
    """``{family: (port config, port params, batches)}`` with the
    checkpoint directories, and the reference side ``{family: (model,
    params)}``."""
    if "setup" not in _CACHED:
        port, ref = {}, {}
        for f, (arch, kw) in FAMILIES.items():
            if _scanned(f):
                jcfg = jget_config(arch).reduced(scan_layers=True,
                                                 remat=True, **kw)
                cfg = get_config(arch).reduced(remat=True, **kw)
            else:
                jcfg, cfg = (jget_config(arch).reduced(**kw),
                             get_config(arch).reduced(**kw))
            jmodel = jbuild_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            params = params_from_flat(_flatten_with_paths(jparams),
                                      device="cpu")
            if cfg.enc_dec:
                src = mt.translation_batches()
            else:
                src = LMBatches(cfg.vocab, 8, 16)
            port[f] = (cfg, params, [src.next_batch() for _ in range(STEPS)])
            ref[f] = (jmodel, jparams)
        tmp = tempfile.mkdtemp(prefix="mesh_train_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        port["dirs"] = {k: os.path.join(tmp, k) for k in (
            "mesh", "to_1x2", "back", "async", "reference", "unsharded",
            "one_place", "plain_restore")}
        _CACHED["setup"] = (port, ref)
        _reference_checkpoint()
    return _CACHED["setup"]


def _reference_run(family, steps=STEPS):
    """The reference's jitted run of ``family`` over its batches: each
    step's metrics, flattened parameters and first moment (a stacked
    tree unstacked into the port's ``blocks.{i}`` keys)."""
    key = ("reference", family)
    if key not in _CACHED:
        port, ref = _setup()
        jmodel, jparams = ref[family]
        jopt = JAdamW(lr=jwarmup_cosine(2e-3, 2, 20))
        jstep = jax.jit(jmake_train_step(jmodel, jopt))
        p, s = jparams, jopt.init(jparams)
        out = {"metrics": [], "params": [], "m": []}
        for b in port[family][2][:steps]:
            (p, s), m = jstep(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["params"].append(_unstacked(p))
            out["m"].append(_unstacked(s.m))
        _CACHED[key] = out
    return _CACHED[key]


def _unstacked(tree) -> dict:
    """The reference tree's flattened leaves, a scan-stacked ``blocks``,
    ``enc_blocks`` or ``dec_blocks`` leaf cut into its layers."""
    out = {}
    for k, v in _flatten_with_paths(tree).items():
        root, _, rest = k.partition("/")
        if root.endswith("blocks") and "." not in root:
            for i in range(v.shape[0]):
                out[f"{root}.{i}/{rest}"] = np.asarray(v[i])
        else:
            out[k] = np.asarray(v)
    return out


def _reference_checkpoint():
    """The reference's ``Checkpointer`` writes its state after one step
    of the enc-dec family (``dirs["reference"]``)."""
    port, ref = _CACHED["setup"]
    jmodel, jparams = ref["encdec"]
    jopt = JAdamW(lr=jwarmup_cosine(2e-3, 2, 20))
    b = port["encdec"][2][0]
    state = jax.jit(jmake_train_step(jmodel, jopt))(
        jparams, jopt.init(jparams), {k: jnp.asarray(v)
                                      for k, v in b.items()})[0]
    JCheckpointer(port["dirs"]["reference"]).save(1, state)


def _ranks(world):
    key = ("ranks", world)
    if key not in _CACHED:
        got, codes = st.spawn(mt.mesh_main, world, _setup()[0],
                              RANK_TIMEOUT_S)
        for r, res in enumerate(got):
            if isinstance(res, str):
                pytest.fail(f"rank {r} of {world} failed:\n{res}")
        assert codes == [0] * world, codes
        _CACHED[key] = got
    return _CACHED[key]


def _unsharded(family, n=STEPS):
    """The port's unsharded plain run of ``family`` over its first ``n``
    batches (enc-dec: the loop's batches), with each step's MoE dropped
    fractions."""
    key = ("unsharded", family, n)
    if key not in _CACHED:
        cfg, params, batches = _setup()[0][family]
        if n > len(batches):
            src = mt.translation_batches()
            batches = [src.next_batch() for _ in range(n)]
        _CACHED[key] = mt.unsharded_steps(cfg, params, batches[:n])
    return _CACHED[key]


# ---------------------------------------------------------------------------
# the checkpoint of a mesh run
# ---------------------------------------------------------------------------

def _npz(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}",
                              "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


def _ckpt():
    return _ranks(2)[0]["ckpt"]


def test_mesh_checkpoint_holds_an_unsharded_runs_arrays():
    """The ``(2, 1)`` job's checkpoint after step 2 has the keys, shapes
    and dtypes of the unsharded ``train_loop``'s, one writer's whole
    arrays, and its parameters are within the tolerances of the unsharded
    run's."""
    _ckpt()
    dirs = _setup()[0]["dirs"]
    cfg, params, _ = _setup()[0]["encdec"]
    mt.unsharded_loop(cfg, params, mt.CKPT_STEPS,
                      Checkpointer(dirs["unsharded"]))
    got, want = (_npz(dirs["mesh"], mt.CKPT_STEPS),
                 _npz(dirs["unsharded"], mt.CKPT_STEPS))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
    assert not [n for n in os.listdir(dirs["mesh"]) if n.startswith("tmp")]
    _held_to_straight([], {k[2:]: v for k, v in got.items()
                           if k.startswith("0/")}, mt.CKPT_STEPS)


def test_reference_checkpointer_restores_the_mesh_checkpoint():
    """The reference's ``Checkpointer.restore`` reads the mesh job's
    checkpoint into the reference's ``(params, AdamWState)`` tree, every
    leaf the file's."""
    _ckpt()
    port, ref = _setup()
    jmodel, jparams = ref["encdec"]
    target = (jparams, JAdamW().init(jparams))
    got = JCheckpointer(port["dirs"]["mesh"]).restore(target)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(target)
    want = _npz(port["dirs"]["mesh"], mt.CKPT_STEPS)
    flat = _flatten_with_paths(got)
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    assert int(got[1].step) == mt.CKPT_STEPS


@pytest.mark.parametrize("shape", ["(2, 1)", "(1, 2)"])
def test_port_restores_the_references_checkpoint_onto_a_mesh(shape):
    """Each rank restores its shard of the reference's checkpoint
    (``restore(..., shardings=...)``); gathered, the parameters and first
    moment are the reference's bit for bit."""
    got = _ckpt()[f"reference {shape}"]
    want = _npz(_setup()[0]["dirs"]["reference"], 1)
    # got: (parameters, first moment) as "0/..." and "1/..."
    key = {k: k if k.startswith("0/") else "1/.m/" + k[2:] for k in got}
    assert sorted(key.values()) == sorted(
        k for k in want if k.startswith(("0/", "1/.m/")))
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[key[k]], err_msg=k)


def _held_to_straight(history, params, n: int):
    """A resumed run's metrics at its steps, and its parameters after step
    ``n``, against the unsharded run straight through (metrics within
    1e-5 relative; the parameters by ``_assert_params_close``'s rule over
    the learning rates summed so far, sure where the first moment has been
    far above its tolerance at every step so far)."""
    straight = _unsharded("encdec", n)
    metrics = straight["metrics"]
    for h in history:
        w = metrics[h["step"] - 1]
        for k in w:
            np.testing.assert_allclose(h[k], w[k], rtol=1e-5,
                                       err_msg=f"step {h['step']} {k}")
    lr, sure = 0.0, {}
    for j in range(n):
        lr += metrics[j]["lr"]
        _assert_params_close(params if j == n - 1 else straight["params"][j],
                             straight["params"][j], straight["m"][j], lr,
                             1e-4, sure)


@pytest.mark.parametrize("target", ["(1, 2)", "back to (2, 1)"])
def test_mesh_checkpoint_restores_onto_another_mesh(target):
    """Step 2's checkpoint restored onto ``(1, 2)`` takes step 3, and step
    3's restored back onto ``(2, 1)`` takes step 4, each within the
    tolerances of the unsharded run straight through."""
    res = _ckpt()["1x2" if target == "(1, 2)" else "back"]
    n = mt.CKPT_STEPS + (1 if target == "(1, 2)" else 2)
    assert res["step"] == n and [h["step"] for h in res["history"]] == [n]
    _held_to_straight(res["history"], res["params"], n)


@pytest.mark.parametrize("target", ["(1, 1)", "unsharded"])
def test_mesh_checkpoint_restores_onto_one_place(target):
    """Step 2's checkpoint restored onto a ``(1, 1)`` mesh (this process's
    world-size-1 group) and onto the unsharded step, each taking step 3
    within the tolerances of the unsharded run straight through."""
    _ckpt()
    dirs = _setup()[0]["dirs"]
    cfg, params, _ = _setup()[0]["encdec"]
    d = dirs["one_place" if target == "(1, 1)" else "plain_restore"]
    shutil.copytree(dirs["mesh"], d)
    run = mt.one_place_loop if target == "(1, 1)" else mt.unsharded_loop
    res = run(cfg, params, mt.CKPT_STEPS + 1, Checkpointer(d))
    assert [h["step"] for h in res["history"]] == [mt.CKPT_STEPS + 1]
    _held_to_straight(res["history"], res["params"], mt.CKPT_STEPS + 1)


def test_async_mesh_save_keeps_the_newest_whole():
    """``async_save`` and ``keep=2`` on the mesh: checkpoints 2 and 3 are
    left, and step 3's holds the job's final parameters and first moment
    exactly."""
    res = _ckpt()
    assert res["async_steps"] == [2, 3]
    got = _npz(_setup()[0]["dirs"]["async"], 3)
    for k, v in res["async"]["params"].items():
        np.testing.assert_array_equal(got[f"0/{k}"], v, err_msg=k)
    for k, v in res["async"]["m"].items():
        np.testing.assert_array_equal(got[f"1/.m/{k}"], v, err_msg=k)


def test_every_rank_reads_the_same_data():
    """Every rank's data iterator is in the same state after each job,
    the one its checkpoint records."""
    ranks = _ranks(2)
    for job in ("2x1", "1x2", "back", "async"):
        states = [r["ckpt"][job]["data"] for r in ranks]
        assert states[1:] == states[:1], job
    with open(os.path.join(_setup()[0]["dirs"]["mesh"],
                           f"step_{mt.CKPT_STEPS:08d}", "meta.json")) as f:
        assert json.load(f)["extra"]["data_state"] == \
            ranks[0]["ckpt"]["2x1"]["data"]


# ---------------------------------------------------------------------------
# remat, the sequence-split residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["encdec", "swiglu", "moe"])
def test_remat_gradients_are_the_same_bits(family, monkeypatch):
    """Unsharded: the loss and every gradient leaf with ``remat`` equal
    those without it, bit for bit (the same ops in the same order), and
    with it each block runs twice, its recomputation in the backward."""
    cfg, params, batches = _setup()[0][family]
    batch = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    runs, real = [], context._block

    def counted(*args):
        runs.append(1)
        return real(*args)

    monkeypatch.setattr(context, "_block", counted)
    got, blocks = [], []
    for remat in (False, True):
        runs.clear()
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device="cpu")
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = make_loss_fn(model)(
                tree_unflatten(params, leaves), batch)
            got.append([loss.detach()] + list(
                torch.autograd.grad(loss, leaves)))
        blocks.append(len(runs))
    assert all(torch.equal(a, b) for a, b in zip(*got))
    assert blocks == [cfg.n_layers + cfg.n_enc_layers,
                      2 * (cfg.n_layers + cfg.n_enc_layers)]


def test_a_remat_step_leaves_no_reference_cycles():
    """A ``remat`` step frees its trees as it goes, as a plain one does
    (``test_torch_sharded_train.py::test_a_step_leaves_no_reference_
    cycles``): no tensor is left in cyclic garbage, neither by the
    recomputation's closures nor by the import ``torch.utils.checkpoint``
    makes at its first call (done as the step is built)."""
    cfg, params, batches = _setup()[0]["swiglu"]
    opt = AdamW()
    step = make_train_step(build_model(dataclasses.replace(cfg, remat=True),
                                       device="cpu"), opt)
    state = opt.init(params)
    assert mt.cyclic_tensors(lambda: step(params, state, batches[0])) == 0


def test_remat_mesh_step_is_the_plain_mesh_step():
    """On ``(1, 2)`` (the sequence split, the gather a layer inside what
    remat recomputes): the metrics, gathered gradients and parameters with
    ``remat`` equal those without, bit for bit; on every rank a remat step
    leaves no tensor in cyclic garbage."""
    ranks = _ranks(2)
    got, want = ranks[0]["remat"]["remat"], ranks[0]["remat"]["plain"]
    assert got["metrics"] == want["metrics"]
    for part in ("params", "m"):
        for k, v in want[part][0].items():
            np.testing.assert_array_equal(got[part][0][k], v, err_msg=k)
    assert [r["remat"]["cyclic tensors"] for r in ranks] == [0, 0]


def test_split_residual_is_the_whole_stream_but_the_norms_sums():
    """On ``(1, 2)``: the sequence-split step against the same step with
    each rank's residual whole.  The loss and every gradient leaf but the
    norms' parameters are the same bits (gathers are exact, the
    projections see the same whole rows); a norm's parameter gradient sums
    its rows in two partial sums, one a rank, so it may move in the last
    bits, within the tolerances (here the gradient norm comes out the
    same, and so do the parameters after the step)."""
    res = _ranks(2)[0]["remat"]
    got, want = res["plain"], res["whole"]
    assert got["metrics"] == want["metrics"]
    # the blocks' norms (the final norm runs on the whole stream)
    norms = [k for k in want["m"][0] if k.startswith("blocks.")
             and k.split("/")[-2].endswith("norm")]
    assert len(norms) == 4
    for k, v in want["m"][0].items():
        if k not in norms:
            np.testing.assert_array_equal(got["m"][0][k], v, err_msg=k)
    _assert_grads_close(got["m"][0], want["m"][0], 1e-4)
    for k, v in want["params"][0].items():
        np.testing.assert_array_equal(got["params"][0][k], v, err_msg=k)


def test_stream_stays_whole_where_the_sequence_does_not_divide():
    """A sequence of 15 positions on ``(1, 2)``: each rank keeps the
    stream whole, and the step is within the tolerances of the unsharded
    one."""
    cfg, params, _ = _setup()[0]["swiglu"]
    batch = LMBatches(cfg.vocab, 8, mt.ODD_S).next_batch()
    want = st.run_unsharded(cfg, params, [batch], "plain")
    _assert_run_close(_ranks(2)[0]["remat"]["odd"], want, False)


# ---------------------------------------------------------------------------
# MoE on a training mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,world", [(c, w) for w in (2, 4)
                                        for c, _ in mt.MOE_CASES[w]])
def test_moe_mesh_step_matches_unsharded(case, world):
    """Three MoE steps (experts split whole over the tensor axis, the
    load-balance loss over the global batch): ``loss``, ``ce_loss``,
    ``load_balance_loss``, the gradients and parameters within the
    tolerances of the unsharded step, and every layer's dropped fraction
    equal to its."""
    got = _ranks(world)[0][case]
    want = _unsharded("moe")
    _assert_run_close(got, want, False)
    assert got["metrics"][0]["load_balance_loss"] > 0
    np.testing.assert_allclose(np.asarray(got["dropped"]),
                               np.asarray(want["dropped"]), rtol=0,
                               atol=1e-6)


def test_moe_rows_must_hold_whole_routing_groups():
    """4 rows × 12 positions a data rank are not whole groups of 32: the
    mesh step raises and names the condition."""
    msg = _ranks(2)[0]["groups"]
    assert "routing groups of 32" in msg and "48 tokens" in msg, msg


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_reports_the_same_metrics(world):
    ranks = _ranks(world)
    names = [c for c, _ in mt.MOE_CASES[world]] + (
        list(mt.SCAN_FAMILIES) if world == 4 else [])
    for name in names:
        for r in range(1, world):
            assert ranks[r][name]["metrics"] == ranks[0][name]["metrics"], \
                (name, r)
            assert ranks[r][name]["dropped"] == ranks[0][name]["dropped"]
    if world == 2:
        for job in ("2x1", "1x2", "back", "async"):
            assert ranks[1]["ckpt"][job]["history"] == \
                ranks[0]["ckpt"][job]["history"], job


@pytest.mark.parametrize("family", mt.SCAN_FAMILIES)
def test_reference_config_mesh_step_matches_reference(family):
    """Three layers at the reference's published execution settings
    (``remat=True``; the reference's ``scan_layers=True`` stacked tree
    carried across) on ``(2, 2)``: three steps against the reference's
    jitted step."""
    _assert_run_close(_ranks(4)[0][family], _reference_run(family), False)
