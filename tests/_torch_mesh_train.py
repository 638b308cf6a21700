"""What ``test_torch_mesh_train.py`` runs inside its gloo ranks: a sharded
training job as the reference runs its published configs (whole-array
checkpoints of a mesh run and their elastic restore, ``remat``, a gather a
layer, the sequence-split residual) and MoE on a training mesh.  It
imports torch and the port only, so a spawned rank never loads JAX."""

import contextlib
import dataclasses
import gc
import shutil
import traceback

import torch

import _torch_sharded_train as st
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data import LMBatches, TranslationBatches, make_corpus
from repro_torch.distributed import context
from repro_torch.distributed.sharding import (
    TreeSharding,
    gather_params,
    shard_opt_state,
    shard_params,
)
from repro_torch.launch.specs import train_arg_specs
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.train import make_train_step, train_loop

CKPT_STEPS = 2          # the (2, 1) job's steps before its checkpoint
# (name, family, mesh shape) of the MoE cases, three plain steps each
MOE_CASES = {2: (("moe-2x1", (2, 1)), ("moe-1x2", (1, 2))),
             4: (("moe-2x2", (2, 2)),)}
# the families held to the reference's scan_layers=True, remat=True step
SCAN_FAMILIES = ("encdec3", "gelu3", "swiglu3", "moe3")
# a sequence length the tensor axis of 2 does not divide: the stream whole
ODD_S = 15


def translation_batches() -> TranslationBatches:
    """The enc-dec family's batches, as ``test_torch_sharded_train.py``
    draws them (every rank reads the same global batches)."""
    return TranslationBatches(make_corpus(400, 64, max_words=5, seed=0), 32,
                              seed=0)


@contextlib.contextmanager
def recording_moe(out: list):
    """Each MoE layer's ``dropped_fraction`` appended to ``out`` as the
    decoder-only forward computes it."""
    real = transformer.moe_ffn

    def record(*args, **kw):
        y, aux = real(*args, **kw)
        out.append(float(aux["dropped_fraction"]))
        return y, aux

    transformer.moe_ffn = record
    try:
        yield
    finally:
        transformer.moe_ffn = real


def sharded(cfg, params, batch, mesh, variant="plain", **kw):
    """``(step, specs, shard, state)``: the mesh step of ``cfg`` and this
    rank's cut of ``params`` and of a fresh optimizer state."""
    specs = train_arg_specs(cfg, params, batch, mesh)[0]
    opt = st.optimizer(variant)
    step = make_train_step(build_model(cfg, device="cpu"), opt,
                           grad_shardings=TreeSharding(mesh, specs), **kw)
    return (step, specs, shard_params(params, specs, mesh, mesh.coords),
            shard_opt_state(opt.init(params), specs, mesh, mesh.coords))


def run_steps(cfg, params, batches, mesh, keep: bool, **kw) -> dict:
    """The mesh step over ``batches``: each step's metrics and (``keep``)
    the gathered parameters and first moment; each step's MoE dropped
    fractions."""
    step, specs, p, s = sharded(cfg, params, batches[0], mesh, **kw)
    out = {"metrics": [], "params": [], "m": [], "dropped": []}
    for b in batches:
        dropped = []
        with recording_moe(dropped):
            (p, s), m = step(p, s, b)
        out["dropped"].append(dropped)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        whole, moment = (gather_params(p, specs, mesh),
                         gather_params(s.m, specs, mesh))
        if keep:
            out["params"].append(st.flat(whole))
            out["m"].append(st.flat(moment))
    return out


def copy_dir(src: str, dst: str, rank: int) -> None:
    """Rank 0 copies a checkpoint directory; every rank waits for it."""
    import torch.distributed as dist
    if rank == 0:
        shutil.copytree(src, dst)
    dist.barrier()


def loop(cfg, params, mesh, steps: int, ckpt: Checkpointer, rank: int,
         save_every: int = 100) -> dict:
    """``train_loop`` of the mesh step from ``params`` (whole; this rank's
    cut is taken) over the enc-dec batches: the history, the data state,
    and the gathered parameters and first moment it ended with."""
    batches = translation_batches()
    step, specs, p, s = sharded(cfg, params, batches.next_batch(), mesh)
    batches.load_state_dict(translation_batches().state_dict())
    out = train_loop(train_step=step, params=p, opt_state=s,
                     batches=batches, steps=steps, checkpointer=ckpt,
                     save_every=save_every, log_every=1)
    params_whole = gather_params(out["params"], specs, mesh)
    m_whole = gather_params(out["opt_state"].m, specs, mesh)
    return {"history": out["history"], "data": batches.state_dict(),
            "params": st.flat(params_whole) if rank == 0 else None,
            "m": st.flat(m_whole) if rank == 0 else None,
            "step": int(out["opt_state"].step)}


def checkpoint_cases(setup: dict, meshes: dict, rank: int) -> dict:
    """The checkpoint job: ``CKPT_STEPS`` steps on (2, 1) and a save; that
    checkpoint restored onto (1, 2) for a third step, and the third's
    restored onto (2, 1) for a fourth ("and back"); an async run that
    keeps 2 of 3 checkpoints; the reference's checkpoint restored onto
    (2, 1) and (1, 2)."""
    cfg, params, _ = setup["encdec"]
    dirs = setup["dirs"]
    out = {"2x1": loop(cfg, params, meshes[(2, 1)], CKPT_STEPS,
                       Checkpointer(dirs["mesh"]), rank)}
    copy_dir(dirs["mesh"], dirs["to_1x2"], rank)
    out["1x2"] = loop(cfg, params, meshes[(1, 2)], CKPT_STEPS + 1,
                      Checkpointer(dirs["to_1x2"]), rank)
    copy_dir(dirs["to_1x2"], dirs["back"], rank)
    out["back"] = loop(cfg, params, meshes[(2, 1)], CKPT_STEPS + 2,
                       Checkpointer(dirs["back"]), rank)
    out["async"] = loop(cfg, params, meshes[(2, 1)], 3,
                        Checkpointer(dirs["async"], keep=2,
                                     async_save=True), rank, save_every=1)
    out["async_steps"] = Checkpointer(dirs["async"]).all_steps()
    ref_dir = Checkpointer(dirs["reference"])
    for shape in ((2, 1), (1, 2)):
        mesh = meshes[shape]
        _, specs, p, s = sharded(cfg, params, setup["encdec"][2][0], mesh)
        layout = (specs, s._replace(step=(), m=specs, v=specs))
        got = ref_dir.restore((p, s), shardings=TreeSharding(mesh, layout))
        whole = gather_params(got[0], specs, mesh), \
            gather_params(got[1].m, specs, mesh)
        out[f"reference {shape}"] = st.flat(whole) if rank == 0 else None
    return out


def cyclic_tensors(fn) -> int:
    """The tensors that ``fn()`` leaves in cyclic garbage (a whole tree
    of them, in a cycle, lives until the collector runs).  torch's own
    ``tree_flatten``, which ``torch.utils.checkpoint`` calls, leaves a
    small cycle of its nested helper a call: no tensor."""
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        fn()
        gc.collect()
        return sum(isinstance(o, torch.Tensor) for o in gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def remat_and_split_cases(setup: dict, meshes: dict, rank: int) -> dict:
    """On (1, 2), SwiGLU: one step with ``remat`` against one without, and
    one with the residual whole (``context._splits_rows`` forced off)
    against the sequence-split one; the tensors a remat step left in
    cyclic garbage; and one step at a sequence length 2 does not
    divide."""
    cfg, params, batches = setup["swiglu"]
    mesh = meshes[(1, 2)]
    out = {}
    for name, c in (("plain", cfg),
                    ("remat", dataclasses.replace(cfg, remat=True))):
        out[name] = run_steps(c, params, batches[:1], mesh, rank == 0)
    step, _, p, s = sharded(dataclasses.replace(cfg, remat=True), params,
                            batches[0], mesh)
    out["cyclic tensors"] = cyclic_tensors(lambda: step(p, s, batches[0]))
    real = context._splits_rows
    context._splits_rows = lambda layout, x: False
    try:
        out["whole"] = run_steps(cfg, params, batches[:1], mesh, rank == 0)
    finally:
        context._splits_rows = real
    odd = [LMBatches(cfg.vocab, 8, ODD_S).next_batch()]
    out["odd"] = run_steps(cfg, params, odd, mesh, rank == 0)
    return out


def moe_group_error(setup: dict, mesh) -> str:
    """The message of the mesh MoE step on rows that are not whole
    routing groups (4 rows × 12 positions a rank, groups of 32)."""
    cfg, params, _ = setup["moe"]
    batch = LMBatches(cfg.vocab, 8, 12).next_batch()
    step, _, p, s = sharded(cfg, params, batch, mesh)
    try:
        step(p, s, batch)
    except ValueError as e:
        return str(e)
    return "no error"


def mesh_main(rank: int, world: int, rdzv: str, setup: dict, queue) -> None:
    """One gloo rank of a spawn of ``world``: with 2, the checkpoint job,
    the remat and split cases, the MoE cases and the routing-group error;
    with 4, the MoE case and the reference-config families on (2, 2).
    Rank 0 keeps the gathered trees.  Puts ``(rank, results or a
    traceback)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _make_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            shapes = ((2, 1), (1, 2)) if world == 2 else ((2, 2),)
            meshes = {s: _make_mesh(s, ("data", "model")) for s in shapes}
            res = {}
            if world == 2:
                res["ckpt"] = checkpoint_cases(setup, meshes, rank)
                res["remat"] = remat_and_split_cases(setup, meshes, rank)
                res["groups"] = moe_group_error(setup, meshes[(2, 1)])
            for name, shape in MOE_CASES[world]:
                cfg, params, batches = setup["moe"]
                res[name] = run_steps(cfg, params, batches, meshes[shape],
                                      rank == 0)
            if world == 4:
                for f in SCAN_FAMILIES:
                    cfg, params, batches = setup[f]
                    res[f] = run_steps(cfg, params, batches, meshes[(2, 2)],
                                       rank == 0)
        finally:
            dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def unsharded_steps(cfg, params, batches) -> dict:
    """The port's unsharded plain step over ``batches``: each step's
    metrics, parameters and first moment, and its MoE dropped
    fractions."""
    opt = st.optimizer("plain")
    step = make_train_step(build_model(cfg, device="cpu"), opt)
    p, s = params, opt.init(params)
    out = {"metrics": [], "params": [], "m": [], "dropped": []}
    for b in batches:
        dropped = []
        with recording_moe(dropped):
            (p, s), m = step(p, s, b)
        out["dropped"].append(dropped)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(st.flat(p))
        out["m"].append(st.flat(s.m))
    return out


def unsharded_loop(cfg, params, steps: int, ckpt: Checkpointer) -> dict:
    """``train_loop`` of the unsharded step from ``params`` over the
    enc-dec batches (restoring from ``ckpt`` where it holds a step)."""
    batches = translation_batches()
    opt = st.optimizer("plain")
    step = make_train_step(build_model(cfg, device="cpu"), opt)
    out = train_loop(train_step=step, params=params,
                     opt_state=opt.init(params), batches=batches,
                     steps=steps, checkpointer=ckpt, log_every=1)
    return {"history": out["history"], "params": st.flat(out["params"]),
            "m": st.flat(out["opt_state"].m)}


def one_place_loop(cfg, params, steps: int, ckpt: Checkpointer) -> dict:
    """As :func:`unsharded_loop` through the mesh step on a ``(1, 1)``
    mesh of this process (a world-size-1 gloo group)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1)
    out = loop(cfg, params, mesh, steps, ckpt, 0)
    return {"history": out["history"], "params": out["params"],
            "m": out["m"]}
