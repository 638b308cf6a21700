"""What ``test_torch_sharded_train.py`` and ``test_torch_compression.py``
run inside their gloo ranks: the training cases (each family, mesh and
variant of ``make_train_step(grad_shardings=...)``), the compression cases,
and the rank entry points.  It imports torch and the port only, so a
spawned rank never loads JAX."""

import traceback

import torch

from repro_torch.distributed.collectives import (
    TPGroup,
    data_sum,
    fsdp_gather,
    tp_enter,
    tp_gather,
    tp_row_sum,
    tp_split,
    vocab_gather,
)
from repro_torch.distributed.compression import (
    ef_compressed_mean,
    init_error_state,
    tree_ef_compressed_mean,
)
from repro_torch.distributed.sharding import (
    TreeSharding,
    gather_params,
    shard_opt_state,
    shard_params,
)
from repro_torch.launch.specs import train_arg_specs
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import make_train_step
from repro_torch.tree import leaves_with_paths

FAMILIES = ("encdec", "gelu", "swiglu")
# a run's options of make_train_step, AdamW's clip norm and its steps: the
# plain run 3 steps (clipping at 1.0, the reference's AdamW default), the
# others one; CLIP_NORM is under every family's gradient norm, so the
# clip scales the step's gradients
CLIP_NORM = 0.05
VARIANTS = {"plain": ({}, 1.0, 3), "accum2": (dict(accum_steps=2), 1.0, 1),
            "mixed": (dict(mixed_precision=True), 1.0, 1),
            "clip": ({}, CLIP_NORM, 1)}
STEPS = max(v[2] for v in VARIANTS.values())
# (data, model) meshes a spawn of 2 and of 4 ranks runs; the SwiGLU model
# (4 query heads over 2 kv heads) alone at (1, 4), the GQA fallback, and
# on a (pod, data, model) mesh of (1, 2, 2), whose batch axes are two
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4), (1, 2, 2))}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def optimizer(variant: str) -> AdamW:
    return AdamW(lr=warmup_cosine(2e-3, 2, 20),
                 clip_norm=VARIANTS[variant][1])


def cases(world: int):
    """``[(name, family, mesh shape, variant)]`` a spawn of ``world`` ranks
    runs."""
    return [(f"{f}-{'x'.join(map(str, shape))}-{v}", f, shape, v)
            for shape in MESHES[world]
            for f in (FAMILIES if shape == (2, 2) or len(shape) == 2
                      and world == 2 else ("swiglu",))
            for v in (VARIANTS if len(shape) == 2 else ("plain",))]


def flat(tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in leaves_with_paths(tree)}


def run_unsharded(cfg, params, batches, variant: str) -> dict:
    """The port's unsharded step over ``batches``: each step's metrics and
    parameters, and the first moment after the first step."""
    model = build_model(cfg, device="cpu")
    opt = optimizer(variant)
    step = make_train_step(model, opt, **VARIANTS[variant][0])
    p, s = params, opt.init(params)
    out = {"metrics": [], "params": [], "m": []}
    for b in batches[:VARIANTS[variant][2]]:
        (p, s), m = step(p, s, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(flat(p))
        out["m"].append(flat(s.m))
    return out


def run_case(setup: dict, family: str, variant: str, mesh,
             keep: bool) -> dict:
    """One case on this rank: the whole tree cut by ``train_arg_specs``,
    the variant's sharded steps, each step's metrics and (``keep``) the
    gathered parameters and first moment after each step; and whether
    ``gather_params`` gave back the whole tree from its cut exactly."""
    cfg, params, batches = setup[family]
    specs, _, _ = train_arg_specs(cfg, params, batches[0], mesh)
    opt = optimizer(variant)
    step = make_train_step(build_model(cfg, device="cpu"), opt,
                           grad_shardings=TreeSharding(mesh, specs),
                           **VARIANTS[variant][0])
    p = shard_params(params, specs, mesh, mesh.coords)
    s = shard_opt_state(opt.init(params), specs, mesh, mesh.coords)
    out = {"metrics": [], "params": [], "m": []}
    for b in batches[:VARIANTS[variant][2]]:
        (p, s), m = step(p, s, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        whole = gather_params(p, specs, mesh)
        moment = gather_params(s.m, specs, mesh)
        if keep:
            out["params"].append(flat(whole))
            out["m"].append(flat(moment))
    out["roundtrip"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_paths(gather_params(
                shard_params(params, specs, mesh, mesh.coords), specs,
                mesh)), leaves_with_paths(params)))
    return out


COLLECTIVES = {"fsdp_gather": lambda x, g: fsdp_gather(x, 0, g),
               "tp_enter": tp_enter, "tp_row_sum": tp_row_sum,
               "vocab_gather": vocab_gather,
               "tp_gather": lambda x, g: tp_gather(x, 0, g),
               "tp_split": lambda x, g: tp_split(x, 1, g),
               "data_sum": data_sum}


def probe_input(rank: int) -> torch.Tensor:
    """Rank ``rank``'s (3, 4) input of the collectives probe, from a
    seed."""
    return torch.randn((3, 4), generator=torch.Generator().manual_seed(
        1000 + rank))


def probe_upstream(rank: int, shape) -> torch.Tensor:
    """The gradient a collective's output gets on rank ``rank``."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        2000 + rank))


def collectives_probe(group: TPGroup) -> dict:
    """Each autograd-visible collective on this rank's probe input: its
    output and the gradient of ``sum(output · upstream)`` at the input."""
    out = {}
    for name, fn in COLLECTIVES.items():
        xi = probe_input(group.rank).requires_grad_(True)
        y = fn(xi, group)
        up = probe_upstream(group.rank, y.shape)
        (g,) = torch.autograd.grad((y * up).sum(), xi)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def train_main(rank: int, world: int, rdzv: str, setup: dict, queue) -> None:
    """One gloo rank of a training spawn: every case of ``cases(world)``;
    rank 0 keeps the gathered trees, the others their metrics.  Puts
    ``(rank, results or a traceback)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _make_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            meshes = {shape: _make_mesh(shape, AXES[len(shape)])
                      for shape in MESHES[world]}
            res = {name: run_case(setup, f, v, meshes[shape], rank == 0)
                   for name, f, shape, v in cases(world)}
            res["collectives"] = collectives_probe(TPGroup(rank, world))
        finally:
            dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

EF_STEPS = 8


def compression_case(group: TPGroup, n: int, grads, errs) -> dict:
    """This rank's ``ef_compressed_mean`` of one leaf and
    ``tree_ef_compressed_mean`` of a tree: ``grads[r]``/``errs[r]`` is
    rank ``r``'s leaf and tree (numpy); then ``EF_STEPS`` steps of error
    feedback on one fixed leaf: the applied mean and the residual after
    each."""
    r = group.rank
    leaf, tree = grads[r]
    eleaf, etree = errs[r]
    mean, err = ef_compressed_mean(torch.as_tensor(leaf),
                                   torch.as_tensor(eleaf), group, n)
    tmean, terr = tree_ef_compressed_mean(
        {k: torch.as_tensor(v) for k, v in tree.items()},
        {k: torch.as_tensor(v) for k, v in etree.items()}, group, n)
    g = torch.as_tensor(grads[r][0])
    e = init_error_state(g)
    applied, feedback = torch.zeros_like(g), []
    for _ in range(EF_STEPS):
        out, e = ef_compressed_mean(g, e, group, n)
        applied = applied + out
        feedback.append((applied.numpy().copy(), e.numpy().copy()))
    return {"leaf": (mean.numpy(), err.numpy()),
            "tree": ({k: v.numpy() for k, v in tmean.items()},
                     {k: v.numpy() for k, v in terr.items()}),
            "feedback": feedback}


def compression_main(rank: int, world: int, rdzv: str, setup: dict,
                     queue) -> None:
    """One gloo rank of the compression spawn: ``setup[n]`` over all
    ``world`` ranks and over the first two (a second group of the same
    ranks); puts ``(rank, {n: results})``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            pair = dist.new_group([0, 1])
            res = {world: compression_case(TPGroup(rank, world), world,
                                           *setup[world])}
            if rank < 2:
                res[2] = compression_case(TPGroup(rank, 2, pair), 2,
                                          *setup[2])
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def spawn(target, world: int, setup, timeout_s: float) -> list:
    """Every rank's results of ``target`` on ``world`` gloo ranks (a
    ``file://`` rendezvous in a fresh directory); a rank's traceback is
    returned as a string in its place."""
    import tempfile
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, args=(r, world,
                                                  f"file://{tmp}/rdzv",
                                                  setup, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            got = dict(queue.get(timeout=timeout_s) for _ in range(world))
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    return [got[r] for r in range(world)], [p.exitcode for p in procs]

