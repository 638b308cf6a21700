"""What ``test_torch_sharded_decoder.py`` runs inside its gloo ranks: the
decoder-only cases (the zoo's reduced dense and MoE models through
``generate`` and ``generate_beam``), the function that runs every case on
one mesh, the expert-parallel probe of ``moe_ffn`` and the rank entry
point.  It imports torch and the port only, so a spawned rank never loads
JAX."""

import traceback

import torch

from repro_torch.models import moe as moe_mod
from repro_torch.serving import ServingEngine
from repro_torch.serving.sharding import shard_for_serving

MAX_LEN = 48
MAX_NEW = 10
BEAM = 2
LOGIT_STEPS = 3                # decode steps whose logits are compared
MODELS = ("dense", "moe")
KINDS = ("fp", "int8_dynamic", "int8_static")


def cases(tp):
    """``[(name, model, kind, call, batch)]`` run at ``tp`` (``None``:
    every case, for the unsharded engine): each model and kind greedy and
    at beam 2, greedy from ``embeds``, and INT4 weights at tp 2."""
    out = [(f"{m}-{kind}-{call}", m, kind, call, "tokens")
           for m in MODELS for kind in KINDS
           for call in ("generate", "generate_beam")]
    out.append(("dense-int8_static-embeds", "dense", "int8_static",
                "generate", "embeds"))
    if tp in (None, 2):
        out.append(("dense-int4-generate", "dense", "int4", "generate",
                    "tokens"))
    return out


def first_logits(engine, batch, steps: int = LOGIT_STEPS):
    """The prefill's and ``steps`` greedy decode steps' logits through
    ``engine``'s model, weights and decode state (a rank's on a mesh), as
    numpy arrays (a torch tensor put on a queue would be shared with a
    rank that exits)."""
    b = engine._device_batch(batch)
    rows = next(iter(b.values())).shape[0]
    state = engine._new_state(rows)
    logits, state = engine.model.prefill(engine.params, b, state,
                                         quant=engine.quant)
    out = [logits.numpy().copy()]
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, state = engine.model.decode_step(engine.params, tok, state,
                                                 quant=engine.quant)
        out.append(logits.numpy().copy())
    return out


def run_cases(setup: dict, tp, mesh=None) -> dict:
    """Every case of ``cases(tp)`` on engines over ``mesh``: tokens, steps
    and host syncs; and each model and kind's first logits.

    ``setup``: ``{"models": {name: model}, "params": {(name, kind):
    (params, quant context)}, "batches": {"tokens" | "embeds": batch}}``."""
    out, engines = {}, {}
    for name, mname, kind, call, inp in cases(tp):
        key = (mname, kind)
        if key not in engines:
            params, ctx = setup["params"][key]
            engines[key] = ServingEngine(setup["models"][mname], params,
                                         quant=ctx, max_len=MAX_LEN,
                                         device="cpu", mesh=mesh)
            out[f"{mname}-{kind}-logits"] = first_logits(
                engines[key], setup["batches"]["tokens"])
        eng, batch = engines[key], setup["batches"][inp]
        res = (eng.generate(batch, max_new_tokens=MAX_NEW)
               if call == "generate" else
               eng.generate_beam(batch, beam=BEAM, max_new_tokens=MAX_NEW))
        out[name] = {"tokens": [list(map(int, t)) for t in res.tokens],
                     "steps": res.steps, "host_syncs": res.host_syncs}
    return out


def expert_probe(model, params, x, mesh=None):
    """``moe_ffn`` of the first MoE layer on ``x`` (this rank's shard of
    ``params`` on ``mesh``): ``(output, {site: the rows each expert linear
    got})``, the linears' inputs recorded at ``_expert_dense``, as numpy
    arrays."""
    cfg = model.cfg
    if mesh is not None:
        params, cfg = shard_for_serving(params, mesh, cfg)
    got = {}
    real = moe_mod._expert_dense

    def recording(node, xe, *, site, **kw):
        got[site.rsplit("/", 1)[-1]] = xe.numpy().copy()
        return real(node, xe, site=site, **kw)

    moe_mod._expert_dense = recording
    try:
        y, _ = moe_mod.moe_ffn(params["blocks.0"]["moe"], x, cfg=cfg,
                               site="blocks.0/moe")
    finally:
        moe_mod._expert_dense = real
    return y.numpy(), got


def rank_main(rank: int, world: int, rdzv: str, setup: dict, queue) -> None:
    """One gloo rank: join the group, build the ``(1, world)`` mesh, run
    every case at ``world`` and the expert probe, and put ``(rank,
    results or a traceback)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            mesh = make_host_mesh(1, world)
            res = run_cases(setup, world, mesh)
            params, _ = setup["params"][("moe", "int8_dynamic")]
            res["probe"] = expert_probe(setup["models"]["moe"], params,
                                        setup["probe_x"], mesh)
        finally:
            dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
