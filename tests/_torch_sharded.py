"""What ``test_torch_sharded_serve.py`` runs inside its gloo ranks: the
reference test's serve matrix (``tests/test_sharded_serve.py``) as a list
of cases, the function that serves every case on one engine setup, and the
rank entry point.  It imports torch and the port only, so a spawned rank
never loads JAX."""

import traceback

import torch

from repro_torch.data import pad_batch
from repro_torch.serving import ServingEngine, make_chaos

MAX_LEN = 32
PAGE_SIZE = 8
N_SLOTS = 8
BUDGETS = [3, 7, 24, 5, 16, 2, 4, 9]
MIXED_WIDTHS = [4, 2, 1, 3, 4, 2, 1, 4]

# (quant, fused admission, burst, speculative_k): the reference's
GREEDY_CASES = [
    ("fp", True, 8, 0),
    ("fp", False, "auto", 0),
    ("int8", True, "auto", 0),
    ("int8", False, 1, 0),
    ("fp", True, 4, 2),
    ("int8", True, 8, 2),
]
# (beam, quant, fused admission, tp): the reference's
BEAM_CASES = [
    (1, "fp", True, 2),
    (4, "fp", True, 2),
    (4, "int8", False, 2),
    ("mixed", "int8", True, 2),
    (4, "fp", True, 4),
    ("mixed", "fp", False, 4),
]


def cases(tp: int):
    """``[(name, model, quant, engine kwargs, serves)]`` run at ``tp``
    (``serves``: the serve calls' kwargs, run one after another on one
    engine).  ``tp=None``: every case, for the unsharded engine."""
    every = tp is None
    out = []
    for quant, fused, burst, spec in GREEDY_CASES:
        out.append((f"greedy-{quant}-{fused}-{burst}-{spec}", "main", quant,
                    {}, [dict(n_slots=N_SLOTS, max_new_tokens=BUDGETS,
                              fused_admission=fused, burst_len=burst,
                              speculative_k=spec)]))
    for beam, quant, fused, btp in BEAM_CASES:
        if every or btp == tp:
            out.append((f"beam-{beam}-{quant}-{fused}", "main", quant, {},
                        [dict(n_slots=N_SLOTS, max_new_tokens=BUDGETS,
                              fused_admission=fused, burst_len=4,
                              beam=MIXED_WIDTHS if beam == "mixed"
                              else beam)]))
    out.append(("unpaged", "main", "fp", dict(paged=False),
                [dict(n_slots=N_SLOTS, max_new_tokens=BUDGETS)]))
    if every or tp == 2:
        # INT4 out-projections replicate: their inputs are gathered first
        out.append(("greedy-int4", "main", "int4", {},
                    [dict(n_slots=N_SLOTS, max_new_tokens=BUDGETS)]))
        # the second serve must hit on every source in the sharded pool
        out.append(("prefix", "prefix", "fp", dict(prefix_cache=True),
                    [dict(n_slots=4, max_new_tokens=6)] * 2))
        out.append(("overload", "main", "int8", {},
                    [dict(n_slots=N_SLOTS, max_new_tokens=BUDGETS,
                          burst_len=4, overcommit=1.5,
                          chaos=make_chaos(2, n_rounds=64,
                                           preempt_every=2))]))
    if every or tp == 4:
        out.append(("gqa", "gqa", "fp", {},
                    [dict(n_slots=4, max_new_tokens=8)]))
    # generate and generate_beam on the contiguous cache
    out.append(("generate-int8", "main", "int8", {},
                [dict(call="generate", max_new_tokens=12)]))
    out.append(("generate_beam-fp", "main", "fp", {},
                [dict(call="generate_beam", beam=4, max_new_tokens=8)]))
    return out


def outcome(res) -> dict:
    """What the tests compare of a ``ServeResult`` or a
    ``GenerationResult``."""
    if not hasattr(res, "requests"):
        return {"tokens": [list(map(int, t)) for t in res.tokens],
                "host_syncs": res.host_syncs, "decode_steps": res.steps}
    return {"tokens": [list(map(int, r.tokens)) for r in res.requests],
            "host_syncs": res.host_syncs, "decode_steps": res.decode_steps,
            "prefix_hits": res.prefix_hits, "preemptions": res.preemptions,
            "pages_in_use": res.pages_in_use, "tp_degree": res.tp_degree,
            "mesh_shape": tuple(res.mesh_shape),
            "collective_bytes_per_step": res.collective_bytes_per_step}


def _call(eng, srcs, kw):
    kw = dict(kw)
    call = kw.pop("call", "serve")
    if call == "serve":
        return eng.serve(srcs, **kw)
    src, lens = pad_batch(srcs)
    return getattr(eng, call)({"src_tokens": src, "src_lengths": lens}, **kw)


def run_cases(setup: dict, tp, mesh=None) -> dict:
    """Serve every case of ``cases(tp)`` on engines over ``mesh``.

    ``setup``: ``{"models": {name: (model, srcs)}, "params": {(name,
    quant): (params, quant context or None)}}``."""
    out = {}
    for name, mname, quant, eng_kw, serves in cases(tp):
        model, srcs = setup["models"][mname]
        params, ctx = setup["params"][(mname, quant)]
        kw = dict(max_len=MAX_LEN, paged=True, page_size=PAGE_SIZE,
                  device="cpu", mesh=mesh)
        kw.update(eng_kw)
        if ctx is not None:
            kw["quant"] = ctx
        eng = ServingEngine(model, params, **kw)
        out[name] = [outcome(_call(eng, srcs, s)) for s in serves]
    return out


def rank_main(rank: int, world: int, rdzv: str, setup: dict, queue) -> None:
    """One gloo rank: join the group, build the ``(1, world)`` mesh, serve
    every case at ``world`` and put ``(rank, results or a traceback)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            res = run_cases(setup, world, make_host_mesh(1, world))
        finally:
            dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
