"""The recurrent families' blocks on the CPU against the JAX package: the
Mamba2 SSD block, the mLSTM and sLSTM blocks and their decode steps against
``jax.jit`` of the reference's functions, and the chunked forms against the
port's own sequential ones; the registry, and the bridge over the
reference's scan-stacked trees (the models:
``test_torch_recurrent_model.py``).

The blocks take the reduced models' own weights (``mamba.0``; ``blocks.0``
an mLSTM layer, ``blocks.1`` an sLSTM one), 3 rows of random inputs of
``S`` = 40 and 50 positions (not multiples of the chunk, 16), and either
an empty state or one the reference carried out of a 7-position prefix.
Every comparison is float32 within ``tests/_torch_zoo.py``'s FP ``ATOL``
(2e-5; a state field within 2e-5 of its largest magnitude where that
exceeds 1): the same math summed in another order (the SSD's
three-operand ``einsum``, the matmul blocking, a chunk's decays in closed
form against the steps' products).  The reference's own test holds its
chunked forms to its sequential ones within 2e-3
(``tests/test_models.py:53-79``); the port's are within 1e-6.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.models import XLSTMLM, HybridLM, build_model, ssm, xlstm

from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    ATOL,
    RECURRENT,
    assert_logits_close,
    flat_leaves,
    one_torch_thread,
    prompts,
)

FP_ATOL = ATOL["fp"]
LENGTHS = (40, 50)
ROWS = 3


def _np(a):
    return np.asarray(a, np.float32)


def _t(tree):
    """A reference state (a NamedTuple of arrays) as the port's tensors."""
    return type(tree)(*(torch.as_tensor(np.array(a)) for a in tree))


def _x(seed, S, d):
    return (np.random.default_rng(seed).standard_normal((ROWS, S, d))
            * 0.5).astype(np.float32)


def _close(got, want, atol, msg=""):
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= atol, (msg, float(d.max()))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reduced model's reference weights (``init(PRNGKey(0))``) and the
    port's copy."""
    jparams = jbuild_model(jget_config(arch).reduced()).init(
        jax.random.PRNGKey(0))
    return jparams, params_from_flat(_flatten_with_paths(jparams),
                                     device="cpu")


def _block_case(arch, layer):
    """(ref cfg, port cfg, ref block params, port block params)."""
    jparams, fp = _weights(arch)
    return (jget_config(arch).reduced(), get_config(arch).reduced(),
            jparams[layer], fp[layer])


# (ref fn, port fn, arch, layer) of each full-sequence block
BLOCKS = {
    "ssm": (jssm.ssm_block, ssm.ssm_block, "zamba2-2.7b", "mamba.0"),
    "mlstm": (jxlstm.mlstm_block, xlstm.mlstm_block, "xlstm-1.3b",
              "blocks.0"),
    "mlstm_sequential": (jxlstm.mlstm_block_sequential,
                         xlstm.mlstm_block_sequential, "xlstm-1.3b",
                         "blocks.0"),
    "slstm": (jxlstm.slstm_block, xlstm.slstm_block, "xlstm-1.3b",
              "blocks.1"),
}
# the block whose decode step each decode test runs
DECODES = {
    "ssm": (jssm.ssm_decode_step, ssm.ssm_decode_step, "ssm"),
    "mlstm": (jxlstm.mlstm_decode_step, xlstm.mlstm_decode_step, "mlstm"),
    "slstm": (jxlstm.slstm_decode_step, xlstm.slstm_decode_step, "slstm"),
}


@functools.lru_cache(maxsize=None)
def _carried(name):
    """The state the reference's block carries out of a 7-position
    prefix (seed 70)."""
    jfn, _, arch, layer = BLOCKS[name]
    jcfg, _, jp, _ = _block_case(arch, layer)
    x0 = jnp.asarray(_x(70, 7, jcfg.d_model))
    _, st = jax.jit(lambda p, x: jfn(p, x, cfg=jcfg, site="t",
                                     return_state=True))(jp, x0)
    return st


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carried"])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_reference(name, S, carry):
    """Output and final state of the port's block against ``jax.jit`` of
    the reference's, from an empty or a carried-in state."""
    jfn, fn, arch, layer = BLOCKS[name]
    jcfg, cfg, jp, p = _block_case(arch, layer)
    jst = _carried(name) if carry else None
    x = _x(S, S, cfg.d_model)
    want, wst = jax.jit(lambda p, x, st: jfn(
        p, x, cfg=jcfg, site="t", state=st, return_state=True))(
            jp, jnp.asarray(x), jst)
    got, st = fn(p, torch.as_tensor(x), cfg=cfg, site="t",
                 state=None if jst is None else _t(jst), return_state=True)
    _close(got, want, FP_ATOL, "output")
    if carry:   # the carried-in state changes the output
        empty, _ = fn(p, torch.as_tensor(x), cfg=cfg, site="t")
        assert not torch.allclose(got, empty, atol=1e-3)
    for field, a, b in zip(wst._fields, st, wst):
        scale = max(1.0, float(np.abs(_np(b)).max()))
        _close(a, b, FP_ATOL * scale, field)


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carried"])
@pytest.mark.parametrize("name", sorted(DECODES))
def test_decode_step_matches_reference(name, carry):
    """Three decode steps of the port against ``jax.jit`` of the
    reference's, from an empty or a carried-in state."""
    jstep, step, block = DECODES[name]
    jfn, fn, arch, layer = BLOCKS[block]
    jcfg, cfg, jp, p = _block_case(arch, layer)
    jst = _carried(block)
    if not carry:   # an empty state, as init_decode_state makes it
        jst = type(jst)(*(jnp.full_like(a, -1e30 if f == "m" else 0.0)
                          for f, a in zip(jst._fields, jst)))
    st = _t(jst)
    jfn_step = jax.jit(lambda p, x, s: jstep(p, x, s, cfg=jcfg, site="t"))
    xs = _x(80, 3, cfg.d_model)
    for i in range(3):
        want, jst = jfn_step(jp, jnp.asarray(xs[:, i:i + 1]), jst)
        got, st = step(p, torch.as_tensor(xs[:, i:i + 1]), st, cfg=cfg,
                       site="t")
        _close(got, want, FP_ATOL, f"step {i}")
        for field, a, b in zip(jst._fields, st, jst):
            scale = max(1.0, float(np.abs(_np(b)).max()))
            _close(a, b, FP_ATOL * scale, f"step {i} {field}")


def _ssm_by_steps(p, cfg, x, st):
    outs = []
    for t in range(x.shape[1]):
        y, st = ssm.ssm_decode_step(p, x[:, t:t + 1], st, cfg=cfg, site="t")
        outs.append(y)
    return torch.cat(outs, dim=1), st


def _empty_ssm_state(cfg):
    s, d_inner, H = ssm._dims(cfg)
    return ssm.SSMState(h=torch.zeros((ROWS, H, s.state, s.head_dim)),
                        conv=torch.zeros((ROWS, s.conv_width - 1, d_inner)))


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carried"])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("name", ["ssm", "mlstm"])
def test_chunked_matches_own_sequential(name, S, carry):
    """The port's chunked SSD and mLSTM against its own sequential forms
    (the SSD's decode step a position at a time; the mLSTM's
    ``mlstm_block_sequential``): outputs and final states."""
    jfn, fn, arch, layer = BLOCKS[name]
    jcfg, cfg, jp, p = _block_case(arch, layer)
    st0 = _t(_carried(name)) if carry else None
    x = torch.as_tensor(_x(S + 1, S, cfg.d_model))
    y, st = fn(p, x, cfg=cfg, site="t", state=st0, return_state=True)
    if name == "ssm":
        y_s, st_s = _ssm_by_steps(p, cfg, x, st0 or _empty_ssm_state(cfg))
    else:
        y_s, st_s = xlstm.mlstm_block_sequential(
            p, x, cfg=cfg, site="t", state=st0, return_state=True)
    _close(y, y_s, FP_ATOL, "output")
    for field, a, b in zip(st._fields, st, st_s):
        _close(a, b, FP_ATOL * max(1.0, float(b.abs().max())), field)


# ---------------------------------------------------------------------------
# the registry and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cls", [("zamba2-2.7b", HybridLM),
                                      ("xlstm-1.3b", XLSTMLM)])
def test_registry_builds_the_family(arch, cls):
    """``build_model`` gives the family's class on the asked device, and
    its ``init`` the reference's unstacked leaves, shape for shape."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    assert type(model) is cls and model.device == torch.device("cpu")
    got = flat_leaves(model.init(torch.Generator().manual_seed(0)))
    want = _flatten_with_paths(_weights(arch)[0])
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(np.shape(v)) for k, v in want.items()}


@pytest.mark.parametrize("arch", RECURRENT)
def test_bridge_unstacks_scan_layers_trees(arch):
    """A reference tree stored with ``scan_layers=True`` (``mamba`` of
    (L, ...); ``mlstm`` of (G, M, ...) and ``slstm`` of (G, ...)) bridges
    into the port's per-layer nodes: the port's forward on it equals
    ``jax.jit`` of the reference's scan forward."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), scan_layers=True)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    flat = _flatten_with_paths(jp)
    assert any(k.split("/")[0] in ("mamba", "mlstm", "slstm") for k in flat)
    p = params_from_flat(flat, device="cpu")
    assert set(flat_leaves(p)) == set(flat_leaves(_weights(arch)[1]))
    toks, lens = prompts(seed=9, n=4)
    want, _ = jax.jit(lambda p, b: jm.forward(p, b))(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    got, _ = build_model(get_config(arch).reduced(), device="cpu").forward(
        p, {"tokens": torch.as_tensor(toks), "lengths": torch.as_tensor(lens)})
    assert_logits_close(got, want, "fp")
