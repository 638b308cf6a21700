"""The port's INT8 error-feedback gradient compression
(``repro_torch.distributed.compression``) against the reference's
``repro.distributed.compression`` run under ``jax.vmap(...,
axis_name="data")``, which binds the axis for ``pmax`` and ``all_gather``
on one CPU device, for 1, 2 and 4 shards.

The port runs over gloo ranks: one spawn of 4, whose first two ranks also
form a group of 2 (``tests/_torch_sharded_train.py``, which imports no
JAX); one shard runs in this process.  The codes come from K1's plain
version on the CPU (``kernels/ref.py``), which multiplies by the float32
reciprocal of the scale where the reference divides by it; at these seeds
and sizes no code differs (the counts are asserted zero), so the means and
the new error states are the reference's bit for bit.  The error-feedback
identity of ``tests/test_substrate.py:210-237`` holds over 8 steps, and
the wire formulas give the reference's numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.distributed import compression as jcomp

from repro_torch.distributed import compression
from repro_torch.distributed.collectives import TPGroup

import _torch_sharded_train as st

SHARDS = (1, 2, 4)
LEAF = (33, 17)
TREE = {"a": (40,), "b": (8, 16), "c": (3, 5, 7)}
RANK_TIMEOUT_S = 120
_CACHED = {}


def _data(n: int):
    """``(grads, errs)``: per shard ``(leaf, tree)`` gradients and error
    states (numpy float32) from a seed; the shards' magnitudes differ, so
    the shared threshold comes from one of them."""
    rng = np.random.default_rng(100 + n)

    def one(scale):
        return ((rng.standard_normal(LEAF) * scale).astype(np.float32),
                {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in TREE.items()})

    grads = [one(1.0 + r) for r in range(n)]
    errs = [one(0.01) for _ in range(n)]
    return grads, errs


def _stack(parts):
    return jnp.asarray(np.stack(parts))


def _reference(n: int) -> dict:
    """The reference's leaf and tree means, and 8 steps of error feedback
    on each shard's leaf, under ``jax.vmap`` over the shards."""
    grads, errs = _data(n)
    leaf = jax.vmap(lambda g, e: jcomp.ef_compressed_mean(g, e, "data", n),
                    axis_name="data")
    tree = jax.vmap(
        lambda g, e: jcomp.tree_ef_compressed_mean(g, e, "data", n),
        axis_name="data")
    mean, err = leaf(_stack([g[0] for g in grads]),
                     _stack([e[0] for e in errs]))
    tg = {k: _stack([g[1][k] for g in grads]) for k in TREE}
    te = {k: _stack([e[1][k] for e in errs]) for k in TREE}
    tmean, terr = tree(tg, te)
    g = _stack([x[0] for x in grads])
    e = jnp.zeros_like(g)
    applied, feedback = jnp.zeros_like(g), []
    for _ in range(st.EF_STEPS):
        out, e = leaf(g, e)
        applied = applied + out
        feedback.append((np.asarray(applied), np.asarray(e)))
    return {"leaf": (np.asarray(mean), np.asarray(err)),
            "tree": ({k: np.asarray(v) for k, v in tmean.items()},
                     {k: np.asarray(v) for k, v in terr.items()}),
            "feedback": feedback}


def _port(n: int) -> list:
    """Each shard's results of the port: in this process for one shard,
    else from the spawn."""
    if n == 1:
        return [st.compression_case(TPGroup(0, 1), 1, *_data(1))]
    if "ranks" not in _CACHED:
        got, codes = st.spawn(st.compression_main, 4,
                              {m: _data(m) for m in (2, 4)}, RANK_TIMEOUT_S)
        for r, res in enumerate(got):
            if isinstance(res, str):
                pytest.fail(f"rank {r} failed:\n{res}")
        assert codes == [0] * 4, codes
        _CACHED["ranks"] = got
    return [_CACHED["ranks"][r][n] for r in range(n)]


@pytest.mark.parametrize("n", SHARDS)
def test_codes_match_the_reference(n):
    """K1's codes of every shard's ``g + err`` at the shared threshold
    against the reference's ``compress``: the differing codes are counted,
    and none differ."""
    grads, errs = _data(n)
    cs = [[g[0] + e[0]] + [g[1][k] + e[1][k] for k in TREE]
          for g, e in zip(grads, errs)]
    differ = total = 0
    for i in range(len(cs[0])):
        amax = max(float(np.abs(c[i]).max()) for c in cs)
        scale = jnp.maximum(jnp.float32(amax), 1e-12) / 127.0
        assert compression.scale_of(amax) == float(scale)
        for c in cs:
            got = compression.compress(torch.as_tensor(c[i]), amax).numpy()
            want = np.asarray(jcomp.compress(jnp.asarray(c[i]), scale))
            differ += int((got != want).sum())
            total += got.size
    assert total > 0 and differ == 0, (differ, total)


@pytest.mark.parametrize("n", SHARDS)
def test_means_and_error_states_match_the_reference(n):
    """``ef_compressed_mean`` of a leaf and ``tree_ef_compressed_mean`` of
    a tree on every shard: the mean and the new error state equal the
    reference's bit for bit."""
    want = _reference(n)
    for r, got in enumerate(_port(n)):
        for part in (0, 1):
            np.testing.assert_array_equal(got["leaf"][part],
                                          want["leaf"][part][r])
            for k in TREE:
                np.testing.assert_array_equal(got["tree"][part][k],
                                              want["tree"][part][k][r],
                                              err_msg=f"{r} {k}")


@pytest.mark.parametrize("n", SHARDS)
def test_error_feedback_over_eight_steps(n):
    """Over 8 steps on a fixed gradient per shard: the applied means and
    every shard's residual equal the reference's; the applied sum plus the
    shards' mean residual is ``steps × the mean gradient`` (the identity of
    ``tests/test_substrate.py``, which has one shard), and the last mean is
    within one int8 step of the mean gradient."""
    want = _reference(n)
    port = _port(n)
    grads, _ = _data(n)
    g = np.mean(np.stack([x[0] for x in grads]), axis=0)
    for step in range(st.EF_STEPS):
        applied = port[0]["feedback"][step][0]
        for r, res in enumerate(port):
            np.testing.assert_array_equal(res["feedback"][step][0],
                                          want["feedback"][step][0][r])
            np.testing.assert_array_equal(res["feedback"][step][1],
                                          want["feedback"][step][1][r])
        err = np.mean(np.stack([res["feedback"][step][1] for res in port]),
                      axis=0)
        np.testing.assert_allclose(applied + err, g * (step + 1),
                                   rtol=1e-4, atol=1e-4)
    last = port[0]["feedback"][-1][0] - port[0]["feedback"][-2][0]
    amax = max(float(np.abs(x[0]).max()) for x in grads)
    np.testing.assert_allclose(last, g, atol=amax / 127 + 1e-6)


@pytest.mark.parametrize("n_params,n_shards", [
    (1_000_000, 16), (69_275_648, 2), (69_275_648, 4), (12_345, 3),
    (7, 1)])
def test_wire_formulas_match_the_reference(n_params, n_shards):
    assert compression.wire_bytes_fp32_allreduce(n_params, n_shards) == \
        jcomp.wire_bytes_fp32_allreduce(n_params, n_shards)
    assert compression.wire_bytes_int8_gather(n_params, n_shards) == \
        jcomp.wire_bytes_int8_gather(n_params, n_shards)
    if (n_params, n_shards) == (1_000_000, 16):
        # tests/test_substrate.py:240-244
        assert compression.wire_bytes_fp32_allreduce(n_params, n_shards) / \
            compression.wire_bytes_int8_gather(n_params, n_shards) == \
            pytest.approx(8.0, rel=1e-6)


def test_init_error_state():
    g = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.ones(5)}
    e = compression.init_error_state(g)
    assert all(v.dtype == torch.float32 and not v.any() for v in e.values())
    assert e["a"].shape == (3, 4) and e["b"].shape == (5,)
