"""The port's plain kernel versions (``repro_torch/kernels/ref.py``) and op
dispatch (``repro_torch/kernels/ops.py``) against the JAX package's kernels.

Every input is made with numpy from a seed and handed to both sides.  The
JAX side runs each op twice: through its plain jnp version
(``impl="xla"``) and through the Pallas kernel in interpret mode
(``impl="interpret"``).  The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``); on these CPU tensors
``impl="auto"`` takes the plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.qtensor import QTensor as JQTensor
from repro.kernels import ops as jops
from repro.models import kv_cache as jkv

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops, ref
from repro_torch.models import kv_cache as kv

JAX_IMPLS = ("xla", "interpret")


def _half_boundary_rows(M: int, K: int, rng) -> np.ndarray:
    """Rows whose values sit exactly on .5 code boundaries for scale 1.0
    (each row's abs-max is 127): rint must round half to even."""
    x = rng.integers(-126, 126, (M, K)).astype(np.float32) + 0.5
    x[:, 0] = 127.0
    return x


def _inputs(kind: str, M: int, K: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((M, K)).astype(np.float32) * 3
    return _half_boundary_rows(M, K, rng)


# ---------------------------------------------------------------------------
# K1: calibrated static quantizer — exact int8 codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("kind,amax", [("normal", 4.5), ("normal", 0.0),
                                       ("half", 127.0), ("half", 31.75)])
@pytest.mark.parametrize("M", [1, 12, 37])
def test_quantize_static_codes_equal(impl, kind, amax, M):
    x = _inputs(kind, M, 96, seed=M)
    want = np.asarray(jops.quantize_static(jnp.asarray(x), amax,
                                           impl=impl).data)
    got = ops.quantize_static(torch.from_numpy(x), amax)
    np.testing.assert_array_equal(got.data.numpy(), want)
    # the QTensor scale is float32(amax)/127 without the eps clamp
    jscale = jops.quantize_static(jnp.asarray(x), amax, impl="xla").scale
    assert np.float32(got.scale) == np.asarray(jscale, np.float32)


@pytest.mark.parametrize("impl", JAX_IMPLS)
def test_quantize_static_bf16_input(impl):
    x = torch.from_numpy(_inputs("normal", 12, 64, seed=3)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jops.quantize_static(xj, 5.0, impl=impl).data)
    np.testing.assert_array_equal(ops.quantize_static(x, 5.0).data.numpy(),
                                  want)


# ---------------------------------------------------------------------------
# K2: dynamic row-wise quantizer — exact codes, bit-equal scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("kind", ["normal", "half"])
@pytest.mark.parametrize("M", [1, 12, 37])
def test_quantize_rowwise_codes_and_scales_equal(impl, kind, M):
    """Codes and scales are bit-equal to the reference's as its engine runs
    it, jitted: XLA rewrites the division ``amax / 127`` of the plain
    version into ``amax * float32(1/127)``, which the Pallas kernel in
    interpret mode computes too (``tests/test_torch_jit_forms.py``)."""
    x = _inputs(kind, M, 80, seed=100 + M)
    if impl == "xla":
        want = jax.jit(lambda v: jops.quantize_rowwise(v, impl="xla"))(
            jnp.asarray(x))
    else:
        want = jops.quantize_rowwise(jnp.asarray(x), impl=impl)
    got = ops.quantize_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    ulps = np.abs(got.scale.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(want.scale).view(np.int32).astype(np.int64))
    assert ulps.max() == 0, ulps.max()


def test_quantize_rowwise_flattens_leading_dims():
    x = _inputs("normal", 6, 32, seed=7).reshape(2, 3, 32)
    got = ops.quantize_rowwise(torch.from_numpy(x))
    want = jax.jit(lambda v: jops.quantize_rowwise(v, impl="xla"))(
        jnp.asarray(x))
    assert tuple(got.data.shape) == (2, 3, 32)
    assert tuple(got.scale.shape) == (2, 3, 1)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


# ---------------------------------------------------------------------------
# K3: int8 matmul — exact s32 accumulator, epilogue in the reference order
# ---------------------------------------------------------------------------

def _mm_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    a_scale = (rng.random((M, 1)) * 0.05 + 1e-3).astype(np.float32)
    b_scale = (rng.random((1, N)) * 0.05 + 1e-3).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    return a, b, a_scale, b_scale, bias


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (16, 130, 130), (33, 64, 48)])
def test_int8_matmul_accumulator_exact(M, K, N):
    """Unit scales, no zp, no bias: the f32 output is the s32 sum itself."""
    a, b, *_ = _mm_inputs(M, K, N, seed=M + K)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    one = np.ones((1, 1), np.float32)
    got = ref.ref_int8_matmul(torch.from_numpy(a), torch.from_numpy(one),
                              torch.from_numpy(b),
                              torch.ones((1, N)))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    for impl in JAX_IMPLS:
        want = jops.int8_matmul(
            JQTensor(jnp.asarray(a), jnp.float32(1.0), jnp.float32(0.0)),
            JQTensor(jnp.asarray(b), jnp.ones((1, N)), jnp.float32(0.0)),
            impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("zp", [0.0, 3.0])
@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (16, 130, 130), (33, 64, 48)])
def test_int8_matmul_epilogue(impl, per_row, zp, M, K, N):
    """Scales, zero point and bias: rtol 1e-6 (the same f32 op sequence on
    both sides).  The Pallas kernel in interpret mode may also contract the
    bias add into an FMA, which moves a result by up to one ulp of the
    scaled product; where the bias cancels that product, that ulp is large
    relative to the result, so against it each element may also be off by
    2^-22 · |product|.  A scalar activation scale is a calibrated constant:
    the jitted engine folds it into the weight scales first
    (``acc · (a_scale · b_scale)``, ``tests/test_torch_jit_forms.py``), so
    the reference gets it so folded, with unit activation scale."""
    a, b, a_scale, b_scale, bias = _mm_inputs(M, K, N, seed=7 * M + N)
    a_s = a_scale if per_row else np.float32(0.0123)
    aq = QTensor(torch.from_numpy(a),
                 torch.from_numpy(a_s) if per_row else float(a_s), zp)
    bq = QTensor(torch.from_numpy(b), torch.from_numpy(b_scale), 0.0)
    got = ops.int8_matmul(aq, bq, torch.from_numpy(bias)).numpy()
    ja_s, jb_s = ((a_s, b_scale) if per_row
                  else (np.float32(1.0), a_s * b_scale))
    want = np.asarray(jops.int8_matmul(
        JQTensor(jnp.asarray(a), jnp.asarray(ja_s), jnp.float32(zp)),
        JQTensor(jnp.asarray(b), jnp.asarray(jb_s), jnp.float32(0.0)),
        jnp.asarray(bias), impl=impl))
    tol = 1e-6 * np.abs(want)
    if impl == "interpret":
        product = ops.int8_matmul(aq, bq).numpy()
        tol = tol + 2.0 ** -22 * np.abs(product)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_int8_matmul_flattens_leading_dims_and_casts():
    a, b, a_scale, b_scale, bias = _mm_inputs(6, 32, 24, seed=5)
    aq = QTensor(torch.from_numpy(a).reshape(2, 3, 32),
                 torch.from_numpy(a_scale).reshape(2, 3, 1), 0.0)
    bq = QTensor(torch.from_numpy(b), torch.from_numpy(b_scale), 0.0)
    got = ops.int8_matmul(aq, bq, out_dtype=torch.bfloat16)
    flat = ref.ref_int8_matmul(torch.from_numpy(a), torch.from_numpy(a_scale),
                               torch.from_numpy(b), torch.from_numpy(b_scale))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 24)
    assert torch.equal(got.reshape(6, 24), flat.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# K4: decode attention over an int8 cache — f32, atol/rtol 1e-5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("H,HKV", [(4, 4), (4, 2), (6, 1)])
def test_decode_attention_matches(impl, H, HKV):
    """Ragged lengths (incl. 1 and the full capacity) and G = H/HKV > 1.
    1e-5: the Pallas kernel's online softmax reorders the f32 sums."""
    rng = np.random.default_rng(H * 10 + HKV)
    B, S, dh = 4, 40, 16
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.integers(-127, 128, (B, S, HKV, dh)).astype(np.int8)
    v = rng.integers(-127, 128, (B, S, HKV, dh)).astype(np.int8)
    ks = (rng.random((B, S, HKV)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((B, S, HKV)) * 0.02 + 1e-3).astype(np.float32)
    lengths = np.array([1, 17, 40, 29], np.int32)
    sm = 1.0 / np.sqrt(dh)
    got = ops.decode_attention(*map(torch.from_numpy,
                                    (q, k, ks, v, vs, lengths)), sm_scale=sm)
    want = jops.decode_attention(*map(jnp.asarray, (q, k, ks, v, vs, lengths)),
                                 sm_scale=sm, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# quantize_kv (plain on both sides, on the decode path) and dispatch rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "half"])
def test_quantize_kv_codes_and_scales_equal(kind):
    x = _inputs(kind, 24, 16, seed=11).reshape(3, 2, 4, 16)
    q, s = kv.quantize_kv(torch.from_numpy(x))
    jq, js = jax.jit(jkv.quantize_kv)(jnp.asarray(x))     # as the engine runs
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def test_impl_cuda_on_cpu_raises():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.quantize_rowwise(x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.quantize_static(x, 1.0, impl="cuda")
    aq = QTensor(torch.zeros((2, 8), dtype=torch.int8), 1.0, 0.0)
    bq = QTensor(torch.zeros((8, 4), dtype=torch.int8), torch.ones((1, 4)), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.int8_matmul(aq, bq, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.quantize_rowwise(x, impl="pallas")


def test_auto_and_torch_agree_on_cpu_and_launch_nothing():
    ops.reset_launch_counts()
    x = torch.from_numpy(_inputs("normal", 5, 32, seed=2))
    a = ops.quantize_rowwise(x, impl="auto")
    b = ops.quantize_rowwise(x, impl="torch")
    assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
    assert all(n == 0 for n in ops.launch_counts().values())
