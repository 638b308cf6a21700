"""The port's block-wise INT4 weights against the JAX package (no trained
model here; the end-to-end INT4 tests are in ``test_torch_slice.py`` and
``test_torch_serve.py``).

Every input is made with numpy from a seed and handed to both sides:
nibble packing, ``quantize_block`` (with and without its ALS refinement),
the plain INT4-weight matmul against the reference's plain version and its
Pallas kernel in interpret mode, the INT4 routing of ``quantize_model`` and
its byte counts, and the bridge that carries a reference INT4 tree into the
port.  The last test checks that neither the port nor ``chip_smoke.py``
imports JAX or the JAX package.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import count_quantized as jcount_quantized
from repro.core import int4_eligible_site as jint4_eligible_site
from repro.core import quantize_model as jquantize_model
from repro.core import weight_bytes_by_site as jweight_bytes_by_site
from repro.core import qtensor as jqt
from repro.core.qtensor import BlockQTensor as JBlockQTensor
from repro.core.qtensor import QTensor as JQTensor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.int4_matmul import int4_matmul_pallas
from repro.models import build_model

from repro_torch.checkpoint.bridge import block_meta_of, params_from_flat
from repro_torch.core import (
    BlockQTensor,
    QTensor,
    QuantPolicy,
    count_quantized,
    int4_eligible_site,
    quantize_block,
    quantize_model,
    weight_bytes_by_site,
)
from repro_torch.core import qtensor as qt
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parent.parent
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)
SCALE_DTYPES = {"f16": (jnp.float16, torch.float16),
                "f32": (jnp.float32, torch.float32)}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype == np.float16 else np.uint32)


# ---------------------------------------------------------------------------
# nibble packing
# ---------------------------------------------------------------------------

def test_pack_byte_layout():
    """Row 2r is the low nibble, row 2r+1 the high one; a high nibble of 8
    or more makes a negative int8 and unpacks without sign extension."""
    q = torch.tensor([[1, 15], [2, 9], [0, 8], [15, 0]], dtype=torch.int32)
    packed = qt.pack_nibbles(q)
    assert packed.dtype == torch.int8
    assert packed.view(torch.uint8).tolist() == [[0x21, 0x9F], [0xF0, 0x08]]
    assert torch.equal(qt.unpack_nibbles(packed), q)
    with pytest.raises(ValueError, match="even"):
        qt.pack_nibbles(q[:3])


@pytest.mark.parametrize("shape", [(6, 5), (3, 128, 64)])
def test_pack_unpack_equal_reference(shape):
    q = np.random.default_rng(len(shape)).integers(0, 16, shape)
    got = qt.pack_nibbles(torch.from_numpy(q))
    want = np.asarray(jqt.pack_nibbles(jnp.asarray(q)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(qt.unpack_nibbles(got).numpy(), q)
    np.testing.assert_array_equal(
        qt.unpack_nibbles(got).numpy(),
        np.asarray(jqt.unpack_nibbles(jnp.asarray(want))))


# ---------------------------------------------------------------------------
# quantize_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_dtype", ["f16", "f32"])
@pytest.mark.parametrize("refine_iters", [0, 3])
@pytest.mark.parametrize("K,N,G", [(512, 512, 128), (200, 64, 32),
                                   (96, 40, 2)])
def test_quantize_block_equals_reference(K, N, G, refine_iters, scale_dtype):
    """Packed codes equal in every case.  Without ALS the scales and
    minimums are bit-identical too.  With ALS its four f32 group sums are
    reductions whose order torch and XLA each choose, and they do not agree
    on the CPU (about a quarter of 512 column sums of 128 values are
    bit-equal).  Measured at these shapes: every code equal; f16 parameters
    at most 1 f16 ulp apart (1 of 2048 scales at 512 × 512, G = 128); f32
    parameters at most 99 ulps (1.5e-5 relative, at K = 200, G = 32)."""
    jd, td = SCALE_DTYPES[scale_dtype]
    w = (np.random.default_rng(K + G).standard_normal((K, N)) * 0.05
         ).astype(np.float32)
    want = jqt.quantize_block(jnp.asarray(w), G, jd, refine_iters)
    got = quantize_block(torch.from_numpy(w), G, td, refine_iters)
    assert (got.group_size, got.k_dim, got.n_groups, got.shape) == (
        want.group_size, want.k_dim, want.n_groups, tuple(want.shape))
    assert got.scale.dtype == td and got.vmin.dtype == td
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.nbytes() == want.nbytes()
    for g, w_ in ((got.scale, want.scale), (got.vmin, want.vmin)):
        ulps = np.abs(_bits(g.numpy()).astype(np.int64)
                      - _bits(w_).astype(np.int64))
        if not refine_iters:
            assert ulps.max() == 0
        elif scale_dtype == "f16":
            assert ulps.max() <= 1
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=3e-5,
                                       atol=1e-9)
    if not refine_iters:
        np.testing.assert_array_equal(got.dequantize().numpy(),
                                      np.asarray(want.dequantize()))


def test_quantize_block_edge_pads_the_tail_group():
    """K = 200 in groups of 32: the tail group repeats row 199, so its
    min/max (and scale) are those of its 8 real rows."""
    w = np.random.default_rng(5).standard_normal((200, 16)).astype(np.float32)
    bq = quantize_block(torch.from_numpy(w), 32, torch.float32, 0)
    assert bq.data.shape == (112, 16) and bq.n_groups == 7
    tail = w[192:]
    np.testing.assert_array_equal(bq.vmin[6].numpy(), tail.min(0))
    codes = qt.unpack_nibbles(bq.data)
    np.testing.assert_array_equal(codes[200:].numpy(),
                                  np.repeat(codes[199:200].numpy(), 24, 0))
    assert bq.dequantize().shape == (200, 16)
    with pytest.raises(ValueError, match="even"):
        quantize_block(torch.from_numpy(w), 33)


# ---------------------------------------------------------------------------
# the plain INT4-weight matmul (K6's plain version)
# ---------------------------------------------------------------------------

def _int4_inputs(M, K, N, G, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    bq = jqt.quantize_block(jnp.asarray(w), G)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    a_s = (rng.random((M, 1)) * 0.02).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    return a, a_s, bq, bias


def _port_args(a, a_s, bq, bias):
    return (torch.from_numpy(a), torch.from_numpy(a_s),
            torch.from_numpy(np.array(bq.data)),
            torch.from_numpy(np.array(bq.scale)),
            torch.from_numpy(np.array(bq.vmin)), torch.from_numpy(bias))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("zp", [None, 3.0])
@pytest.mark.parametrize("M,K,N,G", [(16, 512, 512, 128), (5, 200, 64, 32),
                                     (7, 96, 40, 2), (3, 128, 128, 128),
                                     (9, 130, 72, 4)])
def test_ref_int4_matmul_equals_reference(M, K, N, G, zp, out):
    """Against the reference's plain version: bit-identical, with and
    without a zero point, f32 and bf16 out, one group (K = G = 128) and
    padded tails (K = 200 in 7 groups of 32, 130 in 33 groups of 4).

    Against the Pallas kernel in interpret mode: f32 within 4 ulps of the
    output's magnitude, bf16 within one bf16 ulp.  The interpret-mode
    kernel runs under ``jit``, where XLA contracts ``d·scale + rowsum·min``
    into an FMA (measured: 70–82% of the f32 outputs equal, at most 2 ulps
    of ``max|out|`` apart, and 2 of 8192 bf16 outputs one ulp apart at
    16 × 512 × 512 with a zero point); the reference's plain version and
    the port keep every product rounded."""
    a, a_s, bq, bias = _int4_inputs(M, K, N, G, seed=M * K)
    jd = jnp.float32 if out == "f32" else jnp.bfloat16
    td = torch.float32 if out == "f32" else torch.bfloat16
    jzp = None if zp is None else jnp.float32(zp)
    jargs = (jnp.asarray(a), jnp.asarray(a_s), bq.data, bq.scale, bq.vmin,
             jzp, jnp.asarray(bias))
    want = np.asarray(jref.ref_int4_matmul(*jargs, group_size=G,
                                           out_dtype=jd).astype(jnp.float32))
    pallas = np.asarray(int4_matmul_pallas(
        *jargs, group_size=G, out_dtype=jd,
        interpret=True).astype(jnp.float32))
    ta, ts, tb, tsc, tmn, tbias = _port_args(a, a_s, bq, bias)
    got = ref.ref_int4_matmul(ta, ts, tb, tsc, tmn, zp, tbias, group_size=G,
                              out_dtype=td).float().numpy()
    np.testing.assert_array_equal(got, want)
    if out == "bf16":
        np.testing.assert_allclose(got, pallas, rtol=2.0 ** -7, atol=0)
    else:
        ulp = np.spacing(np.abs(want).max())
        np.testing.assert_allclose(got, pallas, rtol=0, atol=4 * ulp)


def test_ref_int4_matmul_padding_contributes_zero():
    """Activations past K count as zero: padding ``a`` to the stored K with
    zeros gives the same result bit for bit."""
    a, a_s, bq, bias = _int4_inputs(6, 200, 48, 32, seed=3)
    ta, ts, tb, tsc, tmn, tbias = _port_args(a, a_s, bq, bias)
    padded = torch.nn.functional.pad(ta, (0, 24))
    assert torch.equal(
        ref.ref_int4_matmul(ta, ts, tb, tsc, tmn, None, tbias, group_size=32),
        ref.ref_int4_matmul(padded, ts, tb, tsc, tmn, None, tbias,
                            group_size=32))


@pytest.mark.parametrize("act", ["rowwise", "static"])
def test_ops_int4_matmul_flattens_batch_dims(act):
    """``ops.int4_matmul`` on (2, 3, K) activations equals the reference's
    op (``impl="xla"``), per-row or scalar scale."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    jb = jqt.quantize_block(jnp.asarray(w), 32)
    tb = BlockQTensor(torch.from_numpy(np.array(jb.data)),
                      torch.from_numpy(np.array(jb.scale)),
                      torch.from_numpy(np.array(jb.vmin)), 32, 96)
    if act == "rowwise":
        jx = jops.quantize_rowwise(jnp.asarray(x), impl="xla")
        tx = ops.quantize_rowwise(torch.from_numpy(x))
    else:
        jx = jops.quantize_static(jnp.asarray(x), 2.5, impl="xla")
        tx = ops.quantize_static(torch.from_numpy(x), 2.5)
    want = np.asarray(jops.int4_matmul(jx, jb, jnp.asarray(bias),
                                       impl="xla"))
    got = ops.int4_matmul(tx, tb, torch.from_numpy(bias))
    assert got.shape == (2, 3, 40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_int4_matmul_refuses_bad_weights():
    tb = quantize_block(torch.randn(64, 8), 32)
    x = ops.quantize_rowwise(torch.randn(3, 60))
    with pytest.raises(ValueError, match="K mismatch"):
        ops.int4_matmul(x, tb)
    stacked = BlockQTensor(tb.data[None], tb.scale[None], tb.vmin[None], 32,
                           64)
    with pytest.raises(ValueError, match="2-D"):
        ops.int4_matmul(ops.quantize_rowwise(torch.randn(3, 64)), stacked)
    with pytest.raises(ValueError, match="CUDA"):
        ops.int4_matmul(ops.quantize_rowwise(torch.randn(3, 64)), tb,
                        impl="cuda")


# ---------------------------------------------------------------------------
# quantize_model(weight_bits=4), byte counts, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", [
    "dec_blocks.0/ffn/in", "dec_blocks.1/ffn/out", "dec_blocks/ffn/gate",
    "dec_blocks.3/self_attn/o_proj", "dec_blocks.0/cross_attn/o_proj",
    "dec_blocks.0/self_attn/q_proj", "dec_blocks.0/cross_attn/kv_proj",
    "enc_blocks.0/ffn/in", "enc_blocks.0/attn/o_proj", "embed",
    "dec_blocks.0/ffn/w"])
def test_int4_eligible_site_equals_reference(site):
    assert int4_eligible_site(site) == jint4_eligible_site(site)


@pytest.fixture(scope="module")
def nmt_random():
    cfg = jget_config("transformer-base").reduced(**NMT)
    jparams = build_model(cfg).init(jax.random.PRNGKey(7))
    return jparams, params_from_flat(_flatten_with_paths(jparams),
                                     device="cpu")


def _types(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out.update(_types(v, path))
        else:
            out["/".join(path)] = type(v).__name__
    return out


@pytest.mark.parametrize("weight_bits", [4, 8])
def test_quantize_model_routing_and_bytes_equal_reference(nmt_random,
                                                          weight_bits):
    """The same sites go to INT4 (the decoder FFN and both attention output
    projections), INT8 or FP; ``count_quantized`` and
    ``weight_bytes_by_site`` equal the reference's; the INT4 leaves are the
    reference's bit for bit (f16 parameters, ALS on)."""
    jparams, fp = nmt_random
    policy = dict(act_quant="dynamic")
    jq, _ = jquantize_model(jparams, {}, JQuantPolicy(**policy),
                            weight_bits=weight_bits)
    pq, _ = quantize_model(fp, {}, QuantPolicy(**policy),
                           weight_bits=weight_bits, device="cpu")
    jtypes = {k: v.replace("ArrayImpl", "Tensor")
              for k, v in _types(jq).items()}
    assert _types(pq) == jtypes
    assert count_quantized(pq) == jcount_quantized(jq)
    assert weight_bytes_by_site(pq) == jweight_bytes_by_site(jq)
    n4 = count_quantized(pq)["int4_linears"]
    assert n4 == (4 * NMT["n_layers"] if weight_bits == 4 else 0)
    for site, meta in block_meta_of(jq).items():
        node = pq
        for k in site.split("/"):
            node = node[k]
        jw = jq
        for k in site.split("/"):
            jw = jw[k]
        jw, w = jw["w"], node["w"]
        assert (w.group_size, w.k_dim) == meta
        np.testing.assert_array_equal(w.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(_bits(w.scale.numpy()), _bits(jw.scale))
        np.testing.assert_array_equal(_bits(w.vmin.numpy()), _bits(jw.vmin))


def test_quantize_model_refuses_other_bit_widths(nmt_random):
    with pytest.raises(ValueError, match="weight_bits"):
        quantize_model(nmt_random[1], {}, weight_bits=2, device="cpu")


def test_bridge_round_trips_a_reference_int4_tree(nmt_random):
    """A reference INT4 tree flattened as the checkpointer writes it comes
    back leaf for leaf, with BlockQTensors where ``block_meta`` names them
    (one group at the 128-row output projections: K = G = 128)."""
    jparams, _ = nmt_random
    jq, _ = jquantize_model(jparams, {}, JQuantPolicy(act_quant="dynamic"),
                            weight_bits=4)
    flat = _flatten_with_paths(jq)
    meta = block_meta_of(jq)
    assert meta["dec_blocks.0/self_attn/o_proj"] == (128, 128)
    assert meta["dec_blocks.1/ffn/out"] == (128, 256)
    got = params_from_flat(flat, device="cpu", block_meta=meta)
    n_block = 0
    for site in _types(jq):
        node, jnode = got, jq
        for k in site.split("/"):
            node, jnode = node[k], jnode[k]
        if isinstance(jnode, (JQTensor, JBlockQTensor)):
            kind = BlockQTensor if isinstance(jnode, JBlockQTensor) \
                else QTensor
            assert isinstance(node, kind), site
            n_block += kind is BlockQTensor
            leaves = ((node.data, node.scale, node.vmin)
                      if kind is BlockQTensor
                      else (node.data, node.scale, node.zero_point))
            jleaves = jax.tree_util.tree_leaves(jnode)
            for g, w in zip(leaves, jleaves):
                assert g.dtype == {np.dtype(np.int8): torch.int8,
                                   np.dtype(np.float16): torch.float16,
                                   np.dtype(np.float32): torch.float32}[
                    np.asarray(w).dtype]
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(jnode))
    assert n_block == len(meta) == 8


def test_bridge_refuses_an_unnamed_int4_triple(nmt_random):
    """Without ``block_meta`` an INT4 triple is refused, not guessed: with
    f16 parameters by their dtype, and with one group of f32 parameters
    (the shapes of a QTensor's) by its non-zero minimums.  A ``block_meta``
    site with no quantized weight is refused too."""
    jparams, _ = nmt_random
    for scale_dtype in (jnp.float16, jnp.float32):
        jq, _ = jquantize_model(jparams, {},
                                JQuantPolicy(act_quant="dynamic"),
                                weight_bits=4,
                                weight_scale_dtype=scale_dtype)
        flat = _flatten_with_paths(jq)
        with pytest.raises(ValueError, match="block_meta"):
            params_from_flat(flat, device="cpu")
    with pytest.raises(KeyError, match="block_meta"):
        params_from_flat(flat, device="cpu",
                         block_meta={**block_meta_of(jq),
                                     "enc_blocks.0/ffn/in/nope": (128, 128)})
    bad = dict(block_meta_of(jq))
    bad["dec_blocks.0/ffn/in"] = (64, 128)
    with pytest.raises(ValueError, match="not a BlockQTensor"):
        params_from_flat(flat, device="cpu", block_meta=bad)


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_no_jax():
    """Import every ``repro_torch`` module (the prefix cache, preemption,
    chaos and watchdog modules, the training path's optimizer, step,
    loop, data pipeline, checkpointer and driver, the recurrent
    families' modules and the multi-GPU modules, the training mesh's
    among them),
    ``chip_smoke`` and the chip tools in a fresh interpreter: neither
    ``jax`` nor ``repro`` may be in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import int4_ab, int8_tile_sweep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "want = {'repro_torch.serving.prefix_cache', "
        "'repro_torch.serving.preemption', 'repro_torch.serving.chaos', "
        "'repro_torch.distributed.fault', 'repro_torch.optim.adamw', "
        "'repro_torch.optim.schedule', 'repro_torch.train.step', "
        "'repro_torch.train.loop', 'repro_torch.data.pipeline', "
        "'repro_torch.checkpoint.checkpointer', 'repro_torch.launch.train', "
        "'repro_torch.tree', 'repro_torch.models.ssm', "
        "'repro_torch.models.hybrid', 'repro_torch.models.xlstm', "
        "'repro_torch.models.xlstm_model', "
        "'repro_torch.distributed.sharding', "
        "'repro_torch.distributed.collectives', 'repro_torch.launch.mesh', "
        "'repro_torch.launch.roofline', 'repro_torch.serving.sharding', "
        "'repro_torch.serving.router', "
        "'repro_torch.distributed.compression', "
        "'repro_torch.distributed.context', 'repro_torch.launch.specs'}\n"
        "missing = sorted(want - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 20 else 0)\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
