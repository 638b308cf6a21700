"""The port's sharding rules, decode-state specs, mesh helpers and
analytic roofline terms against the reference's.

* ``distributed.sharding.param_specs``: every leaf of the port's tree
  splits the same dimension over the same mesh axes as the reference's
  ``PartitionSpec`` of that leaf (exactly), counted from the last
  dimension, since the port's per-layer leaves lose the reference's
  leading layer axes.  Transformer-base reduced in FP, INT8 and INT4, the
  MoE tree, the dense SwiGLU tree (mistral-nemo-12b), both recurrent
  trees and GQA with 2 kv heads, at tp 2 and 4,
  with the fsdp axis off (serving) and on.  ``shard_params`` cuts each
  leaf to its rank's block.
* ``serving.sharding``: ``decode_state_specs`` equals the reference's on
  paged and contiguous states; ``shard_decode_state`` gives the local
  model's fresh state; ``kv_pools_shardable``, ``tp_degree`` and
  ``mesh_axis_sizes`` equal the reference's; ``local_config`` of the
  decoder-only families, and ``mark_parallel``'s expert mark.
* ``launch.roofline``: ``decode_collective_bytes``,
  ``weight_stream_bytes`` and ``model_flops`` equal the reference's
  exactly; ``sharded_decode_cell``'s terms equal the reference's once
  each is multiplied back by its hardware constant (1e-12 relative).
* ``launch.mesh``: the errors that name the ranks a mesh needs.
* ``models.layers`` on 2 and 4 ranks in threads (a barrier stands in for
  the all-reduce): a row-parallel INT8 linear (dynamic, static, affine)
  and an INT4 out-projection behind a gathered input equal the unsharded
  ones bit for bit, a float one within 1e-6; the vocab-parallel
  embedding exactly, its logits within 1e-6.
* K3's two halves: their plain versions compose to the plain K3 bit for
  bit (the kernels are held on the card by ``tests/test_torch_cuda.py``).
"""

import dataclasses
import importlib
import threading

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize_model as jquantize_model
from repro.distributed.sharding import param_specs as jparam_specs
from repro.launch import roofline as jroofline
from repro.models import build_model as jbuild_model

from repro_torch.checkpoint.bridge import block_meta_of, params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import FP_CONTEXT, QuantContext, QuantPolicy
from repro_torch.core.calibration import SiteCalibration
from repro_torch.core.histogram import HistogramClass
from repro_torch.core.qtensor import BlockQTensor, QTensor
from repro_torch.core.quantize import Thresholds
from repro_torch.distributed.collectives import (
    Parallel,
    TPGroup,
    mark_parallel,
)
from repro_torch.distributed.sharding import (
    axis_dim,
    batch_specs,
    param_specs,
    shard_params,
)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (
    batch_axes,
    fsdp_axes,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models import EncDecLM
from repro_torch.models.layers import dense, embed, unembed
from repro_torch.serving import sharding

from _torch_reference import import_reference_serving

import_reference_serving()
# a submodule by its name: a failed import of ``repro.serving`` earlier in
# the process (the JAX serving test files) leaves the package re-imported
# without its submodule attributes
jsharding = importlib.import_module("repro.serving.sharding")
REDUCED = dict(vocab=32, d_model=48, n_layers=1, n_enc_layers=1, d_ff=96,
               n_heads=4, n_kv_heads=4, head_dim=16)
# (name, arch, reduced() overrides, weights)
TREES = [
    ("tb-fp", "transformer-base", REDUCED, "fp"),
    ("tb-int8", "transformer-base", REDUCED, "int8"),
    ("tb-int4", "transformer-base", REDUCED, "int4"),
    ("tb-gqa", "transformer-base", dict(REDUCED, n_kv_heads=2), "fp"),
    ("moe", "granite-moe-1b-a400m", {}, "int8"),
    ("dense", "mistral-nemo-12b", {}, "int8"),
    ("zamba2", "zamba2-2.7b", {}, "fp"),
    ("xlstm", "xlstm-1.3b", {}, "fp"),
]
_CACHED = {}


class _FakeMesh:
    """The reference test's stand-in: axis names and sizes only."""
    axis_names = ("data", "model")

    def __init__(self, tp, data=1):
        self.shape = {"data": data, "model": tp}


def _trees(name):
    """(reference tree, port tree, kv heads) of one entry of TREES."""
    if name not in _CACHED:
        _, arch, over, weights = next(t for t in TREES if t[0] == name)
        jcfg = jget_config(arch).reduced(**over)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        if weights != "fp":
            jparams = jquantize_model(
                jparams, {}, JQuantPolicy(act_quant="dynamic"),
                **(dict(weight_bits=4, weight_group_size=16)
                   if weights == "int4" else {}))[0]
        port = params_from_flat(_flatten_with_paths(jparams), device="cpu",
                                block_meta=block_meta_of(jparams))
        _CACHED[name] = (jparams, port, jcfg.n_kv_heads)
    return _CACHED[name]


def _flat(tree, prefix=""):
    """``{path: spec}`` over dicts and quantized-tensor nodes (leaves
    ``0, 1, 2`` as the checkpointer names them), either package's."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif hasattr(tree, "data") and (hasattr(tree, "zero_point")
                                    or hasattr(tree, "vmin")):
        third = tree.zero_point if hasattr(tree, "zero_point") else tree.vmin
        for i, leaf in enumerate((tree.data, tree.scale, third)):
            out[f"{prefix}{i}"] = leaf
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _from_end(spec) -> set:
    """The split entries of a spec, by dimension counted from the last."""
    spec = tuple(spec)
    return {(d - len(spec), e) for d, e in enumerate(spec) if e is not None}


def _ref_key(key: str, want, jflat) -> str:
    """The reference's path of a port leaf path: the same, or the stacked
    root of a per-layer one."""
    head, _, rest = key.partition("/")
    if key in want or "." not in head:
        return key
    root, idx = head.split(".")
    if root == "blocks" and any(k.startswith("mlstm/") for k in jflat):
        m = next(np.shape(a)[1] for k, a in jflat.items()
                 if k.startswith("mlstm/"))
        root = "slstm" if int(idx) % (m + 1) == m else "mlstm"
    return f"{root}/{rest}"


@pytest.mark.parametrize("tp,data,fsdp", [(2, 1, None), (4, 1, None),
                                          (2, 2, "data")])
@pytest.mark.parametrize("name", [t[0] for t in TREES])
def test_param_specs_equal_reference(name, tp, data, fsdp):
    jtree, port, hkv = _trees(name)
    mesh = _FakeMesh(tp, data)
    want = _flat(jparam_specs(jtree, mesh, tensor="model", fsdp=fsdp,
                              kv_heads=hkv))
    got = _flat(param_specs(port, mesh, tensor="model", fsdp=fsdp,
                            kv_heads=hkv))
    jflat = _flatten_with_paths(jtree)
    assert got and len(got) >= len(want)
    n_split = 0
    for key, spec in got.items():
        ref = want[_ref_key(key, want, jflat)]
        assert _from_end(spec) == _from_end(ref), (key, spec, ref)
        n_split += bool(_from_end(spec))
    assert n_split > 0


@pytest.mark.parametrize("name", ["tb-fp", "tb-int8", "tb-int4", "moe",
                                  "dense"])
def test_shard_params_cuts_each_leaf(name):
    """Rank r's block of every split dimension, the rest whole."""
    _, port, hkv = _trees(name)
    mesh = _FakeMesh(2, 2)
    specs = param_specs(port, mesh, fsdp="data", kv_heads=hkv)
    full, fspecs = _flat(port), _flat(specs)
    for coords in ({"data": 1, "model": 0}, {"data": 0, "model": 1}):
        local = _flat(shard_params(port, specs, mesh, coords))
        for key, t in full.items():
            if not isinstance(t, torch.Tensor):
                continue
            want = t
            for d, e in enumerate(fspecs[key]):
                if e is not None:
                    n = t.shape[d] // mesh.shape[e]
                    want = want.narrow(d, coords[e] * n, n)
            assert torch.equal(local[key], want), key
            assert local[key].is_contiguous()


def test_batch_specs_and_axes():
    mesh = _FakeMesh(2, 4)
    batch = {"src_tokens": torch.zeros(8, 5), "src_lengths": torch.zeros(6)}
    assert batch_specs(batch, mesh, ("data",)) == {
        "src_tokens": (("data",), None), "src_lengths": (None,)}
    assert batch_axes(mesh) == ("data",) and fsdp_axes(mesh) == ("data",)
    assert axis_dim((None, ("data", "model")), "model") == 1
    assert axis_dim((None, None), "model") is None


@pytest.mark.parametrize("paged", [False, True])
def test_decode_state_specs_equal_reference(paged):
    cfg = get_config("transformer-base").reduced(**REDUCED)
    jmodel = jbuild_model(jget_config("transformer-base").reduced(**REDUCED))
    kw = dict(quantized=True, enc_len=16, paged=paged, page_size=8,
              n_pages=16 if paged else None)
    jstate = jmodel.init_decode_state(4, 32, **kw)
    state = EncDecLM(cfg, device="cpu").init_decode_state(4, 32, **kw)
    for shard in (True, False):
        want = jsharding.decode_state_specs(
            jstate, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, shard_kv=shard)
        got = sharding.decode_state_specs(
            state, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, shard_kv=shard)
        pairs = [(got["cross_k"], want["cross_k"]),
                 (got["cross_v"], want["cross_v"]),
                 (got["src_lengths"], want["src_lengths"]),
                 (got["cache"].lengths, want["cache"].lengths)]
        c, w = got["cache"], want["cache"]
        if paged:
            pairs += [(c.k_store, w.k), (c.v_store, w.v),
                      (c.ks_store, w.k_scale), (c.vs_store, w.v_scale),
                      (c.block_tables, w.block_tables),
                      (c.own_pages, w.own_pages)]
        else:
            pairs += [(c.k, w.k), (c.v, w.v), (c.k_scale, w.k_scale),
                      (c.v_scale, w.v_scale)]
        for g, w in pairs:
            assert g == tuple(w)
        assert shard == (got["cross_k"] == (None, None, None, "model", None))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_decode_state_is_the_local_models_state(paged, tp):
    """A fresh state cut to rank 1's heads has the local config's shapes
    and holds rank 1's heads of the full state."""
    cfg = get_config("transformer-base").reduced(**REDUCED)
    mesh = _FakeMesh(tp)
    mesh.coords = {"data": 0, "model": 1}
    kw = dict(quantized=True, enc_len=16, paged=paged, page_size=8,
              n_pages=16 if paged else None)
    full = EncDecLM(cfg, device="cpu").init_decode_state(4, 32, **kw)
    full["cross_k"].copy_(torch.arange(full["cross_k"].numel()).reshape(
        full["cross_k"].shape))
    cut = sharding.shard_decode_state(full, mesh, kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.hd)
    local = EncDecLM(sharding.local_config(cfg, mesh), device="cpu") \
        .init_decode_state(4, 32, **kw)
    for key in ("cross_k", "cross_v", "src_lengths"):
        assert cut[key].shape == local[key].shape
    for f in ("k_store", "ks_store") if paged else ("k", "k_scale"):
        assert getattr(cut["cache"], f).shape == \
            getattr(local["cache"], f).shape
    h = cfg.n_kv_heads // tp
    assert torch.equal(cut["cross_k"], full["cross_k"][..., h:2 * h, :])


def test_mesh_helpers_equal_reference():
    for tp in (1, 2, 3, 4):
        mesh = _FakeMesh(tp)
        assert sharding.tp_degree(mesh) == jsharding.tp_degree(mesh) == tp
        assert sharding.mesh_axis_sizes(mesh) == \
            jsharding.mesh_axis_sizes(mesh)
        for hkv in (1, 2, 4, 8):
            assert sharding.kv_pools_shardable(mesh, hkv) == \
                jsharding.kv_pools_shardable(mesh, hkv)
    assert sharding.tp_degree(None) == jsharding.tp_degree(None) == 1
    assert not sharding.kv_pools_shardable(None, kv_heads=4)
    # the reference test's cases
    assert sharding.kv_pools_shardable(_FakeMesh(2), kv_heads=4)
    assert not sharding.kv_pools_shardable(_FakeMesh(4), kv_heads=2)
    assert not sharding.kv_pools_shardable(_FakeMesh(3), kv_heads=4)


def test_local_config():
    cfg = get_config("transformer-base")
    local = sharding.local_config(cfg, _FakeMesh(2))
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.hd) == \
        (4, 4, 1024, 64)
    gqa = dict(REDUCED, n_kv_heads=2)
    local = sharding.local_config(
        get_config("transformer-base").reduced(**gqa), _FakeMesh(4))
    assert (local.n_heads, local.n_kv_heads, local.hd) == (1, 2, 16)
    with pytest.raises(ValueError, match="do not split"):
        sharding.local_config(cfg, _FakeMesh(3))


def test_local_config_decoders():
    """The dense SwiGLU decoder cuts heads and d_ff; the MoE keeps its
    expert width and expert count (the experts split whole, and every
    rank routes over all of them), and refuses experts that do not divide
    the axis."""
    local = sharding.local_config(get_config("mistral-nemo-12b"),
                                  _FakeMesh(2))
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.hd) == \
        (16, 4, 7168, 128)
    moe = get_config("granite-moe-1b-a400m")
    local = sharding.local_config(moe, _FakeMesh(2))
    assert (local.n_heads, local.n_kv_heads, local.d_ff,
            local.moe.n_experts) == (8, 4, 512, 32)
    odd = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                           n_experts=24))
    with pytest.raises(NotImplementedError, match="split K7"):
        sharding.local_config(odd, _FakeMesh(16))


@pytest.mark.parametrize("tp", [2, 4])
def test_mark_parallel_splits_experts(tp):
    """The MoE tree's ``experts`` node gets ``Parallel("expert")``; its
    ``down`` (split on the expert axis, not its input features) gets no
    row mark, ``gate``/``up`` no gather; the vocab-split table its mark."""
    _, port, hkv = _trees("moe")
    mesh = _FakeMesh(tp)
    specs = param_specs(port, mesh, fsdp=None, kv_heads=hkv)
    local = shard_params(port, specs, mesh, {"data": 0, "model": tp - 1})
    group = TPGroup(rank=tp - 1, size=tp)
    marked = mark_parallel(local, specs, group, n_heads=4, n_kv_heads=hkv)
    experts = marked["blocks.0"]["moe"]["experts"]
    assert experts["tp"] == Parallel("expert", group)
    assert all("tp" not in experts[k] for k in ("gate", "up", "down"))
    assert experts["gate"]["w"].data.shape[0] == 4 // tp
    assert "tp" not in marked["blocks.0"]["moe"]["router"]
    assert marked["embed"]["tp"] == Parallel("vocab", group)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [1, 16, 64])
def test_decode_collective_bytes_equals_reference(tp, rows):
    for act, vocab in ((4, 0), (2, 37000), (4, 32)):
        kw = dict(n_layers=6, d_model=512, rows=rows, tp=tp, act_bytes=act,
                  vocab=vocab)
        assert roofline.decode_collective_bytes(**kw) == \
            jroofline.decode_collective_bytes(**kw)


def test_weight_stream_bytes_and_model_flops_equal_reference():
    for n in (1, 44_000_000, 12_000_000_000):
        for kw in (dict(quantized=False, act_bytes=2), dict(),
                   dict(weight_bits=4), dict(weight_bits=4, group_size=64,
                                             int4_fraction=0.37)):
            assert roofline.weight_stream_bytes(n, **kw) == \
                jroofline.weight_stream_bytes(n, **kw)
    with pytest.raises(ValueError, match="weight_bits"):
        roofline.weight_stream_bytes(10, weight_bits=6)
    for arch in ("transformer-base", "granite-moe-1b-a400m",
                 "mistral-nemo-12b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert roofline.model_flops(arch, shape) == \
                jroofline.model_flops(arch, shape)


@pytest.mark.parametrize("quantized,bits", [(False, 8), (True, 8),
                                            (True, 4)])
def test_sharded_decode_cell_terms(quantized, bits):
    """The same cell with the H100's constants: each term times its
    constant equals the reference's term times the TPU's."""
    kw = dict(rows=16, tp=2, quantized=quantized, kv_bytes_per_step=12345,
              weight_bits=bits)
    got = roofline.sharded_decode_cell(get_config("transformer-base"), **kw)
    want = jroofline.sharded_decode_cell(jget_config("transformer-base"),
                                         **kw)
    for k in ("rows", "tp", "quantized", "weight_bits",
              "weight_bytes_per_step", "collective_bytes_per_device"):
        assert got[k] == want[k], k
    peak = (roofline.PEAK_INT8, jroofline.PEAK_INT8) if quantized else \
        (roofline.PEAK_BF16, jroofline.PEAK_BF16)
    for term, (a, b) in (("compute_s", peak),
                         ("memory_s", (roofline.HBM_BW, jroofline.HBM_BW)),
                         ("collective_s", (roofline.LINK_BW,
                                           jroofline.ICI_BW))):
        assert got["terms_s"][term] * a == pytest.approx(
            want["terms_s"][term] * b, rel=1e-12)
    assert got["step_time_bound_s"] == max(got["terms_s"].values())
    assert got["dominant"] == max(got["terms_s"], key=got["terms_s"].get)


def test_mesh_errors_name_the_ranks():
    with pytest.raises(ValueError, match="needs 2 ranks but the process "
                       "group has 1"):
        make_host_mesh(data=1, model=2)
    with pytest.raises(ValueError, match="torch.multiprocessing"):
        make_host_mesh(data=2, model=2)
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_host_mesh_of_one_rank():
    mesh = make_host_mesh(data=1, model=1)
    assert sharding.mesh_axis_sizes(mesh) == (1, 1)
    assert sharding.tp_degree(mesh) == 1
    assert mesh.coords == {"data": 0, "model": 0}
    assert isinstance(param_specs({"embed": {"table": torch.zeros(4, 2)}},
                                  mesh)["embed"]["table"], tuple)


def test_quantized_nodes_keep_their_kind():
    _, port, hkv = _trees("tb-int4")
    specs = param_specs(port, _FakeMesh(2), fsdp=None, kv_heads=hkv)
    node = specs["dec_blocks.0"]["ffn"]["out"]["w"]
    assert isinstance(node, BlockQTensor)
    assert node.data == (None, None)              # rows replicate, N = 48
    assert isinstance(specs["dec_blocks.0"]["self_attn"]["q_proj"]["w"],
                      QTensor)


class _Ranks:
    """``n`` ranks in threads of this process: ``all_reduce`` meets at a
    barrier and sums (or takes the max) in rank order, ``all_gather`` is
    ``TPGroup``'s (a SUM into zeros).  Enough for ``layers.dense``."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def rank(self, r):
        shared = self

        class Rank:
            rank, size = r, shared.n

            def all_reduce(self, x, op="sum"):
                shared.slots[r] = x.clone()
                shared.barrier.wait()
                parts = list(shared.slots)
                shared.barrier.wait()
                out = parts[0].clone()
                for part in parts[1:]:
                    out = out + part if op == "sum" else torch.maximum(out,
                                                                       part)
                return x.copy_(out)

            def all_gather(self, x, dim):
                return TPGroup.all_gather(self, x, dim)

        return Rank()


def _run_ranks(n, fn):
    out = [None] * n
    threads = [threading.Thread(target=lambda r=r: out.__setitem__(r, fn(r)))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _contexts():
    hist = HistogramClass(kind="dense", zero_fraction=0.0, occupancy=1.0,
                          p999_over_amax=1.0)
    site = "dec_blocks.0/ffn/out"
    return {
        "dynamic": QuantContext(QuantPolicy(act_quant="dynamic")),
        "static": QuantContext(QuantPolicy(act_quant="static",
                                           default_amax=2.5)),
        "affine": QuantContext(
            QuantPolicy(act_quant="static"),
            {site: SiteCalibration(site, Thresholds(-0.75, 3.0), hist,
                                   True)}),
        "fp": FP_CONTEXT}


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_out_projection_gathers_its_input(tp):
    """An INT4 out-projection keeps its whole weight (rows never split):
    it gathers the split input and equals the unsharded linear."""
    _, port, _ = _trees("tb-int4")
    node = port["dec_blocks.0"]["ffn"]["out"]
    assert isinstance(node["w"], BlockQTensor)
    ctx = _contexts()["dynamic"]
    x = torch.randn((3, 5, 96), generator=torch.Generator().manual_seed(tp))
    site = "dec_blocks.0/ffn/out"
    want = dense(node, x, site=site, quant=ctx)
    ranks = _Ranks(tp)
    k = 96 // tp
    got = _run_ranks(tp, lambda r: dense(
        dict(node, tp=Parallel("gather", ranks.rank(r))),
        x[..., r * k:(r + 1) * k].contiguous(), site=site, quant=ctx))
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["dynamic", "static", "affine", "fp"])
def test_row_parallel_dense_equals_unsharded(mode, tp):
    """A row-parallel linear over ``tp`` ranks: the INT8 modes equal the
    unsharded ``dense`` bit for bit (the s32 accumulators sum exactly, K2
    quantizes the gathered whole row, the zero point's column sums cover
    the whole K); float within 1e-6 relative (partial sums)."""
    _, port, _ = _trees("tb-int8" if mode != "fp" else "tb-fp")
    node = port["dec_blocks.0"]["ffn"]["out"]
    ctx = _contexts()[mode]
    x = torch.randn((3, 5, 96), generator=torch.Generator().manual_seed(tp))
    site = "dec_blocks.0/ffn/out"
    want = dense(node, x, site=site, quant=ctx)
    ranks = _Ranks(tp)
    k = 96 // tp

    def rank(r):
        w = node["w"]
        rows = (QTensor(w.data[r * k:(r + 1) * k].contiguous(), w.scale,
                        w.zero_point, w.axis) if isinstance(w, QTensor)
                else w[r * k:(r + 1) * k].contiguous())
        local = dict(node, w=rows, tp=Parallel("row", ranks.rank(r)))
        return dense(local, x[..., r * k:(r + 1) * k].contiguous(),
                     site=site, quant=ctx)

    for got in _run_ranks(tp, rank):
        if mode == "fp":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_embed_and_unembed_equal_unsharded(tp):
    """The masked lookup plus a SUM is the whole table's rows exactly;
    the gathered logits equal the whole product within 1e-6."""
    _, port, _ = _trees("tb-fp")
    table = port["embed"]["table"]
    v = table.shape[0] // tp
    ids = torch.tensor([[0, 5, 31, 17], [8, 9, 30, 1]])
    x = torch.randn((2, 4, table.shape[1]),
                    generator=torch.Generator().manual_seed(tp))
    ranks = _Ranks(tp)

    def rank(r):
        local = {"table": table[r * v:(r + 1) * v].contiguous(),
                 "tp": Parallel("vocab", ranks.rank(r))}
        return embed(local, ids, torch.float32), unembed(local, x)

    for e, logits in _run_ranks(tp, rank):
        assert torch.equal(e, embed({"table": table}, ids, torch.float32))
        torch.testing.assert_close(logits, unembed({"table": table}, x),
                                   rtol=1e-6, atol=1e-6)


def test_k3_halves_plain_versions_compose_to_k3():
    """On the CPU: accumulate then epilogue is the plain K3 bit for bit,
    through ``ops`` too, f32 and bf16, with and without a zero point."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(3)
    M, K, N = 7, 96, 40
    a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8)
    a_scale = torch.rand((M, 1), generator=gen) * 0.02
    b_scale = torch.rand((1, N), generator=gen) * 0.02
    bias = torch.randn((N,), generator=gen)
    acc = ops.int8_matmul_accumulate(a, w)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.double(), a.double() @ w.double())
    colsum = w.to(torch.int32).sum(dim=0)
    for dt in (torch.float32, torch.bfloat16):
        for scale in (a_scale, a_scale[:1], float(a_scale[0, 0])):
            for zp in (None, 12.0):
                want = ref.ref_int8_matmul(a, scale, w, b_scale, zp, bias,
                                           out_dtype=dt)
                assert torch.equal(want, ops.int8_matmul_epilogue(
                    acc, scale, b_scale, 0.0 if zp is None else zp, colsum,
                    bias, out_dtype=dt))
