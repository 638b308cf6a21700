"""The port's attention model zoo against the JAX package, on the CPU.

Configs: every registered arch, full and reduced, field by field, with the
derived counts (``n_params``, ``n_active_params``), ``shapes_for`` and
``list_archs``; the registry's families.  Models: the SwiGLU FFN, and the
reduced dense archs (``granite-8b``, ``yi-9b``, ``mistral-nemo-12b``, also
with a head dim of 32 so that ``H·hd ≠ d_model``, ``command-r-35b``) and
``qwen3-moe-30b-a3b`` through ``forward``, ``prefill`` and ``decode_step``;
PTQ, calibration and the bridge at the SwiGLU sites; the VLM backbone's
``embeds`` input (reduced ``internvl2-76b``) and the audio stub's
``src_embeds`` input (reduced ``whisper-base``, also through the staged
encode of chunked prefill).  The serving engine's runs are
``tests/test_torch_zoo_generate.py``, training
``tests/test_torch_zoo_train.py``; the shared models are built in
``tests/_torch_zoo.py`` from the reference's ``init(PRNGKey(0))``, carried
across with ``checkpoint/bridge.py``; inputs are numpy arrays made from a
seed.

Tolerances, as ``tests/test_torch_moe.py`` argues them (float32):

* integer results (int8 weight and activation codes where the inputs are
  the same bits, token ids, steps, host syncs): exact;
* the SwiGLU FFN: 1e-6 in FP; the ``down`` site's input differs from the
  reference's in the last bits (``silu``, the matmul order), so its
  activation codes may move by one step at a rounding boundary, which
  moves the output by one code step of the ``down`` matmul (5e-4);
* model logits: 2e-5 in FP; with INT8 activations a last-bit difference
  can flip one code, so at most 2% of the logits may be past 2e-2, and
  none past 0.25.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import shapes_for as jshapes_for
from repro.configs.base import SUBQUADRATIC_FAMILIES as JSUBQ
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import Taps as JTaps
from repro.core import count_quantized as jcount_quantized
from repro.core import quantize_model as jquantize_model
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models import ffn as jffn

from repro_torch.checkpoint.bridge import (
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.configs.base import SUBQUADRATIC_FAMILIES
from repro_torch.core import (
    Calibrator,
    QuantPolicy,
    QTensor,
    Taps,
    count_quantized,
    quantize_model,
)
from repro_torch.kernels import ops
from repro_torch.models import (
    XLSTMLM,
    DecoderLM,
    EncDecLM,
    HybridLM,
    build_model,
)
from repro_torch.models import ffn

from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    DECODERS,
    FLIP_MAX,
    FLIP_SHARE,
    KINDS,
    MAX_LEN,
    assert_logits_close,
    decoder,
    flat_leaves,
    one_torch_thread,
    prompts,
    vlm_model,
    whisper,
)

ALL_ARCHS = ("command-r-35b", "granite-8b", "granite-moe-1b-a400m",
             "internvl2-76b", "mistral-nemo-12b", "qwen3-moe-30b-a3b",
             "transformer-base", "whisper-base", "xlstm-1.3b", "yi-9b",
             "zamba2-2.7b")
def _assert_same_config(port, ref):
    for field in dataclasses.fields(port):
        p, r = getattr(port, field.name), getattr(ref, field.name)
        if dataclasses.is_dataclass(p):
            assert dataclasses.asdict(p) == dataclasses.asdict(r), field.name
        else:
            assert p == r, field.name
    # the port has every field of the reference's but the scan switch
    missing = ({f.name for f in dataclasses.fields(ref)}
               - {f.name for f in dataclasses.fields(port)})
    assert missing == {"scan_layers"}


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

def test_list_archs_and_shapes_equal_reference():
    assert list_archs() == jlist_archs() == sorted(ALL_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert SUBQUADRATIC_FAMILIES == JSUBQ


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_counts_and_shapes_match_reference(arch):
    """The published config and ``reduced()`` (plain and with overrides),
    field by field (sub-configs and ``quant`` by ``asdict``), ``hd``,
    ``n_params``, ``n_active_params`` and ``shapes_for``."""
    ref, port = jget_config(arch), get_config(arch)
    pairs = [(port, ref), (port.reduced(), ref.reduced()),
             (port.reduced(n_layers=3, d_ff=96),
              ref.reduced(n_layers=3, d_ff=96))]
    for p, r in pairs:
        _assert_same_config(p, r)
        assert (p.hd, p.n_params, p.n_active_params) == \
            (r.hd, r.n_params, r.n_active_params)
        got = [(dataclasses.asdict(s), skip) for s, skip in shapes_for(p)]
        want = [(dataclasses.asdict(s), skip) for s, skip in jshapes_for(r)]
        assert got == want
    assert port.reduced().dtype == "float32"


def test_published_widths():
    """What the chip phase runs: mistral-nemo-12b's 32 heads of 128 over 8
    make an attention 4096 wide on a 5120-wide model; the counts are the
    reference formula's (an untied embedding counted twice)."""
    m = get_config("mistral-nemo-12b")
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv_heads, m.hd, m.d_ff,
            m.vocab, m.rope_theta) == (40, 5120, 32, 8, 128, 14336, 131072,
                                       1e6)
    assert m.n_heads * m.hd != m.d_model
    assert m.n_params == 12247367680 == m.n_active_params
    q = get_config("qwen3-moe-30b-a3b")
    assert q.n_active_params < q.n_params
    assert get_config("command-r-35b").rope_theta == 8e6


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_build_model_routes_every_family(arch):
    """dense, moe and vlm build ``DecoderLM``, audio ``EncDecLM``, hybrid
    ``HybridLM`` and ssm ``XLSTMLM``; each model's ``init`` has the
    reference's leaves, shape for shape."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    want_cls = {"hybrid": HybridLM, "ssm": XLSTMLM}.get(
        cfg.family, EncDecLM if cfg.enc_dec else DecoderLM)
    assert type(model) is want_cls
    params = model.init(torch.Generator().manual_seed(0))
    want = _flatten_with_paths(jbuild_model(jget_config(arch).reduced())
                               .init(jax.random.PRNGKey(0)))
    got = {k: tuple(v.shape) for k, v in flat_leaves(params).items()}
    assert got == {k: tuple(np.shape(v)) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the SwiGLU FFN
# ---------------------------------------------------------------------------

def _spy_matmul(monkeypatch, mod, captured):
    """Capture each ``int8_matmul``'s activation codes and output."""
    real = mod.int8_matmul

    def spy(a, b, *args, **kw):
        out = real(a, b, *args, **kw)
        captured.append((a.data, out))
        return out

    monkeypatch.setattr(mod, "int8_matmul", spy)


@pytest.mark.parametrize("kind", KINDS)
def test_swiglu_ffn_matches_jitted_reference(kind, monkeypatch):
    """Block 0's SwiGLU FFN of reduced mistral-nemo-12b on the same input:
    the gate and up sites' activation codes and outputs are the
    reference's bit for bit, the down site's codes within one step (and
    equal on the reference's own down input), the output within the
    tolerances above."""
    s = decoder("mistral-nemo-12b")
    (jp, jctx), (pp, pctx) = s["sides"][kind]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    captured_r, captured_p = [], []
    _spy_matmul(monkeypatch, jops, captured_r)

    def run(params, xx):
        taps = JTaps()
        y = jffn.ffn(params, xx, cfg=s["jcfg"], site="blocks.0/ffn",
                     quant=jctx, taps=taps)
        return y, dict(taps.values), list(captured_r)

    y_r, taps_r, k3_r = jax.tree_util.tree_map(
        np.asarray, jax.jit(run)(jp["blocks.0"]["ffn"], jnp.asarray(x)))
    monkeypatch.undo()
    _spy_matmul(monkeypatch, ops, captured_p)
    taps_p = Taps()
    y_p = ffn.ffn(pp["blocks.0"]["ffn"], torch.from_numpy(x), cfg=s["cfg"],
                  site="blocks.0/ffn", quant=pctx, taps=taps_p)
    monkeypatch.undo()

    assert set(taps_p.values) == set(taps_r) == {
        "blocks.0/ffn/gate", "blocks.0/ffn/up", "blocks.0/ffn/down"}
    for site in ("blocks.0/ffn/gate", "blocks.0/ffn/up"):
        np.testing.assert_array_equal(taps_p.values[site], taps_r[site])
    np.testing.assert_allclose(taps_p.values["blocks.0/ffn/down"],
                               taps_r["blocks.0/ffn/down"], rtol=0,
                               atol=1e-6)
    if kind == "fp":
        assert not captured_p and not k3_r
        np.testing.assert_allclose(y_p.numpy(), y_r, rtol=0, atol=1e-6)
        return
    assert len(captured_p) == len(k3_r) == 3
    for i, ((qp, op), (qr, orr)) in enumerate(zip(captured_p, k3_r)):
        if i < 2:                      # gate, up: the same input bits
            np.testing.assert_array_equal(qp.numpy(), qr)
            np.testing.assert_array_equal(op.numpy(), orr)
        else:
            d = np.abs(qp.numpy().astype(int) - qr.astype(int))
            assert d.max() <= 1 and d.mean() < 0.01, (d.max(), d.mean())
    np.testing.assert_allclose(y_p.numpy(), y_r, rtol=0, atol=5e-4)
    # the down site alone on the reference's own input: the same codes
    from repro_torch.models.layers import dense
    captured_p.clear()
    _spy_matmul(monkeypatch, ops, captured_p)
    dense(pp["blocks.0"]["ffn"]["down"],
          torch.from_numpy(taps_r["blocks.0/ffn/down"].copy()),
          site="blocks.0/ffn/down", quant=pctx)
    monkeypatch.undo()
    np.testing.assert_array_equal(captured_p[0][0].numpy(), k3_r[2][0])


# ---------------------------------------------------------------------------
# the reduced decoder-only archs: forward, prefill, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_forward_prefill_decode_match(name, kind):
    """``forward`` logits on 4 right-padded prompts, then ``prefill`` and 6
    decode steps fed the reference's argmax, against ``jax.jit`` of the
    reference's; the cursors equal, the INT8 cache codes of layer 0 within
    one step, and under 1% of all codes different."""
    s = decoder(name)
    (jp, jctx), (pp, pctx) = s["sides"][kind]
    jm, model = s["jmodel"], s["model"]
    toks, lens = prompts(seed=8, n=4)
    want, _ = jax.jit(lambda t, l: jm.forward(
        jp, {"tokens": t, "lengths": l}, quant=jctx))(jnp.asarray(toks),
                                                      jnp.asarray(lens))
    got, _ = model.forward(pp, {"tokens": torch.from_numpy(toks),
                                "lengths": torch.from_numpy(lens)},
                           quant=pctx)
    assert_logits_close(got.numpy(), want, kind, "forward")

    quantized = kind != "fp"
    js = jm.init_decode_state(4, MAX_LEN, quantized=quantized)
    ps = model.init_decode_state(4, MAX_LEN, quantized=quantized)
    jl, js = jax.jit(lambda b, st: jm.prefill(jp, b, st, quant=jctx))(
        {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)}, js)
    pl, ps = model.prefill(pp, {"tokens": torch.from_numpy(toks),
                                "lengths": torch.from_numpy(lens)}, ps,
                           quant=pctx)
    S = toks.shape[1]
    if quantized:
        # layer 0's K/V codes within one step; a deeper layer's input can
        # carry an upstream code flip, which may move a code further
        for name in ("k", "v"):
            d = np.abs(getattr(ps["cache"], name).numpy()[:, :, :S]
                       .astype(np.int32)
                       - np.asarray(getattr(js["cache"], name))[:, :, :S]
                       .astype(np.int32))
            assert d[0].max() <= 1 and (d > 0).mean() < 0.01, \
                (name, d[0].max(), (d > 0).mean())
    jdecode = jax.jit(lambda t, st: jm.decode_step(jp, t, st, quant=jctx))
    for step in range(7):
        assert_logits_close(pl.numpy(), jl, kind, f"step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        if step == 6:
            break
        jl, js = jdecode(jnp.asarray(tok), js)
        pl, ps = model.decode_step(pp, torch.from_numpy(tok), ps, quant=pctx)
    np.testing.assert_array_equal(ps["cache"].lengths.numpy(),
                                  np.asarray(js["cache"].lengths))


# ---------------------------------------------------------------------------
# PTQ, calibration and the bridge at the SwiGLU sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_bits", [8, 4])
@pytest.mark.parametrize("act_quant", ["dynamic", "static"])
def test_quantize_model_swiglu_codes_and_scales(act_quant, weight_bits):
    """Every weight's codes and scales equal the reference's, the counts
    too; the decoder-only sites are not INT4-eligible (``blocks.*``, not
    ``dec_blocks.*``), so ``weight_bits=4`` keeps them INT8, as in the
    reference."""
    s = decoder("mistral-nemo-12b")
    calibs = s["jcalibs"] if act_quant == "static" else {}
    jq, _ = jquantize_model(s["jparams"], calibs,
                            JQuantPolicy(act_quant=act_quant),
                            weight_bits=weight_bits)
    pq, _ = quantize_model(s["fp"], calibrations_from_reference(calibs),
                           QuantPolicy(act_quant=act_quant), device="cpu",
                           weight_bits=weight_bits)
    want = {k: np.asarray(v) for k, v in _flatten_with_paths(jq).items()}
    got = {k: v.numpy() for k, v in flat_leaves(pq).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for leaf in ("gate", "up", "down"):
        assert isinstance(pq["blocks.1"]["ffn"][leaf]["w"], QTensor)
    assert count_quantized(pq) == jcount_quantized(jq)
    assert count_quantized(pq)["quantized_linears"] == 2 * (4 + 3)
    assert count_quantized(pq)["int4_linears"] == 0


def test_calibration_thresholds_at_swiglu_sites():
    """A forward with taps over the calibration prompts, then the KL
    search: every site of the reference's, with thresholds within the
    histogram's resolution (the gate and up inputs of block 0 are the same
    bits, so their thresholds are equal)."""
    s = decoder("mistral-nemo-12b")
    toks, lens = prompts(seed=5, n=8)
    taps = Taps()
    s["model"].forward(s["fp"], {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens)},
                       taps=taps)
    cal = Calibrator()
    cal.observe_taps(taps)
    got, want = cal.compute("symmetric"), s["jcalibs"]
    assert set(got) == set(want)
    assert {f"blocks.1/ffn/{leaf}" for leaf in ("gate", "up", "down")} \
        <= set(got)
    for site in want:
        assert got[site].thresholds.t_max == pytest.approx(
            want[site].thresholds.t_max, rel=2e-3), site
        assert got[site].quantize == want[site].quantize, site


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "internvl2-76b"])
def test_bridge_scan_stacked_dense_tree(arch):
    """A scan-stacked reference tree (``blocks`` with a leading layer
    axis), FP and INT8: the port's per-layer nodes equal the stacked
    leaves sliced by layer."""
    jcfg = jget_config(arch).reduced(n_layers=3, scan_layers=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(4))
    jq, _ = jquantize_model(jparams, {}, JQuantPolicy(act_quant="dynamic"))
    for tree in (jparams, jq):
        flat = _flatten_with_paths(tree)
        got = {k: v.numpy() for k, v in flat_leaves(params_from_flat(
            flat, device="cpu")).items()}
        n = 0
        for key, arr in flat.items():
            root, rest = key.split("/", 1)
            if root != "blocks":
                np.testing.assert_array_equal(got[key], arr)
                continue
            for i in range(3):
                np.testing.assert_array_equal(got[f"blocks.{i}/{rest}"],
                                              np.asarray(arr)[i])
                n += 1
        assert n and "blocks.2/ffn/down/w" + ("/0" if tree is jq else "") \
            in got


# ---------------------------------------------------------------------------
# the VLM backbone's embeds input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_vlm_embeds_forward_prefill_decode_match(kind):
    """``forward`` and ``prefill`` from ``embeds`` (B, S, D), then decode
    steps fed (B, 1, D) embeds, against ``jax.jit`` of the reference."""
    vlm = vlm_model()
    (jp, jctx), (pp, pctx) = vlm["sides"][kind]
    jm, model = vlm["jmodel"], vlm["model"]
    e, lens = vlm["embeds"], vlm["lens"]
    want, _ = jax.jit(lambda x, l: jm.forward(
        jp, {"embeds": x, "lengths": l}, quant=jctx))(jnp.asarray(e),
                                                      jnp.asarray(lens))
    got, _ = model.forward(pp, {"embeds": torch.from_numpy(e),
                                "lengths": torch.from_numpy(lens)},
                           quant=pctx)
    assert_logits_close(got.numpy(), want, kind, "forward")
    quantized = kind != "fp"
    js = jm.init_decode_state(4, 24, quantized=quantized)
    ps = model.init_decode_state(4, 24, quantized=quantized)
    jl, js = jax.jit(lambda b, st: jm.prefill(jp, b, st, quant=jctx))(
        {"embeds": jnp.asarray(e), "lengths": jnp.asarray(lens)}, js)
    pl, ps = model.prefill(pp, {"embeds": torch.from_numpy(e),
                                "lengths": torch.from_numpy(lens)}, ps,
                           quant=pctx)
    jdecode = jax.jit(lambda x, st: jm.decode_step(jp, x, st, quant=jctx))
    rng = np.random.default_rng(13)
    for step in range(4):
        assert_logits_close(pl.numpy(), jl, kind, f"step {step}")
        x = (rng.standard_normal((4, 1, 64)) * 0.5).astype(np.float32)
        jl, js = jdecode(jnp.asarray(x), js)
        pl, ps = model.decode_step(pp, torch.from_numpy(x), ps, quant=pctx)
    np.testing.assert_array_equal(ps["cache"].lengths.numpy(),
                                  np.asarray(js["cache"].lengths))


@pytest.mark.parametrize("kind", KINDS)
def test_embeds_of_the_tokens_equal_the_token_path(kind):
    """``embeds`` equal to the prompt's embedding rows give the token
    path's prefill logits and cache bit for bit, and a decode step fed a
    token's embedding row the token step's logits."""
    vlm = vlm_model()
    _, (pp, pctx) = vlm["sides"][kind]
    model, cfg = vlm["model"], vlm["cfg"]
    toks, lens = prompts(seed=6, n=4)
    t = torch.from_numpy(toks)
    rows = pp["embed"]["table"][t.long()]
    quantized = kind != "fp"
    outs = []
    for batch in ({"tokens": t}, {"embeds": rows}):
        batch["lengths"] = torch.from_numpy(lens)
        st = model.init_decode_state(4, MAX_LEN, quantized=quantized)
        logits, st = model.prefill(pp, batch, st, quant=pctx)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        step_in = nxt if "tokens" in batch else \
            pp["embed"]["table"][nxt.long()][:, None, :]
        step_logits, st = model.decode_step(pp, step_in, st, quant=pctx)
        outs.append((logits, st["cache"], step_logits))
    (l0, c0, s0), (l1, c1, s1) = outs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert torch.equal(c0.k, c1.k) and torch.equal(c0.v, c1.v)
    assert cfg.input_kind == "embeddings"


# ---------------------------------------------------------------------------
# the audio stub's src_embeds input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_src_embeds_encode_forward_prefill_match(kind):
    """``encode``, the teacher-forced ``forward`` and ``prefill`` plus 4
    decode steps from ``src_embeds`` (taken as given, no √d scaling),
    against ``jax.jit`` of the reference."""
    w = whisper()
    (jp, jctx), (pp, pctx) = w["sides"][kind]
    jm, model = w["jmodel"], w["model"]
    f, lens = w["frames"], w["lens"]
    jb = {"src_embeds": jnp.asarray(f), "src_lengths": jnp.asarray(lens)}
    pb = {"src_embeds": torch.from_numpy(f),
          "src_lengths": torch.from_numpy(lens)}
    tol = 2e-5 if kind == "fp" else 2e-2
    want = jax.jit(lambda b: jm.encode(jp, b, quant=jctx))(jb)
    got = model.encode(pp, pb, quant=pctx)
    d = np.abs(got.numpy() - np.asarray(want))
    assert (d > tol).mean() <= FLIP_SHARE and d.max() <= FLIP_MAX, d.max()
    if kind == "fp":
        assert d.max() <= tol
    want, _ = jax.jit(lambda b, t: jm.forward(
        jp, {**b, "tgt_tokens": t}, quant=jctx))(jb, jnp.asarray(w["tgt"]))
    got, _ = model.forward(pp, {**pb, "tgt_tokens": torch.from_numpy(
        w["tgt"])}, quant=pctx)
    assert_logits_close(got.numpy(), want, kind, "forward")
    quantized = kind != "fp"
    js = jm.init_decode_state(3, 16, quantized=quantized)
    ps = model.init_decode_state(3, 16, quantized=quantized)
    jl, js = jax.jit(lambda b, st: jm.prefill(jp, b, st, quant=jctx))(jb, js)
    pl, ps = model.prefill(pp, pb, ps, quant=pctx)
    jdecode = jax.jit(lambda t, st: jm.decode_step(jp, t, st, quant=jctx))
    for step in range(5):
        assert_logits_close(pl.numpy(), jl, kind, f"step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, js = jdecode(jnp.asarray(tok), js)
        pl, ps = model.decode_step(pp, torch.from_numpy(tok), ps, quant=pctx)


@pytest.mark.parametrize("kind", ["fp", "int8_static"])
def test_src_embeds_staged_encode(kind):
    """The staged encode of chunked prefill from ``src_embeds``: each stage
    against ``jax.jit`` of the reference's, fed the reference's previous
    stage, and the port's chain equal to its own ``encode_cross_kv`` with
    0 differing elements."""
    w = whisper()
    (jp, jctx), (pp, pctx) = w["sides"][kind]
    jm, model = w["jmodel"], w["model"]
    f, lens = w["frames"], w["lens"]
    tl = torch.from_numpy(lens)
    want = jax.jit(lambda x: jm.encode_staged_begin(
        jp, {"src_embeds": x}))(jnp.asarray(f))
    got = model.encode_staged_begin(pp, {"src_embeds": torch.from_numpy(f)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    tol = 2e-5 if kind == "fp" else 2e-2
    for i in range(model.cfg.n_enc_layers):
        x = np.asarray(want)
        want = jax.jit(lambda x, l, i=i: jm.encode_staged_layer(
            jp, x, i, src_lengths=l, quant=jctx))(jnp.asarray(x),
                                                  jnp.asarray(lens))
        got = model.encode_staged_layer(pp, torch.from_numpy(x.copy()), i,
                                        src_lengths=tl, quant=pctx)
        d = np.abs(got.numpy() - np.asarray(want))
        assert (d > tol).mean() <= FLIP_SHARE and d.max() <= FLIP_MAX, \
            (i, d.max())
    x = np.asarray(want)
    want = jax.jit(lambda x, l: jm.encode_staged_finish(
        jp, x, src_lengths=l, quant=jctx))(jnp.asarray(x), jnp.asarray(lens))
    got = model.encode_staged_finish(pp, torch.from_numpy(x.copy()),
                                     src_lengths=tl, quant=pctx)
    for g, wv in zip(got, want):
        d = np.abs(g.numpy().astype(np.float32)
                   - np.asarray(wv).astype(np.float32))
        assert (d > tol).mean() <= FLIP_SHARE and d.max() <= FLIP_MAX

    batch = {"src_embeds": torch.from_numpy(f), "src_lengths": tl}
    x = model.encode_staged_begin(pp, batch)
    for i in range(model.cfg.n_enc_layers):
        x = model.encode_staged_layer(pp, x, i, src_lengths=tl, quant=pctx)
    staged = model.encode_staged_finish(pp, x, src_lengths=tl, quant=pctx)
    whole = model.encode_cross_kv(pp, batch, quant=pctx)
    for a, b in zip(staged, whole):
        assert a.shape == b.shape and int((a != b).sum()) == 0
