"""What the zoo's CPU tests share: the reduced models (the attention archs
and the recurrent ones) built once a process from the reference's
``init(PRNGKey(0))`` (carried across with ``checkpoint/bridge.py``), both
packages' FP, INT8-dynamic and calibrated INT8-static trees, the
tolerances and the comparison helpers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.core import Calibrator as JCalibrator
from repro.core import FP_CONTEXT as JFP_CONTEXT
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import Taps as JTaps
from repro.core import quantize_model as jquantize_model
from repro.models import build_model as jbuild_model

from repro_torch.checkpoint.bridge import (
    calibrations_from_reference,
    params_from_flat,
)
from repro_torch.configs import get_config
from repro_torch.core import (
    FP_CONTEXT,
    BlockQTensor,
    QuantPolicy,
    QTensor,
    quantize_model,
)
from repro_torch.data import make_corpus, pad_batch
from repro_torch.models import DecoderLM, EncDecLM, build_model

# the reduced decoder-only models of the zoo: (arch, reduced() overrides)
DECODERS = {
    "granite-8b": ("granite-8b", {}),
    # yi-9b keeps its 8 query heads per KV head as 4 over 1 (at the plain
    # reduction its model would be granite-8b's)
    "yi-9b": ("yi-9b", dict(n_kv_heads=1)),
    "mistral-nemo-12b": ("mistral-nemo-12b", {}),
    "mistral-hd32": ("mistral-nemo-12b", dict(head_dim=32)),
    "command-r-35b": ("command-r-35b", {}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
}
KINDS = ("fp", "int8_dynamic", "int8_static")
MAX_LEN = 48
MAX_NEW = 10
# model logits: 2e-5 in FP; with INT8 activations a last-bit difference can
# flip one code, so at most 2% of the logits may be past 2e-2, and none past
# 0.25 (tests/test_torch_moe.py argues these)
ATOL = {"fp": 2e-5, "int8_dynamic": 2e-2, "int8_static": 2e-2}
FLIP_SHARE, FLIP_MAX = 0.02, 0.25


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the reference's XLA threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def prompts(seed, n, vocab=128):
    corpus = make_corpus(n, vocab, seed=seed)
    return pad_batch([s.src for s in corpus])


def sides_of(jmodel, jparams, fp, batch_fn):
    """{kind: ((ref params, ref ctx), (port params, port ctx))}: FP, INT8
    dynamic, and INT8 static after the reference's KL calibration on a
    forward with taps over ``batch_fn()``."""
    taps = JTaps()
    jmodel.forward(jparams, batch_fn(), taps=taps)
    jcal = JCalibrator()
    jcal.observe_taps(taps)
    jcalibs = jcal.compute("symmetric")
    sides = {"fp": ((jparams, JFP_CONTEXT), (fp, FP_CONTEXT))}
    for act, calibs in (("dynamic", {}), ("static", jcalibs)):
        sides[f"int8_{act}"] = (
            jquantize_model(jparams, calibs, JQuantPolicy(act_quant=act)),
            quantize_model(fp, calibrations_from_reference(calibs),
                           QuantPolicy(act_quant=act), device="cpu"))
    return sides, jcalibs


_CACHE = {}


def decoder(name):
    """Reference model and weights, the port's copy and both packages'
    quantized trees, built once a module."""
    if name not in _CACHE:
        arch, kw = DECODERS[name]
        jcfg = jget_config(arch).reduced(**kw)
        cfg = get_config(arch).reduced(**kw)
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        toks, lens = prompts(seed=5, n=8)
        sides, jcalibs = sides_of(
            jmodel, jparams, fp,
            lambda: {"tokens": jnp.asarray(toks),
                     "lengths": jnp.asarray(lens)})
        _CACHE[name] = dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel,
                            jparams=jparams, fp=fp, sides=sides,
                            jcalibs=jcalibs,
                            model=DecoderLM(cfg, device="cpu"))
    return _CACHE[name]


# the reduced recurrent models: zamba2-2.7b (hybrid: Mamba2 layers and a
# shared attention block every 2nd layer) and xlstm-1.3b (ssm: an mLSTM and
# an sLSTM layer)
RECURRENT = ("zamba2-2.7b", "xlstm-1.3b")


def recurrent(arch):
    """As :func:`decoder`, for a reduced recurrent arch (``HybridLM`` or
    ``XLSTMLM`` through ``build_model``)."""
    key = ("recurrent", arch)
    if key not in _CACHE:
        jcfg = jget_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        toks, lens = prompts(seed=5, n=8)
        sides, jcalibs = sides_of(
            jmodel, jparams, fp,
            lambda: {"tokens": jnp.asarray(toks),
                     "lengths": jnp.asarray(lens)})
        _CACHE[key] = dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel,
                           jparams=jparams, fp=fp, sides=sides,
                           jcalibs=jcalibs,
                           model=build_model(cfg, device="cpu"))
    return _CACHE[key]


def assert_logits_close(got, want, kind, msg=""):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    if kind == "fp":
        assert d.max() <= ATOL[kind], (msg, d.max())
    else:
        assert (d > ATOL[kind]).mean() <= FLIP_SHARE and \
            d.max() <= FLIP_MAX, (msg, (d > ATOL[kind]).mean(), d.max())


def first_divergence(want, got):
    for r, (a, b) in enumerate(zip(want, got)):
        if a != b:
            n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return f"row {r} diverges at step {n}: ref {a} port {b}"
    return "equal"


def flat_leaves(tree, prefix=()):
    """Port params → {path: tensor} (a QTensor as its three leaves)."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(flat_leaves(v, path))
        elif isinstance(v, QTensor):
            for i, leaf in enumerate((v.data, v.scale, v.zero_point)):
                out["/".join(path + (str(i),))] = leaf
        elif isinstance(v, BlockQTensor):
            for i, leaf in enumerate((v.data, v.scale, v.vmin)):
                out["/".join(path + (str(i),))] = leaf
        else:
            out["/".join(path)] = v
    return out


def vlm_model():
    """Reduced internvl2-76b: the reference model, the port's, both
    packages' trees for each kind, and an embeds batch (4 × 13)."""
    if "vlm" in _CACHE:
        return _CACHE["vlm"]
    jcfg = jget_config("internvl2-76b").reduced()
    cfg = get_config("internvl2-76b").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    rng = np.random.default_rng(12)
    embeds = (rng.standard_normal((4, 13, 64)) * 0.5).astype(np.float32)
    lens = np.array([13, 9, 5, 11], np.int32)
    sides, _ = sides_of(jmodel, jparams, fp,
                      lambda: {"embeds": jnp.asarray(embeds),
                               "lengths": jnp.asarray(lens)})
    _CACHE["vlm"] = dict(jmodel=jmodel, model=DecoderLM(cfg, device="cpu"),
                         sides=sides, embeds=embeds, lens=lens, cfg=cfg)
    return _CACHE["vlm"]


WHISPER_FFN = {"gelu": {}, "swiglu": dict(ffn="swiglu")}


def whisper(ffn_kind="gelu"):
    """Reduced whisper-base (or its SwiGLU variant): the reference model
    and weights, the port's, both packages' trees for each kind, and a
    src_embeds batch of 3 × 20 frames with target tokens."""
    key = ("whisper", ffn_kind)
    if key not in _CACHE:
        kw = WHISPER_FFN[ffn_kind]
        jcfg = jget_config("whisper-base").reduced(**kw)
        cfg = get_config("whisper-base").reduced(**kw)
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        fp = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        rng = np.random.default_rng(21)
        frames = (rng.standard_normal((3, 20, 64)) * 0.5).astype(np.float32)
        lens = np.array([20, 14, 7], np.int32)
        tgt, _ = prompts(seed=22, n=3)
        sides, _ = sides_of(jmodel, jparams, fp,
                          lambda: {"src_embeds": jnp.asarray(frames),
                                   "src_lengths": jnp.asarray(lens),
                                   "tgt_tokens": jnp.asarray(tgt)})
        _CACHE[key] = dict(jmodel=jmodel, jparams=jparams, fp=fp,
                           model=EncDecLM(cfg, device="cpu"), sides=sides,
                           frames=frames, lens=lens, tgt=tgt, cfg=cfg)
    return _CACHE[key]
