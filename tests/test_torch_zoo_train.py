"""The port's training step on the zoo's families against the JAX package:
the loss, every gradient leaf and one step, on the CPU.

Families, each reduced from the reference's own ``init(PRNGKey(0))`` and
carried across with ``checkpoint/bridge.py``: the dense SwiGLU decoder
(reduced ``mistral-nemo-12b``, on ``LMBatches``), the VLM backbone fed
``embeds`` (reduced ``internvl2-76b``, the labels of an ``LMBatches``
batch) and the audio stub fed ``src_embeds`` (reduced ``whisper-base``,
target tokens of the synthetic corpus).  The reference step is
``jax.jit(make_train_step(...))``.  Then the training driver,
``python -m repro_torch.launch.train --arch mistral-nemo-12b --device
cpu``.

Tolerances are ``tests/test_torch_train.py``'s (float32 unless stated):

* loss and metrics: 1e-5 relative (the gradient norm 5e-3 under
  ``mixed_precision``);
* gradients: per leaf, ``|Δ| ≤ 1e-4·max|g| + 1e-8·‖g‖``, and 2e-2 of each
  leaf's largest value under ``mixed_precision`` (bfloat16 sums);
* parameters after one step: within ``1e-2·lr`` where the reference's
  gradient element is 100 times its tolerance or more, ``2.5·lr``
  elsewhere (Adam's first step moves every element by about ``lr``, either
  way where the gradient is near its tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import make_loss_fn as jmake_loss_fn
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.data import LMBatches, make_corpus, pad_batch
from repro_torch.launch import train as train_driver
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import make_loss_fn, make_train_step
from repro_torch.train.step import _to_bf16
from repro_torch.tree import leaves_with_paths, tree_map, tree_unflatten

from _torch_zoo import one_torch_thread  # noqa: F401  (a fixture)


def _dense_batch(vocab):
    return LMBatches(vocab, 8, 16).next_batch()


def _vlm_batch(vocab):
    labels = LMBatches(vocab, 8, 16).next_batch()["labels"]
    rng = np.random.default_rng(31)
    return {"embeds": (rng.standard_normal((8, 16, 64)) * 0.5)
            .astype(np.float32), "labels": labels}


def _audio_batch(vocab):
    corpus = make_corpus(8, vocab, seed=32)
    tgt, tgt_lens = pad_batch([s.tgt for s in corpus], add_bos=True,
                              add_eos=True)
    rng = np.random.default_rng(33)
    return {"src_embeds": (rng.standard_normal((8, 12, 64)) * 0.5)
            .astype(np.float32),
            "src_lengths": np.array([12, 9, 12, 5, 7, 12, 10, 3], np.int32),
            "tgt_tokens": tgt, "tgt_lengths": tgt_lens}


FAMILIES = {
    "dense": ("mistral-nemo-12b", _dense_batch),
    "vlm": ("internvl2-76b", _vlm_batch),
    "audio": ("whisper-base", _audio_batch),
}


@pytest.fixture(scope="module")
def families():
    """{family: (ref model, ref params, port model, port params, batch)}."""
    out = {}
    for name, (arch, make_batch) in FAMILIES.items():
        jmodel = jbuild_model(jget_config(arch).reduced())
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = build_model(get_config(arch).reduced(), device="cpu")
        params = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        out[name] = (jmodel, jparams, model, params,
                     make_batch(model.cfg.vocab))
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_grads_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    norm = float(np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                             for v in want.values())))
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k], np.float32)
        tol = rel * np.abs(w).max() + 1e-8 * norm
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


def _assert_params_close(got, want, want_m, lr: float, rel: float):
    want, want_m = _flatten_with_paths(want), _flatten_with_paths(want_m)
    norm = float(np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                             for v in want_m.values())))
    for k, v in leaves_with_paths(got):
        w, m = np.asarray(want[k]), np.abs(np.asarray(want_m[k]))
        err = np.abs(v.numpy() - w)
        pad = 1e-6 * np.abs(w).max()
        sure = m > 100 * (rel * m.max() + 1e-8 * norm)
        assert err.max() <= 2.5 * lr + pad, (k, err.max() / lr)
        assert not sure.any() or err[sure].max() <= 1e-2 * lr + pad, \
            (k, err[sure].max() / lr)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_gradient_leaf_match_reference(families, family,
                                                      mixed):
    """``make_loss_fn`` + ``torch.autograd.grad`` against ``jax.grad`` of
    the reference's ``make_loss_fn``: the loss, its parts and every
    gradient leaf (the SwiGLU gate/up/down among them)."""
    jmodel, jparams, model, params, batch = families[family]
    jloss_fn = jmake_loss_fn(jmodel)

    def jcast(p):
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16)
            if a.dtype == jnp.float32 and a.ndim >= 2 else a, p)

    jf = (lambda p, b: jloss_fn(jcast(p), b)) if mixed else jloss_fn
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jparams, _jbatch(batch))

    leaves = [x.detach().requires_grad_(True)
              for _, x in leaves_with_paths(params)]
    tp = tree_unflatten(params, leaves)
    if mixed:
        tp = tree_map(_to_bf16, tp)
    loss, aux = make_loss_fn(model)(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce_loss"].detach()),
                               float(jaux["ce_loss"]), rtol=1e-5)
    got = {k: g.numpy() for (k, _), g in zip(leaves_with_paths(params),
                                             grads)}
    if family == "dense":
        assert {f"blocks.0/ffn/{leaf}/w" for leaf in ("gate", "up", "down")} \
            <= set(got)
    _assert_grads_close(got, _flatten_with_paths(jg),
                        2e-2 if mixed else 1e-4)


VARIANTS = {"plain": {}, "accum2": dict(accum_steps=2),
            "mixed": dict(mixed_precision=True)}
CASES = [("dense", v) for v in sorted(VARIANTS)] + [("vlm", "plain"),
                                                     ("audio", "plain")]


@pytest.mark.parametrize("family,variant", CASES)
def test_train_step_matches_reference(families, family, variant):
    """One step of the port's ``make_train_step`` against
    ``jax.jit(make_train_step)`` of the reference: the metrics, the new
    parameters and the optimizer's first moment."""
    jmodel, jparams, model, params, batch = families[family]
    jopt = JAdamW(lr=jwarmup_cosine(2e-3, 2, 20))
    opt = AdamW(lr=warmup_cosine(2e-3, 2, 20))
    kw = VARIANTS[variant]
    (jp, js), jm = jax.jit(jmake_train_step(jmodel, jopt, **kw))(
        jparams, jopt.init(jparams), _jbatch(batch))
    (tp, ts), tm = make_train_step(model, opt, **kw)(
        params, opt.init(params), batch)
    mixed = variant == "mixed"
    for k in jm:
        rtol = 5e-3 if mixed and k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    rel = 2e-2 if mixed else 1e-4
    _assert_params_close(tp, jp, js.m, float(jm["lr"]), rel)
    _assert_grads_close({k: v.numpy() for k, v in leaves_with_paths(ts.m)},
                        _flatten_with_paths(js.m), rel)


def test_training_driver_runs_a_decoder_only_arch(capsys):
    """``launch.train --arch mistral-nemo-12b --device cpu`` trains the
    reduced SwiGLU model: the loss falls over 12 steps."""
    train_driver.main(["--arch", "mistral-nemo-12b", "--device", "cpu",
                       "--steps", "12", "--batch-size", "4", "--seq-len",
                       "16"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("final loss:"))
    final, first = (float(t.strip("():,")) for t in line.split()
                    if t.strip("():,").replace(".", "").isdigit())
    assert np.isfinite(final) and final < first, line
