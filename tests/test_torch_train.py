"""The port's training step against the JAX package: the loss, every
gradient leaf and one step, for each family and variant.

Each family runs at a reduced size from the reference's own
``model.init(PRNGKey(0))``, carried across with
``checkpoint/bridge.py:params_from_flat``: the enc-dec translation model
(``trained_nmt``'s configuration) on ``TranslationBatches``, and the
decoder-only model, MoE (reduced ``granite-moe-1b-a400m``) and dense (the
same with a GELU FFN), on ``LMBatches``.  The reference step is
``jax.jit(make_train_step(...))``.

Tolerances (float32 unless stated):

* loss and metrics: 1e-5 relative;
* gradients: per leaf, ``|Δ| ≤ 1e-4·max|g| + 1e-8·‖g‖``.  The floor covers
  the key-projection biases, whose exact gradient is zero (a softmax does
  not see a shift of every key's score), so both packages return rounding
  noise of about 1e-10 there.  Under ``mixed_precision`` the gradients of
  the bfloat16 copies are bfloat16 sums, held to 2e-2 of each leaf's
  largest value (0.0084 measured, the tied embedding table);
* parameters after one step: Adam's first step moves every element by
  about ``lr·g/|g|``, so an element whose gradient is near the gradient
  tolerance may move either way: within ``1e-2·lr`` where the gradient
  element is 100 times its tolerance or more, and ``2.5·lr`` elsewhere
  (``_assert_params_close``); the first moment, ``0.1 ×`` the clipped
  gradient, is held to the gradient tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.data import LMBatches as JLMBatches
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import make_loss_fn as jmake_loss_fn
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.data import LMBatches, TranslationBatches, make_corpus
from repro_torch.distributed.sharding import TreeSharding
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import make_loss_fn, make_train_step
from repro_torch.train.step import _to_bf16
from repro_torch.tree import leaves_with_paths, tree_map, tree_unflatten

# the trained_nmt fixture's configuration and recipe (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)
FAMILIES = {
    "encdec": ("transformer-base", NMT),
    "moe": ("granite-moe-1b-a400m", {}),
    "dense": ("granite-moe-1b-a400m", dict(moe=None, ffn="gelu")),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the reference's XLA threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def families():
    """{family: (ref model, ref params, port model, port params, batch)}."""
    out = {}
    for name, (arch, kw) in FAMILIES.items():
        jmodel = jbuild_model(jget_config(arch).reduced(**kw))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = build_model(get_config(arch).reduced(**kw), device="cpu")
        params = params_from_flat(_flatten_with_paths(jparams), device="cpu")
        if name == "encdec":
            batch = TranslationBatches(make_corpus(400, 64, max_words=5,
                                                   seed=0), 32,
                                       seed=0).next_batch()
        else:
            batch = LMBatches(model.cfg.vocab, 8, 16).next_batch()
        out[name] = (jmodel, jparams, model, params, batch)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _optimizers():
    return (JAdamW(lr=jwarmup_cosine(2e-3, 2, 20)),
            AdamW(lr=warmup_cosine(2e-3, 2, 20)))


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
    """Parameters after Adam's first step, ``p − lr·(g/(|g| + eps) + wd·p)``:
    within ``1e-2·lr`` where the reference's gradient element is 100 times
    its leaf's gradient tolerance (``rel``, as in ``_assert_grads_close``)
    or more, and within ``2.5·lr`` everywhere (a gradient element near the
    tolerance, such as every key-projection bias's, may turn the step's
    sign); ``1e-6·max|p|`` on top for the float32 rounding of ``p``."""
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


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_gradient_leaf_match_reference(families, family,
                                                      mixed):
    """``make_loss_fn`` + ``torch.autograd.grad`` against ``jax.grad`` of
    the reference's ``make_loss_fn``: the loss, its parts and every
    gradient leaf.  ``mixed`` casts the float32 leaves of rank ≥ 2 to
    bfloat16 before the forward on both sides, as the steps'
    ``mixed_precision`` does."""
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
    for k in ("ce_loss", "load_balance_loss"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    if family == "moe":
        assert float(aux["load_balance_loss"].detach()) > 0
    got = {k: g.numpy() for (k, _), g in zip(leaves_with_paths(params),
                                             grads)}
    _assert_grads_close(got, _flatten_with_paths(jg),
                        2e-2 if mixed else 1e-4)


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

VARIANTS = {"plain": {}, "accum2": dict(accum_steps=2),
            "mixed": dict(mixed_precision=True)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(families, family, variant):
    """One step of the port's ``make_train_step`` against
    ``jax.jit(make_train_step)`` of the reference: the metrics, the new
    parameters and the optimizer state; the inputs stay as they were."""
    jmodel, jparams, model, params, batch = families[family]
    jopt, opt = _optimizers()
    kw = VARIANTS[variant]
    jstep = jax.jit(jmake_train_step(jmodel, jopt, **kw))
    step = make_train_step(model, opt, **kw)
    (jp, js), jm = jstep(jparams, jopt.init(jparams), _jbatch(batch))
    state = opt.init(params)
    before = {k: v.clone() for k, v in leaves_with_paths((params, state))}
    batch_before = {k: v.copy() for k, v in batch.items()}
    (tp, ts), tm = step(params, state, batch)

    assert sorted(tm) == sorted(jm) == ["ce_loss", "grad_norm",
                                         "load_balance_loss", "loss", "lr"]
    mixed = variant == "mixed"
    for k in jm:
        rtol = 5e-3 if mixed and k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    assert int(ts.step) == int(js.step) == 1
    _assert_params_close(tp, jp, js.m, float(jm["lr"]),
                         2e-2 if mixed else 1e-4)
    # the first moment is 0.1 × the clipped gradient
    _assert_grads_close({k: v.numpy() for k, v in leaves_with_paths(ts.m)},
                        _flatten_with_paths(js.m),
                        2e-2 if variant == "mixed" else 1e-4)
    # functional: nothing the caller passed in changed
    for k, v in leaves_with_paths((params, state)):
        assert torch.equal(v, before[k]), k
    for k in batch:
        np.testing.assert_array_equal(batch[k], batch_before[k])


def test_accumulation_equals_mean_of_microbatch_gradients(families):
    """``accum_steps=2`` sums the two microbatches' float32 gradients in
    order and halves them: its first moment is 0.1 × that mean (no
    clipping below the norm), and its loss the mean of theirs."""
    _, _, model, params, batch = families["encdec"]
    opt = AdamW(lr=1e-3, clip_norm=None)
    (_, state), m = make_train_step(model, opt, accum_steps=2)(
        params, opt.init(params), batch)
    halves = [{k: v[i * 16:(i + 1) * 16] for k, v in batch.items()}
              for i in range(2)]
    loss_fn = make_loss_fn(model)
    grads, losses = [], []
    for h in halves:
        leaves = [x.detach().requires_grad_(True)
                  for _, x in leaves_with_paths(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves),
                          {k: torch.as_tensor(v) for k, v in h.items()})
        grads.append(torch.autograd.grad(loss, leaves))
        losses.append(loss.detach())
    for (k, got), g0, g1 in zip(leaves_with_paths(state.m), *grads):
        want = torch.div(g0 + g1, torch.tensor(2.0)) * 0.1
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-12), k
    assert float(m["loss"]) == float((losses[0] + losses[1]) / 2)


def test_grad_shardings_are_refused():
    """A mesh step runs the dense and MoE families; a recurrent family's
    is refused (``tests/test_torch_sharded_train.py`` and
    ``tests/test_torch_mesh_train.py`` run the others on meshes)."""
    model = build_model(get_config("zamba2-2.7b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="multi-GPU and the cost accounting"):
        make_train_step(model, AdamW(),
                        grad_shardings=TreeSharding(mesh=None, specs=None))


def test_lm_batches_drive_the_reference_step_too(families):
    """The port's ``LMBatches`` batch is the reference's, so the MoE step
    above saw the reference's inputs."""
    _, _, model, _, batch = families["moe"]
    want = JLMBatches(model.cfg.vocab, 8, 16).next_batch()
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
