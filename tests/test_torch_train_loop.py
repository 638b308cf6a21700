"""The port's training loop, its checkpointed resume and restarts, the
training driver, and a 20-step loss trajectory against the JAX package.

The trajectory runs ``trained_nmt``'s recipe (``tests/conftest.py``) from
the reference's own ``model.init(PRNGKey(0))``, carried across with
``checkpoint/bridge.py:params_from_flat``, against
``jax.jit(make_train_step)`` of the reference.  The loop and the driver
run the port alone: a resumed run must equal a straight one bit for bit.
"""

import contextlib
import io
import logging
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import inverse_sqrt as jinverse_sqrt
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.data import TranslationBatches, make_corpus
from repro_torch.distributed import StepWatchdog, run_with_restarts
from repro_torch.launch import train as train_driver
from repro_torch.models import build_model
from repro_torch.optim import AdamW, inverse_sqrt, warmup_cosine
from repro_torch.train import make_train_step, train_loop
from repro_torch.tree import leaves_with_paths

# the trained_nmt fixture's configuration (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the reference's XLA threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# a loss trajectory
# ---------------------------------------------------------------------------

def test_twenty_step_trajectory_matches_reference():
    """20 steps of ``trained_nmt``'s recipe (inverse-sqrt warmup 200, Adam
    b2 0.98, token-sorted batches of 32) from the same init: every step's
    loss and gradient norm within 1e-5 relative of the reference's
    (2.3e-7 and 6.1e-7 measured)."""
    jmodel = jbuild_model(jget_config("transformer-base").reduced(**NMT))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_config("transformer-base").reduced(**NMT),
                        device="cpu")
    params = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    jopt = JAdamW(lr=jinverse_sqrt(128, warmup=200), b2=0.98)
    opt = AdamW(lr=inverse_sqrt(128, warmup=200), b2=0.98)
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    step = make_train_step(model, opt)
    corpus = make_corpus(400, 64, max_words=5, seed=0)
    data = TranslationBatches(corpus, 32, sort_mode="tokens", seed=0)
    js, ts = jopt.init(jparams), opt.init(params)
    jp, tp = jparams, params
    losses = []
    for _ in range(20):
        b = data.next_batch()
        (jp, js), jm = jstep(jp, js, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        (tp, ts), tm = step(tp, ts, b)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the loop: checkpoints, resume, restarts
# ---------------------------------------------------------------------------

def _loop_setup(seed: int = 0):
    cfg = get_config("transformer-base").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    opt = AdamW(lr=warmup_cosine(2e-3, 2, 10))
    data = TranslationBatches(make_corpus(80, cfg.vocab, seed=0), 8,
                              sort_mode="tokens")
    return make_train_step(model, opt), params, opt.init(params), data


def _assert_trees_equal(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_train_loop_resume_is_bit_equal_to_a_straight_run():
    """10 straight steps equal 5 steps, a checkpoint, and 5 more from a
    fresh process state (other initial weights, a fresh data iterator),
    which restore the parameters, the optimizer and the data position."""
    step, params, state, data = _loop_setup()
    straight = train_loop(train_step=step, params=params, opt_state=state,
                          batches=data, steps=10, log_every=1)
    with tempfile.TemporaryDirectory() as d:
        step, params, state, data = _loop_setup()
        first = train_loop(train_step=step, params=params, opt_state=state,
                           batches=data, steps=5, log_every=1,
                           checkpointer=Checkpointer(d), save_every=5)
        assert Checkpointer(d).latest_step() == 5
        step, params, state, data = _loop_setup(seed=7)
        second = train_loop(train_step=step, params=params, opt_state=state,
                            batches=data, steps=10, log_every=1,
                            checkpointer=Checkpointer(d), save_every=5)
        assert Checkpointer(d).all_steps() == [5, 10]
    _assert_trees_equal(second["params"], straight["params"])
    _assert_trees_equal(second["opt_state"], straight["opt_state"])
    assert first["history"] + second["history"] == straight["history"]
    assert [h["step"] for h in straight["history"]] == list(range(1, 11))
    assert straight["watchdog"]["steps"] == 10
    assert second["watchdog"]["steps"] == 5


def test_run_with_restarts_resumes_the_loop_from_its_checkpoint():
    """A step that fails once at step 7 under ``run_with_restarts``: the
    job restores step 5 and ends with the straight run's weights."""
    step, params, state, data = _loop_setup()
    straight = train_loop(train_step=step, params=params, opt_state=state,
                          batches=data, steps=9)
    step, params, state, data = _loop_setup()
    calls = {"n": 0, "failed": False}

    def flaky(p, s, b):
        calls["n"] += 1
        if int(s.step) == 6 and not calls["failed"]:
            calls["failed"] = True
            raise RuntimeError("preempted")
        return step(p, s, b)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)

        def job():
            out.update(train_loop(train_step=flaky, params=params,
                                  opt_state=state, batches=data, steps=9,
                                  checkpointer=ck, save_every=5))

        run_with_restarts(job, max_restarts=1)
    assert calls["failed"] and calls["n"] == 9 + 2   # steps 6, 7 run twice
    _assert_trees_equal(out["params"], straight["params"])


def test_train_loop_metrics_callback_and_watchdog():
    step, params, state, data = _loop_setup()
    seen = []
    wd = StepWatchdog()
    out = train_loop(train_step=step, params=params, opt_state=state,
                     batches=data, steps=6, log_every=3, watchdog=wd,
                     metrics_cb=lambda s, m: seen.append((s, m["loss"])))
    assert [s for s, _ in seen] == [1, 3, 6]
    assert [h["step"] for h in out["history"]] == [1, 3, 6]
    assert all(isinstance(v, float) for h in out["history"]
               for k, v in h.items() if k != "step")
    assert wd.summary()["steps"] == 6 and out["watchdog"]["steps"] == 6


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _drive(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_driver.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("arch", ["transformer-base", "granite-moe-1b-a400m"])
def test_train_driver_runs_on_the_cpu(arch):
    out = _drive(["--device", "cpu", "--arch", arch, "--steps", "8",
                  "--batch-size", "4", "--seq-len", "16"])
    assert "final loss:" in out and "watchdog: {'steps': 8" in out


def test_train_driver_resumes_from_its_checkpoint(caplog):
    with tempfile.TemporaryDirectory() as d:
        base = ["--device", "cpu", "--batch-size", "4", "--ckpt-dir", d,
                "--save-every", "3"]
        first = _drive(base + ["--steps", "6"])
        with caplog.at_level(logging.INFO, logger="repro_torch.train"):
            second = _drive(base + ["--steps", "9"])
        assert Checkpointer(d).all_steps() == [6, 9]
    assert "final loss:" in first and "final loss:" in second
    assert "restored checkpoint at step 6" in caplog.text
    assert "watchdog: {'steps': 3" in second


def test_train_driver_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        train_driver.main(["--steps", "1"])
