"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(only launch/dryrun.py forces the 512-device placeholder topology)."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def trained_nmt():
    """Tiny Transformer NMT trained on the synthetic corpus — the paper's
    workload at miniature scale, shared (session-scoped: trained once) by
    the end-to-end system test and the INT8 BLEU-parity test layer.

    Returns ``(cfg, model, params, corpus, final_loss)``.
    """
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data import TranslationBatches, make_corpus
    from repro.models import build_model
    from repro.optim import AdamW
    from repro.optim.schedule import inverse_sqrt
    from repro.train import make_train_step

    cfg = get_config("transformer-base").reduced(
        vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
        n_heads=4, n_kv_heads=4, head_dim=32)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = AdamW(lr=inverse_sqrt(cfg.d_model, warmup=200), b2=0.98)
    opt_state = opt.init(params)
    step = jax.jit(make_train_step(model, opt))
    corpus = make_corpus(400, cfg.vocab, max_words=5, seed=0)
    data = TranslationBatches(corpus, 32, sort_mode="tokens", seed=0)
    loss = None
    for _ in range(500):
        batch = jax.tree_util.tree_map(jnp.asarray, data.next_batch())
        (params, opt_state), m = step(params, opt_state, batch)
        loss = float(m["loss"])
    return cfg, model, params, corpus, loss


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without them")
