"""The paper's Table 1 on weights the port trained itself.

The port and the reference each train the tiny NMT model with
``trained_nmt``'s recipe (``tests/conftest.py``: inverse-sqrt warmup 200,
Adam b2 0.98, 500 steps of token-sorted batches of 32) from the
reference's own ``model.init(PRNGKey(0))``, the reference under
``jax.jit``.  Their losses agree step for step through step 100; past
about step 110 the two runs part, as two runs that differ in the last bits
do at this learning rate (the port against itself with four intra-op
threads instead of one ends 50% away too), so the final single-batch
losses are not within 5% (an expected failure, with its numbers).  Then
the port KL-calibrates on the held-out sentences
(``corpus[200:232]``, one teacher-forced forward, as
``tests/_torch_reference.py:reference_calibration`` does), quantizes with
each of the paper's four modes (static activation scales) and greedy
translates the first 48 sentences through its ``ServingEngine``.  FP BLEU
must pass the reference's own bar (> 10, ``tests/test_int8_parity.py``)
and symmetric INT8 must stay within the paper's 0.5% relative bar of FP,
as ``tests/test_torch_slice.py`` asks of the reference-trained weights.
The other modes' BLEU is computed and must be a score; the paper reports
naive as failing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config as jget_config
from repro.data import make_corpus as jmake_corpus
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import inverse_sqrt as jinverse_sqrt
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_config
from repro_torch.core import (
    FP_CONTEXT,
    Calibrator,
    QuantMode,
    QuantPolicy,
    Taps,
    quantize_model,
)
from repro_torch.data import TranslationBatches, corpus_bleu, pad_batch
from repro_torch.models import EncDecLM
from repro_torch.optim import AdamW, inverse_sqrt
from repro_torch.serving import ServingEngine
from repro_torch.train import make_train_step

MAX_NEW = 16
MAX_LEN = 64
REL_DROP = 0.005                 # the paper's < 0.5% relative BLEU bar
LOSS_REL = 0.05
STEPS = 500
TRACKED = 100                    # steps whose losses agree to 1e-4
# trained_nmt's configuration (tests/conftest.py)
NMT = dict(vocab=64, d_model=128, n_layers=2, n_enc_layers=2, d_ff=256,
           n_heads=4, n_kv_heads=4, head_dim=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the reference's XLA threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def table1():
    jmodel = jbuild_model(jget_config("transformer-base").reduced(**NMT))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("transformer-base").reduced(**NMT)
    model = EncDecLM(cfg, device="cpu")
    params = params_from_flat(_flatten_with_paths(jparams), device="cpu")
    jopt = JAdamW(lr=jinverse_sqrt(cfg.d_model, warmup=200), b2=0.98)
    opt = AdamW(lr=inverse_sqrt(cfg.d_model, warmup=200), b2=0.98)
    jstate, state = jopt.init(jparams), opt.init(params)
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    step = make_train_step(model, opt)
    corpus = jmake_corpus(400, cfg.vocab, max_words=5, seed=0)
    data = TranslationBatches(corpus, 32, sort_mode="tokens", seed=0)
    losses, ref_losses = [], []
    for _ in range(STEPS):
        b = data.next_batch()
        (jparams, jstate), jm = jstep(jparams, jstate,
                                      {k: jnp.asarray(v) for k, v in b.items()})
        (params, state), m = step(params, state, b)
        ref_losses.append(jm["loss"])
        losses.append(m["loss"])
    losses = np.array([float(x) for x in losses])
    ref_losses = np.array([float(x) for x in ref_losses])

    held_out = corpus[200:232]
    src, src_len = pad_batch([s.src for s in held_out])
    tgt, tgt_len = pad_batch([s.tgt for s in held_out], add_bos=True,
                             add_eos=True)
    taps = Taps()
    model.forward(params, {"src_tokens": torch.as_tensor(src),
                           "src_lengths": torch.as_tensor(src_len),
                           "tgt_tokens": torch.as_tensor(tgt),
                           "tgt_lengths": torch.as_tensor(tgt_len)},
                  taps=taps)
    cal = Calibrator()
    cal.observe_taps(taps)

    test_set = corpus[:48]
    src, lens = pad_batch([s.src for s in test_set])
    batch = {"src_tokens": src, "src_lengths": lens}
    refs = [list(s.tgt) for s in test_set]

    def bleu(qparams, qctx):
        res = ServingEngine(model, qparams, quant=qctx, max_len=MAX_LEN,
                            device="cpu").generate(batch,
                                                   max_new_tokens=MAX_NEW)
        toks = [list(map(int, t)) for t in res.tokens]
        assert all(0 <= t < cfg.vocab for row in toks for t in row)
        return corpus_bleu(toks, refs)

    scores = {"fp": bleu(params, FP_CONTEXT)}
    for mode in ("naive", "symmetric", "independent", "conjugate"):
        qparams, qctx = quantize_model(
            params, cal.compute(mode),
            QuantPolicy(mode=QuantMode(mode), act_quant="static"),
            device="cpu")
        scores[mode] = bleu(qparams, qctx)
    print("table1", losses[0], losses[-1], ref_losses[-1], scores)
    return dict(losses=losses, ref_losses=ref_losses, bleu=scores)


def test_port_training_tracks_the_reference(table1):
    """The same batches from the same init: every loss of the first 100
    steps within 1e-4 relative of the reference's (3.3e-5 measured), and
    the loss falls over the 500 steps in both."""
    losses, ref = table1["losses"], table1["ref_losses"]
    assert np.all(np.isfinite(losses))
    rel = np.abs(losses[:TRACKED] - ref[:TRACKED]) / ref[:TRACKED]
    assert rel.max() <= 1e-4, (rel.argmax(), rel.max())
    assert losses[-1] < losses[0] and ref[-1] < ref[0]


@pytest.mark.xfail(strict=True, reason=(
    "measured: final loss 0.2653 (port, one intra-op thread) against "
    "0.5026 (reference, the trained_nmt fixture's); the runs agree to "
    "3.3e-5 through step 100 and part from step 111, and the port alone "
    "ends at 0.4021 with four threads: a single batch's loss after the "
    "runs part is not a measure of the port (ROADMAP Queue 3)"))
def test_final_loss_within_five_percent_of_the_references(table1):
    losses, ref = table1["losses"], table1["ref_losses"]
    assert abs(losses[-1] - ref[-1]) <= LOSS_REL * ref[-1], \
        (losses[-1], ref[-1])


def test_port_trained_fp_model_translates(table1):
    assert table1["bleu"]["fp"] > 10.0, table1["bleu"]


def test_symmetric_int8_within_half_percent_of_fp(table1):
    """The paper's shipped mode keeps BLEU within 0.5% relative of FP."""
    b = table1["bleu"]
    assert b["symmetric"] >= b["fp"] * (1.0 - REL_DROP), b


@pytest.mark.parametrize("mode", ["naive", "independent", "conjugate"])
def test_other_modes_give_a_score(table1, mode):
    """Every Table-1 mode quantizes, translates and scores (the paper
    gives no bar for these on this model; the numbers are in PERF.md)."""
    b = table1["bleu"]
    assert 0.0 <= b[mode] <= 100.0, b
