"""The serving engine on the reduced recurrent models, ``zamba2-2.7b``
(``HybridLM``) and ``xlstm-1.3b`` (``XLSTMLM``), against the JAX package
on the CPU:

* greedy ``generate`` against the reference engine (jitted) in FP, INT8
  dynamic and INT8 static: tokens, steps and host syncs equal;
* what the reference cannot run on these families, the port refuses:
  ``generate_beam`` and ``serve`` (``NotImplementedError`` naming the
  reference's failure, a ``TypeError`` in both) and ``speculative_k``
  (the reference's ``ValueError``).

The models are ``tests/_torch_zoo.py``'s (the training step:
``test_torch_recurrent_train.py``).
"""

import pytest

from repro_torch.serving import ServingEngine

from _torch_reference import import_reference_serving
from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    KINDS,
    MAX_LEN,
    MAX_NEW,
    RECURRENT,
    first_divergence,
    one_torch_thread,
    prompts,
    recurrent,
)


def _engines(arch, kind):
    s = recurrent(arch)
    (jp, jctx), (pp, pctx) = s["sides"][kind]
    jengine = import_reference_serving().ServingEngine(
        s["jmodel"], jp, quant=jctx, max_len=MAX_LEN)
    engine = ServingEngine(s["model"], pp, quant=pctx, max_len=MAX_LEN,
                           device="cpu")
    return jengine, engine


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", RECURRENT)
def test_generate_matches_reference_engine(arch, kind):
    """Greedy ``generate`` on 6 right-padded prompts: the tokens, steps and
    host syncs of the reference engine."""
    jengine, engine = _engines(arch, kind)
    toks, lens = prompts(seed=3, n=6)
    batch = {"tokens": toks, "lengths": lens}
    want = jengine.generate(batch, max_new_tokens=MAX_NEW)
    got = engine.generate(batch, max_new_tokens=MAX_NEW)
    w = [list(map(int, t)) for t in want.tokens]
    g = [list(map(int, t)) for t in got.tokens]
    assert g == w, first_divergence(w, g)
    assert (got.steps, got.host_syncs) == (want.steps, want.host_syncs)


# each call, and what the reference raises on it; the port raises
# NotImplementedError for beam and serve, the same ValueError for
# speculative decoding
CALLS = {
    "generate_beam": (lambda e, b: e.generate_beam(b, beam=2,
                                                   max_new_tokens=4),
                      TypeError, NotImplementedError, "while_loop carry"),
    "serve": (lambda e, b: e.serve([b["tokens"][0, :5]], n_slots=2,
                                   max_new_tokens=4),
              TypeError, NotImplementedError, "enc_len"),
    "speculative_k": (lambda e, b: e.generate(b, max_new_tokens=4,
                                              speculative_k=2),
                      ValueError, ValueError, "decode_step_multi"),
}


@pytest.mark.parametrize("call", sorted(CALLS))
@pytest.mark.parametrize("arch", RECURRENT)
def test_port_refuses_what_the_reference_fails(arch, call):
    """The reference engine fails on ``generate_beam``, ``serve`` and
    ``speculative_k`` for these families; the port refuses each, naming
    how the reference fails."""
    fn, ref_error, port_error, match = CALLS[call]
    jengine, engine = _engines(arch, "int8_dynamic")
    toks, lens = prompts(seed=3, n=2)
    batch = {"tokens": toks, "lengths": lens}
    with pytest.raises(ref_error):
        fn(jengine, batch)
    with pytest.raises(port_error, match=match):
        fn(engine, batch)
