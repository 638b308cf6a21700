"""The reduced recurrent models on the CPU against the JAX package:
``zamba2-2.7b`` (``HybridLM``: Mamba2 layers and a shared attention block)
and ``xlstm-1.3b`` (``XLSTMLM``: an mLSTM and an sLSTM layer), forward,
prefill and decode steps in FP, INT8 dynamic and calibrated INT8 static
against ``jax.jit`` of the reference's; their calibration sites and INT8
linears.  The models, their weights (the reference's ``init(PRNGKey(0))``
through ``checkpoint/bridge.py``) and the tolerances (``ATOL``,
``FLIP_SHARE``, ``FLIP_MAX``) are ``tests/_torch_zoo.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import count_quantized as jcount_quantized

from repro_torch.core import QTensor, count_quantized

from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    KINDS,
    MAX_LEN,
    RECURRENT,
    assert_logits_close,
    one_torch_thread,
    prompts,
    recurrent,
)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", RECURRENT)
def test_model_matches_reference(arch, kind):
    """forward, prefill and 3 greedy decode steps of the reduced model
    against ``jax.jit`` of the reference's, on 8 right-padded prompts."""
    s = recurrent(arch)
    jm, model = s["jmodel"], s["model"]
    (jp, jctx), (pp, pctx) = s["sides"][kind]
    toks, lens = prompts(seed=7, n=8)
    jb = {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)}
    tb = {"tokens": torch.as_tensor(toks), "lengths": torch.as_tensor(lens)}

    want, _ = jax.jit(lambda p, b: jm.forward(p, b, quant=jctx))(jp, jb)
    got, _ = model.forward(pp, tb, quant=pctx)
    assert_logits_close(got, want, kind, "forward")

    jst = jm.init_decode_state(8, MAX_LEN, quantized=pctx.quantize_kv)
    want, jst = jax.jit(lambda p, b, st: jm.prefill(p, b, st, quant=jctx))(
        jp, jb, jst)
    st = model.init_decode_state(8, MAX_LEN, quantized=pctx.quantize_kv)
    got, st = model.prefill(pp, tb, st, quant=pctx)
    assert_logits_close(got, want, kind, "prefill")
    jstep = jax.jit(lambda p, t, st: jm.decode_step(p, t, st, quant=jctx))
    for i in range(3):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jst = jstep(jp, jnp.asarray(tok), jst)
        got, st = model.decode_step(pp, torch.as_tensor(tok), st, quant=pctx)
        assert_logits_close(got, want, kind, f"decode step {i}")


# INT8 linears of each reduced tree, both packages: quantize_model looks a
# weight's calibration up by its parameter path (``mamba.0/in_proj``,
# ``blocks.0/q_proj``), and these families name their sites otherwise
# (``blocks.0/mamba/in_proj``, ``blocks.0/mlstm/q_proj``), so with static
# scales only the hybrid's shared block (path == site) is quantized
INT8_LINEARS = {("zamba2-2.7b", "int8_dynamic"): 10,
                ("zamba2-2.7b", "int8_static"): 6,
                ("xlstm-1.3b", "int8_dynamic"): 7,
                ("xlstm-1.3b", "int8_static"): 0}


@pytest.mark.parametrize("arch", RECURRENT)
def test_calibration_sites_and_quantized_linears(arch):
    """Static calibration finds the reference's sites: zamba2's in/out
    projections of each Mamba2 layer and the shared block's q/k/v/o and
    FFN (10), xlstm's mLSTM up/q/k/v/gate/down and sLSTM in/down (8).  The
    quantized trees have the reference's INT8 linears (``INT8_LINEARS``);
    the mLSTM gate stays float (the policy's ``*gate_ssm*`` deny)."""
    s = recurrent(arch)
    assert len(s["jcalibs"]) == {"zamba2-2.7b": 10, "xlstm-1.3b": 8}[arch]
    for kind in ("int8_dynamic", "int8_static"):
        (jp, _), (pp, _) = s["sides"][kind]
        n = count_quantized(pp)["quantized_linears"]
        assert n == jcount_quantized(jp)["quantized_linears"] == \
            INT8_LINEARS[arch, kind], kind
    if arch == "xlstm-1.3b":
        (_, _), (pp, _) = s["sides"]["int8_dynamic"]
        assert not isinstance(pp["blocks.0"]["gate_ssm_if"]["w"], QTensor)
        assert isinstance(pp["blocks.0"]["q_proj"]["w"], QTensor)
