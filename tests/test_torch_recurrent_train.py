"""One training step of the reduced recurrent models, ``zamba2-2.7b``
(``HybridLM``) and ``xlstm-1.3b`` (``XLSTMLM``), on the CPU: the port's
``make_train_step`` on a ``{"tokens", "labels"}`` batch against
``jax.jit(make_train_step)`` of the reference, with
``tests/test_torch_zoo_train.py``'s bounds (metrics 1e-5 relative, the
parameters and the first moments as there).  The models are
``tests/_torch_zoo.py``'s.
"""

import numpy as np
import pytest

import jax

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import make_train_step as jmake_train_step

from repro_torch.data import LMBatches
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import make_train_step
from repro_torch.tree import leaves_with_paths

from _torch_zoo import (  # noqa: F401  (one_torch_thread: a fixture)
    RECURRENT,
    one_torch_thread,
    recurrent,
)
from test_torch_zoo_train import (
    _assert_grads_close,
    _assert_params_close,
    _jbatch,
)


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_reference(arch):
    """One step of the port's ``make_train_step`` against
    ``jax.jit(make_train_step)`` of the reference on an ``LMBatches``
    batch (8 × 16): the metrics, the new parameters and the optimizer's
    first moment."""
    s = recurrent(arch)
    batch = LMBatches(s["cfg"].vocab, 8, 16).next_batch()
    jopt = JAdamW(lr=jwarmup_cosine(2e-3, 2, 20))
    opt = AdamW(lr=warmup_cosine(2e-3, 2, 20))
    (jp, js), jm = jax.jit(jmake_train_step(s["jmodel"], jopt))(
        s["jparams"], jopt.init(s["jparams"]), _jbatch(batch))
    (tp, ts), tm = make_train_step(s["model"], opt)(
        s["fp"], opt.init(s["fp"]), batch)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_params_close(tp, jp, js.m, float(jm["lr"]), 1e-4)
    _assert_grads_close({k: v.numpy() for k, v in leaves_with_paths(ts.m)},
                        _flatten_with_paths(js.m), 1e-4)
