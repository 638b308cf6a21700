"""Helpers the port's tests share for driving the JAX reference.

``import_reference_serving`` imports ``repro.serving`` despite its Python
3.12 dataclass fault, and ``reference_calibration`` runs the reference's KL
calibration on ``trained_nmt``'s held-out sentences.  The reference package
itself is not changed.
"""

import dataclasses
import sys

import numpy as np

import jax.numpy as jnp

from repro.core import Calibrator as JCalibrator
from repro.core import Taps as JTaps
from repro.data import pad_batch as jpad_batch


def import_reference_serving():
    """Import ``repro.serving`` despite its Python 3.12 dataclass fault.

    ``serving/scheduler.py:AdmissionPlan`` gives ndarray class defaults to
    dataclass fields, which Python 3.12 rejects.  For the duration of the
    import only, ``dataclasses.dataclass`` turns such a default into
    ``field(default_factory=...)``; the original is restored afterwards.
    """
    if "repro.serving" in sys.modules:
        return sys.modules["repro.serving"]
    original = dataclasses.dataclass

    def patched(cls=None, /, **kwargs):
        def wrap(c):
            for name, value in list(vars(c).items()):
                if isinstance(value, np.ndarray):
                    setattr(c, name, dataclasses.field(
                        default_factory=lambda v=value: v.copy()))
            return original(c, **kwargs)
        return wrap if cls is None else wrap(cls)

    dataclasses.dataclass = patched
    try:
        import repro.serving as serving
    finally:
        dataclasses.dataclass = original
    return serving


def reference_calibration(jmodel, jparams, corpus):
    """The reference's KL calibration on 32 held-out sentences, taps
    recorded in one padded teacher-forced forward."""
    held_out = corpus[200:232]
    src, src_len = jpad_batch([s.src for s in held_out])
    tgt, tgt_len = jpad_batch([s.tgt for s in held_out], add_bos=True,
                              add_eos=True)
    taps = JTaps()
    jmodel.forward(jparams, {"src_tokens": jnp.asarray(src),
                             "src_lengths": jnp.asarray(src_len),
                             "tgt_tokens": jnp.asarray(tgt),
                             "tgt_lengths": jnp.asarray(tgt_len)}, taps=taps)
    cal = JCalibrator()
    cal.observe_taps(taps)
    return cal.compute("symmetric")
