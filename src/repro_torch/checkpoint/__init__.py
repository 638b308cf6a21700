"""Checkpoints (port of ``repro/checkpoint``), and carrying the JAX
package's weights and calibrations into the port (``bridge``)."""

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
