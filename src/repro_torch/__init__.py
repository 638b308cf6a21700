"""PyTorch port of the INT8 NMT translation path for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (``repro_torch/core/ptq.py``
↔ ``repro/core/ptq.py``) and never imports it.  The hand-written CUDA
kernels live in ``csrc/`` and are built at first use
(``kernels/build.py``).
"""
