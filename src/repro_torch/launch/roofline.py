"""Analytic roofline terms of a serving decode step, for an H100.

Port of the analytic part of ``repro/launch/roofline.py``
(``model_flops``, ``decode_collective_bytes``, ``weight_stream_bytes``,
``sharded_decode_cell``).  The terms come from the config alone:

    compute_s    = 2·n_active_params·rows / (tp × peak)
    memory_s     = (weight_bytes/tp + kv_bytes_per_step) / HBM_BW
    collective_s = decode_collective_bytes(...) / LINK_BW

``ServingEngine(mesh=...)`` reports ``decode_collective_bytes`` as
``ServeResult.collective_bytes_per_step``.  The reference's dry-run
assembly (``build_cell``, ``render_table``, ``main``) reads compiled-program
records and waits for ROADMAP Queue 1: multi-GPU and the cost accounting.

Hardware: one H100 SXM, dense rates without sparsity, from NVIDIA's H100
data sheet at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import SHAPES, get_config

PEAK_BF16 = 989e12      # tensor cores, bf16 (H100 SXM data sheet)
PEAK_INT8 = 1979e12     # tensor cores, int8 (H100 SXM data sheet)
HBM_BW = 3.35e12        # HBM3, bytes/s (H100 SXM data sheet)
LINK_BW = 450e9         # NVLink 4, bytes/s each way (H100 SXM data sheet)


def model_flops(arch: str, shape_name: str) -> float:
    """Operations of one step of a ``SHAPES`` entry: 6·N·tokens to train,
    2·N·tokens to prefill, 2·N·batch a decode step."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.n_active_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: per emitted token


def decode_collective_bytes(*, n_layers: int, d_model: int, rows: int,
                            tp: int, act_bytes: int = 4,
                            vocab: int = 0) -> int:
    """Per-device wire bytes of ONE tensor-parallel decode step.

    Each decoder layer all-reduces three row-parallel projections (self
    attention out, cross attention out, FFN down), each a ``(rows,
    d_model)`` activation; a ring all-reduce of ``b`` bytes moves
    ``2·b·(g-1)/g`` a device.  The vocab-parallel unembedding adds one
    logits all-gather, ``b·(g-1)/g`` of ``(rows, vocab)`` float32.
    ``tp <= 1``: 0.
    """
    if tp <= 1:
        return 0
    act = rows * d_model * act_bytes
    all_reduce = 2 * act * (tp - 1) // tp
    total = n_layers * 3 * all_reduce
    if vocab:
        total += rows * vocab * 4 * (tp - 1) // tp
    return int(total)


def weight_stream_bytes(n_params: int, *, quantized: bool = True,
                        act_bytes: int = 4, weight_bits: int = 8,
                        group_size: int = 128, scale_bytes: int = 2,
                        int4_fraction: float = 1.0) -> int:
    """Weight bytes one decode step streams from device memory.

    FP: ``n · act_bytes``; INT8: ``n``; INT4: the ``int4_fraction`` of the
    weights streams a nibble plus two ``scale_bytes`` values per
    ``group_size`` weights of a column, the rest stays INT8.
    """
    if not quantized:
        return int(n_params * act_bytes)
    if weight_bits == 8:
        return int(n_params)
    if weight_bits != 4:
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    per_w = weight_bits / 8.0 + 2.0 * scale_bytes / group_size
    return int(n_params * ((1.0 - int4_fraction) + int4_fraction * per_w))


def sharded_decode_cell(cfg, *, rows: int, tp: int, quantized: bool = True,
                        kv_bytes_per_step: int = 0, weight_bits: int = 8,
                        weight_group_size: int = 128,
                        int4_fraction: float = 1.0) -> Dict:
    """The three roofline terms of one serving decode step on ``tp`` cards
    (the formulas in the module docstring) and the dominant one.  INT4
    shrinks the memory term only: its matmul runs on the int8 tensor cores.
    """
    n = cfg.n_active_params
    act_bytes = cfg.activation_dtype.itemsize
    weight_bytes = weight_stream_bytes(
        n, quantized=quantized, act_bytes=act_bytes, weight_bits=weight_bits,
        group_size=weight_group_size, int4_fraction=int4_fraction)
    peak = PEAK_INT8 if quantized else PEAK_BF16
    coll = decode_collective_bytes(
        n_layers=cfg.n_layers, d_model=cfg.d_model, rows=rows, tp=tp,
        act_bytes=act_bytes, vocab=cfg.vocab)
    terms = {
        "compute_s": 2.0 * n * rows / (max(tp, 1) * peak),
        "memory_s": (weight_bytes / max(tp, 1) + kv_bytes_per_step) / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    return {
        "rows": rows, "tp": tp, "quantized": quantized,
        "weight_bits": weight_bits if quantized else 8 * act_bytes,
        "weight_bytes_per_step": weight_bytes,
        "collective_bytes_per_device": coll,
        "terms_s": terms,
        "dominant": dominant,
        "step_time_bound_s": max(terms.values()),
    }
