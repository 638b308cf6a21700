"""Serving engine: prefill + auto-regressive decode (greedy and beam).

Port of the static half of ``repro/serving/engine.py``: ``generate`` and
``generate_beam`` over a contiguous KV cache (continuous ``serve``, paging
and speculation are not ported yet).  This is the paper's workload: batched
NMT inference with a decoder loop, where beam search reorders the KV cache
every step (``kv_cache.gather_beams``, the GatherNd the paper quantized in
§5.3); with an INT8 cache the reorder moves 4× fewer bytes.

Decode runs in bursts of up to ``burst_len`` steps: the token of each step
goes into a ``(rows, burst_len)`` ring buffer on the device, and the host
drains the buffer once per burst.  PyTorch runs eagerly, so the loop itself
is on the host: before each step after the first of a burst it reads one
device flag (is any row still active?), which is how a burst stops early
once every row has finished, as the reference's ``lax.while_loop`` does.
``GenerationResult.host_syncs`` counts every device→host read: the drains
and those flags.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.data.synthetic import EOS
from repro_torch.models import kv_cache as kvc


@dataclasses.dataclass
class GenerationResult:
    tokens: List[np.ndarray]          # per-sequence generated ids (no EOS)
    steps: int
    prefill_s: float
    decode_s: float
    host_syncs: int = 0               # device→host reads (drains + flags)

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def n_tokens(self) -> int:
        return int(sum(len(t) for t in self.tokens))

    @property
    def tokens_per_s(self) -> float:
        return self.n_tokens / max(self.total_s, 1e-9)

    @property
    def decode_steps_per_s(self) -> float:
        # the first grid column is emitted by prefill, outside decode_s
        return max(self.steps - 1, 0) / max(self.decode_s, 1e-9)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` semantics: the k largest along the last axis,
    descending, ties broken toward the lower index.  ``torch.topk`` promises
    no tie order on CUDA, so this is a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class ServingEngine:
    def __init__(self, model, params, *, quant: QuantContext = FP_CONTEXT,
                 max_len: int = 256, eos_id: int = EOS, burst_len: int = 8,
                 device: str = "cuda"):
        self.device = torch.device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.quant = quant
        self.max_len = max_len
        self.eos_id = eos_id
        self.burst_len = self._check_burst(burst_len)

    # ------------------------------------------------------------------ util
    @staticmethod
    def _check_burst(k) -> int:
        k = int(k)
        if k < 1:
            raise ValueError(f"burst_len must be ≥ 1, got {k}")
        return k

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _init_state(self, batch_size: int):
        return self.model.init_decode_state(batch_size, self.max_len,
                                            quantized=self.quant.quantize_kv)

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    @staticmethod
    def _beam_gather_state(state: Dict[str, Any], idx: torch.Tensor):
        """Reorder every batch-major leaf of the decode state (paper §5.3)."""
        idx = idx.long()
        out = {}
        for k, v in state.items():
            if k == "cache":
                out[k] = kvc.gather_beams(v, idx)
            elif v is None:
                out[k] = None
            elif k in ("cross_k", "cross_v"):
                out[k] = v.index_select(1, idx)    # layer-major (L, B, ...)
            else:
                out[k] = v.index_select(0, idx)
        return out

    @staticmethod
    def _winner(grid: np.ndarray, scores: np.ndarray, alpha: float,
                eos_id: int) -> Tuple[np.ndarray, float]:
        """One beam group's length-penalized best hypothesis, truncated
        before EOS.  ``grid``: (beam, T) tokens; ``scores``: (beam,)."""
        hit = grid == eos_id
        lengths = np.where(hit.any(axis=1), np.argmax(hit, axis=1),
                           grid.shape[1])
        pen = ((5.0 + lengths) / 6.0) ** alpha
        final = scores / pen
        best = int(final.argmax())
        return grid[best, :lengths[best]], float(final[best])

    # ---------------------------------------------------------------- bursts
    def _greedy_burst(self, tokens, remaining, steps_cap: int, state):
        """Up to ``steps_cap`` greedy decode steps (``engine.py:1083-1125``).

        A row is active while ``remaining > 0``; emitting EOS or exhausting
        the budget zeroes it.  Inactive rows keep stepping, their outputs
        masked to EOS.  Returns ``(tokens, remaining, state, buf, steps,
        flag_reads)``.
        """
        model, quant, eos = self.model, self.quant, self.eos_id
        buf = torch.full((tokens.shape[0], steps_cap), eos, dtype=torch.int32,
                         device=self.device)
        step = reads = 0
        while step < steps_cap:
            if step:                      # step 0 runs: the host knows a row is live
                reads += 1
                if not bool((remaining > 0).any()):
                    break
            logits, state = model.decode_step(self.params, tokens, state,
                                              quant=quant)
            active = remaining > 0
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(active, nxt, eos)
            buf[:, step] = nxt
            remaining = torch.where(active & (nxt != eos), remaining - 1,
                                    torch.zeros_like(remaining))
            tokens = nxt
            step += 1
        return tokens, remaining, state, buf, step, reads

    def _beam_step(self, beam: int, tokens, scores, finished, comp, state,
                   buf, step: int):
        """One beam-search decode step — log-softmax, finished-beam EOS
        masking, per-group top-k, score update and the cache reorder
        (``engine.py:1305-1361`` with every row active and none parked)."""
        model, quant, eos = self.model, self.quant, self.eos_id
        R = tokens.shape[0]
        G = R // beam
        logits, state = model.decode_step(self.params, tokens, state,
                                          quant=quant)
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        V = lp.shape[-1]
        # finished beams only extend with EOS at no cost
        eos_only = torch.full((1, V), -1e30, dtype=lp.dtype, device=lp.device)
        eos_only[:, eos] = 0.0
        lp = torch.where(finished[:, None], eos_only, lp)
        cand = (scores[:, None] + lp).reshape(G, beam * V)
        scores_new, flat_idx = top_k(cand, beam)
        src_beam = torch.div(flat_idx, V, rounding_mode="floor")
        tokens = (flat_idx % V).reshape(R).to(torch.int32)
        gidx = (src_beam + torch.arange(G, device=lp.device)[:, None]
                * beam).reshape(R)
        state = self._beam_gather_state(state, gidx)
        scores = scores_new.reshape(R)
        finished = finished[gidx] | (tokens == eos)
        comp = comp[gidx]
        buf = buf[gidx]
        buf[:, step] = tokens
        return tokens, scores, finished, comp, state, buf

    def _beam_burst(self, beam: int, tokens, scores, finished, steps_cap: int,
                    state):
        """Up to ``steps_cap`` beam steps (``engine.py:1363-1401``).

        Carries ``comp``, the composition of this burst's beam permutations,
        so the host reorders its token history once per burst; the ring
        buffer is reordered alongside the state, so at exit it is already in
        final beam order.
        """
        BB = tokens.shape[0]
        buf = torch.full((BB, steps_cap), self.eos_id, dtype=torch.int32,
                         device=self.device)
        comp = torch.arange(BB, device=self.device)
        step = reads = 0
        while step < steps_cap:
            if step:
                reads += 1
                if bool(finished.all()):
                    break
            tokens, scores, finished, comp, state, buf = self._beam_step(
                beam, tokens, scores, finished, comp, state, buf, step)
            step += 1
        return tokens, scores, finished, comp, state, buf, step, reads

    # ---------------------------------------------------------------- greedy
    def generate(self, batch: Dict[str, np.ndarray], *,
                 max_new_tokens: int = 64,
                 burst_len: Optional[int] = None) -> GenerationResult:
        K = self._check_burst(self.burst_len if burst_len is None
                              else burst_len)
        batch = self._device_batch(batch)
        B = next(iter(batch.values())).shape[0]

        t0 = time.perf_counter()
        state = self._init_state(B)
        logits, state = self.model.prefill(self.params, batch, state,
                                           quant=self.quant)
        self._sync()
        t1 = time.perf_counter()

        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        first = tokens.cpu().numpy()
        host_syncs = 1
        cols = [first]
        remaining_np = np.where(first == self.eos_id, 0,
                                max(max_new_tokens - 1, 0)).astype(np.int32)
        remaining = torch.as_tensor(remaining_np, device=self.device)
        steps = 1
        while remaining_np.any():
            tokens, remaining, state, buf, s, reads = self._greedy_burst(
                tokens, remaining, K, state)
            buf_host = buf.cpu().numpy()           # one drain per burst
            remaining_np = remaining.cpu().numpy()
            host_syncs += 1 + reads
            cols.extend(buf_host[:, i] for i in range(s))
            steps += s
        t2 = time.perf_counter()

        grid = np.stack(cols, axis=1)                       # (B, T)
        seqs = []
        for row in grid:
            hit = row == self.eos_id
            seqs.append(row[:np.argmax(hit)] if hit.any() else row)
        return GenerationResult(tokens=seqs, steps=steps, prefill_s=t1 - t0,
                                decode_s=t2 - t1, host_syncs=host_syncs)

    # ------------------------------------------------------------------ beam
    def generate_beam(self, batch: Dict[str, np.ndarray], *, beam: int = 4,
                      max_new_tokens: int = 64, alpha: float = 0.6,
                      burst_len: Optional[int] = None) -> GenerationResult:
        """Beam search with per-step cache reordering (paper's GatherNd)."""
        K = self._check_burst(self.burst_len if burst_len is None
                              else burst_len)
        batch = self._device_batch(batch)
        B = next(iter(batch.values())).shape[0]
        beam_batch = {k: torch.repeat_interleave(v, beam, dim=0)
                      for k, v in batch.items()}
        BB = B * beam

        t0 = time.perf_counter()
        state = self._init_state(BB)
        logits, state = self.model.prefill(self.params, beam_batch, state,
                                           quant=self.quant)
        self._sync()
        t1 = time.perf_counter()

        logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
        V = logprobs.shape[-1]
        # first step: the top-`beam` tokens of beam 0 per request
        first = logprobs.reshape(B, beam, V)[:, 0]
        scores, tok0 = top_k(first, beam)
        scores = scores.reshape(BB)
        tokens = tok0.reshape(BB).to(torch.int32)
        seq = [tokens.cpu().numpy()]
        finished = tokens == self.eos_id
        all_done = bool(finished.all())
        host_syncs = 2

        steps_left = max_new_tokens - 1
        while steps_left > 0 and not all_done:
            tokens, scores, finished, comp, state, buf, s, reads = \
                self._beam_burst(beam, tokens, scores, finished,
                                 min(K, steps_left), state)
            comp_host = comp.cpu().numpy()
            buf_host = buf.cpu().numpy()
            all_done = bool(finished.all())
            host_syncs += 3 + reads
            # replay the burst's composed reorder over the host history
            seq = [c[comp_host] for c in seq]
            seq.extend(buf_host[:, i] for i in range(s))
            steps_left -= s
        scores_host = scores.to(torch.float32).cpu().numpy()
        host_syncs += 1
        t2 = time.perf_counter()

        grid = np.stack(seq, axis=1)                          # (BB, T)
        seqs = [self._winner(grid[b * beam:(b + 1) * beam],
                             scores_host[b * beam:(b + 1) * beam],
                             alpha, self.eos_id)[0]
                for b in range(B)]
        return GenerationResult(tokens=seqs, steps=len(seq), prefill_s=t1 - t0,
                                decode_s=t2 - t1, host_syncs=host_syncs)
