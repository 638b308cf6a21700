"""Serving engine: prefill + auto-regressive decode (greedy, beam, and
continuous greedy and beam serving).

Port of ``repro/serving/engine.py``: ``generate`` and ``generate_beam``
over a contiguous KV cache (for the encoder-decoder model with a
``{"src_tokens", "src_lengths"}`` batch, and for the decoder-only model with
``{"tokens", "lengths"}``), and continuous batching (``serve``, the
encoder-decoder model only), greedy or beam search, over a contiguous or
paged KV cache with fused or unfused admission.  This is the paper's
workload: batched NMT inference with a decoder loop, where beam search
reorders the KV cache every step (``kv_cache.gather_beams``, the GatherNd
the paper quantized in §5.3); with an INT8 cache the reorder moves 4× fewer
bytes, and on the paged cache it moves block tables and one partial page a
row (``kv_cache.gather_beams_paged``).

Decode runs in bursts of up to ``burst_len`` steps: the token of each step
goes into a ``(rows, steps)`` ring buffer on the device, and the host
drains the buffer once per burst.  PyTorch runs eagerly, so the loop itself
is on the host, and it reads nothing from the device inside a burst.  The
reference's ``lax.while_loop`` stops once no row is active; here the burst
runs all its steps (at most the largest budget left, which no row can
outlive), rows that have finished only write EOS, and the device counts
the steps at whose start a row was still active.  That count is drained
with the buffer in the same transfer, so ``steps``/``decode_steps`` and
``host_syncs`` (one device→host transfer per burst, plus the first tokens)
equal the reference's.  ``burst_len="auto"`` puts the cap of ``serve``'s
bursts under ``burst_control.AdaptiveBurst``; ``generate`` and
``generate_beam`` then use 8.

``serve`` keeps ``n_slots`` decode rows busy: a finished request's row is
refilled from the waiting queue at the next burst edge.  With fused
admission (the default) a round's admitted sources are encoded, spliced
into their rows (``encdec.splice_prefill``) and seeded with BOS just before
the burst, whose first step is then their BOS step; unfused admission runs
a separate prefill on a power-of-two side batch and splices its rows in.
``serve(beam=B)`` gives each request a group of ``B`` rows and runs the
beam step with per-group budget and finished masks; a narrower request
(``beam`` as a per-request sequence) parks its group's tail rows.  On the
paged cache admission is paced by a page budget (``PageAllocator``) and
INT8 decode reads the pages in place through K5.

``serve(prefix_cache=True)`` shares encoded sources across requests and
serves: a hit splices a cached cross-K/V chain from a page pool
(``prefix_cache.PrefixCache``) instead of running the encoder.
``overcommit > 1`` admits past the worst-case page reservation, grows rows
page by page between bursts and, when the pool runs dry, preempts a victim
by page spill: its pages, cursors, tokens and cross K/V go to the host in
one transfer and come back later through the same paged splice admission
uses.  ``chaos`` forces preemptions and slow rounds at round edges.  The
tokens stay those of a cold, unloaded serve.

``serve(prefill_chunk=N)`` stages the encode of a source longer than ``N``
tokens over serving rounds, one width-1 encoder layer a round
(``EncDecLM.encode_staged_*``), and splices it in when the last layer is
done.  ``generate`` and greedy ``serve`` take ``speculative_k=k``:
each macro-step drafts ``k`` tokens with ``draft_quant`` (the engine's
``quant`` unless given), verifies them in one multi-position pass with
``quant`` and emits the longest agreeing prefix plus the verifier's
correction, so the tokens are those of plain greedy decode.

``ServingEngine(mesh=...)`` serves tensor-parallel (the encoder-decoder
model and the decoder-only dense and MoE ones; the recurrent families,
and experts that do not divide the tensor axis, raise
``NotImplementedError`` naming the ROADMAP item by title): every rank
runs this engine on the same requests with its shard of the weights and
of the decode state's heads (``serving.sharding``), the layers run the
collectives, and the host side (scheduler, pages, prefix cache, spills)
is the same on every rank, so the tokens and ``host_syncs`` are the
unsharded engine's.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.data.sorting import next_pow2
from repro_torch.data.synthetic import EOS, pad_batch
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.launch.roofline import decode_collective_bytes
from repro_torch.models import kv_cache as kvc
from repro_torch.models.layers import top_k
from repro_torch.models.registry import build_model
from repro_torch.serving.burst_control import AdaptiveBurst
from repro_torch.serving.chaos import ChaosSchedule
from repro_torch.serving.preemption import (
    SpilledRequest,
    SpillStore,
    pick_victims,
)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import (
    ContinuousScheduler,
    Request,
    pad_rows_pow2,
)
from repro_torch.serving.sharding import (
    MESH_ITEM,
    mesh_axis_sizes,
    shard_decode_state,
    shard_for_serving,
    tp_degree,
)

# how the reference fails where the port refuses a recurrent model (the
# hybrid and ssm families, whose decode state keeps rows off axis 0)
_RECURRENT_BEAM = (
    "the reference's generate_beam fails on it with a TypeError from its "
    "while_loop carry: _reorder gathers rows on axis 0, the layer or group "
    "axis of the recurrent states (ROADMAP Queue 3)")
_RECURRENT_SERVE = (
    "the reference's serve fails on it with TypeError: init_decode_state() "
    "got an unexpected keyword argument 'enc_len'")

# a new beam group's seed score: row 0 scores 0 and rows 1..B-1 this, so the
# shared beam step's first top-k draws only row 0's candidates, which is
# generate_beam's first step (top-k over the beam-0 log-probs)
BEAM_SEED_NEG = np.float32(-1e30)

# largest step cap of burst_len="auto"
AUTO_MAX_BURST = 64


def _spec_accept(d: torch.Tensor, v: torch.Tensor, remaining: torch.Tensor,
                 eos: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative acceptance (``engine.py:109-134`` of the reference).

    ``d``: (B, s) drafted tokens; ``v``: (B, s+1) the verifier's greedy
    tokens over the same positions; ``remaining``: (B,) budgets (0 = an
    inactive row).  Returns ``(stop, hit_eos, accepted)``, all (B,) int32
    or bool: a row emits ``v[:, :stop]``, the longest prefix on which the
    draft agrees with the verifier plus the verifier's correction, clamped
    by the first verifier EOS (emitted, then the row stops) and by the
    budget; ``hit_eos`` marks rows whose window ends in that EOS;
    ``accepted`` counts the emitted tokens that came from the draft.
    """
    s = d.shape[1]
    active = remaining > 0
    agree = torch.cumprod((d == v[:, :s]).to(torch.int32), dim=1,
                          dtype=torch.int32)
    a = agree.sum(dim=1, dtype=torch.int32)      # longest agreeing prefix
    cand = a + 1                                 # + the verifier's correction
    idx = torch.arange(s + 1, dtype=torch.int32, device=d.device)[None, :]
    eos_first = torch.where(v == eos, idx, s + 1).amin(dim=1)
    stop = torch.minimum(torch.minimum(cand, eos_first + 1), remaining)
    stop = torch.where(active, stop, torch.zeros_like(stop))
    hit_eos = active & (eos_first + 1 <= torch.minimum(cand, remaining))
    accepted = torch.minimum(a, stop)
    return stop, hit_eos, accepted


@dataclasses.dataclass
class GenerationResult:
    tokens: List[np.ndarray]          # per-sequence generated ids (no EOS)
    steps: int
    prefill_s: float
    decode_s: float
    host_syncs: int = 0               # device→host transfers (drains)
    speculative_k: int = 0            # draft window (0 = plain decode)
    draft_tokens: int = 0             # tokens the draft proposed
    accepted_tokens: int = 0          # drafted tokens the verifier kept

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.draft_tokens, 1)

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


@dataclasses.dataclass
class ServeResult:
    """Outcome of one continuous-batching serve.

    With ``beam > 1`` every request occupied a group of ``beam`` rows:
    ``n_slots`` counts rows, ``busy_slot_steps`` counts a busy group's
    live rows, and each ``Request.tokens`` holds the group's winning
    hypothesis (``Request.score`` its length-penalized log-prob).
    """

    requests: List[Request]           # submission order, lifecycle filled in
    n_slots: int
    decode_steps: int
    busy_slot_steps: int              # Σ over steps of occupied rows
    prefill_rounds: int               # admission rounds (fused or not)
    wall_s: float
    host_syncs: int = 0               # device→host transfers (drains)
    burst_len: int = 1                # final step cap (adapts when auto)
    beam: int = 1                     # rows per request group (1 = greedy)
    prefill_dispatches: int = 0       # separate prefill runs (0 when fused)
    encoder_tokens: int = 0           # encoder row-tokens of admissions
    fused_admission: bool = True
    auto_burst: bool = False          # burst_len ran under AdaptiveBurst
    paged: bool = False               # KV cache was paged (block tables)
    page_size: int = 0
    pages_in_use: int = 0             # allocator pages still held at the end
    page_hwm: int = 0                 # peak concurrent pages over the serve
    reorder_bytes: int = 0            # bytes the beam reorders moved
    # the prefix cache (per-serve deltas; the cache persists on the engine)
    prefix_cache: bool = False
    prefix_hits: int = 0              # admissions that skipped the encoder
    prefix_misses: int = 0
    prefix_inserts: int = 0           # misses that cached their encode
    prefix_evictions: int = 0
    prefix_hit_pages: int = 0         # chain pages hits read instead of wrote
    prefix_pages_allocated: int = 0   # chain pages reserved by this serve
    prefix_chains: int = 0            # chains resident at serve end
    # overload machinery (all zero on a serve that never hit pressure)
    overcommit: float = 1.0           # reserve cap ÷ physical pool size
    preemptions: int = 0              # evictions (chaos-forced + pressure)
    spill_events: int = 0             # KV page sets copied to the host
    restore_events: int = 0           # spills spliced back on re-admission
    spilled_bytes: int = 0            # cumulative host bytes spilled
    straggler_rounds: int = 0         # watchdog-flagged burst rounds
    chunked_admissions: int = 0       # requests whose encode was staged
    chunk_rounds: int = 0             # staged encoder layers run
    peak_running: int = 0             # max concurrent running requests
    rejected: int = 0                 # requests shed (deadline unmeetable)
    deadline_misses: int = 0          # shed + finished past their deadline
    free_lwm: int = 0                 # page free-list low-water mark
    fragmentation: float = 0.0        # final free-list scatter in [0, 1]
    # self-speculative decoding (greedy only)
    speculative_k: int = 0            # draft window (0 = speculation off)
    draft_tokens: int = 0             # tokens the draft passes proposed
    accepted_tokens: int = 0          # drafted tokens the verifier kept
    # multi-GPU serving: the engine's mesh (tensor parallel) and the
    # replicas behind a ReplicaRouter (set by the router after the merge)
    mesh_shape: Tuple[int, ...] = ()  # mesh axis sizes, () = unsharded
    tp_degree: int = 1                # "model"-axis width the serve ran at
    replicas: int = 1                 # engine replicas behind the router
    collective_bytes_per_step: int = 0  # predicted per-device wire bytes
    #                                     of a decode step (ring all-reduce)

    @property
    def acceptance_rate(self) -> float:
        """Share of the drafted tokens the verifier kept (0 without
        speculation)."""
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def n_groups(self) -> int:
        """Request groups the decode grid holds (``n_slots`` for greedy)."""
        return self.n_slots // self.beam

    @property
    def n_tokens(self) -> int:
        return int(sum(len(r.tokens) for r in self.requests))

    @property
    def utilization(self) -> float:
        """Occupied-row fraction of the decode grid actually computed."""
        return self.busy_slot_steps / max(self.n_slots * self.decode_steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.n_tokens / max(self.wall_s, 1e-9)

    @property
    def decode_steps_per_s(self) -> float:
        return self.decode_steps / max(self.wall_s, 1e-9)

    def tokens_for(self, req_id: int) -> np.ndarray:
        """Generated ids for one request."""
        for r in self.requests:
            if r.req_id == req_id:
                return np.asarray(r.tokens, np.int32)
        raise KeyError(req_id)

    def metrics(self) -> Dict[str, float]:
        first = [r.first_token_latency_s for r in self.requests
                 if r.first_token_latency_s is not None]
        total = [r.total_latency_s for r in self.requests
                 if r.total_latency_s is not None]
        pct = lambda xs, q: float(np.percentile(xs, q)) if xs else 0.0
        return {
            "n_requests": float(len(self.requests)),
            "n_tokens": float(self.n_tokens),
            "beam": float(self.beam),
            "n_groups": float(self.n_groups),
            "wall_s": self.wall_s,
            "tokens_per_s": self.tokens_per_s,
            "utilization": self.utilization,
            "decode_steps": float(self.decode_steps),
            "decode_steps_per_s": self.decode_steps_per_s,
            "host_syncs": float(self.host_syncs),
            "burst_len": float(self.burst_len),
            "prefill_rounds": float(self.prefill_rounds),
            "prefill_dispatches": float(self.prefill_dispatches),
            "encoder_tokens": float(self.encoder_tokens),
            "paged": float(self.paged),
            "pages_in_use": float(self.pages_in_use),
            "page_hwm": float(self.page_hwm),
            "reorder_bytes": float(self.reorder_bytes),
            "prefix_cache": float(self.prefix_cache),
            "prefix_hits": float(self.prefix_hits),
            "prefix_misses": float(self.prefix_misses),
            "prefix_inserts": float(self.prefix_inserts),
            "prefix_evictions": float(self.prefix_evictions),
            "prefix_hit_pages": float(self.prefix_hit_pages),
            "prefix_pages_allocated": float(self.prefix_pages_allocated),
            "prefix_chains": float(self.prefix_chains),
            "prefix_hit_rate": (self.prefix_hits /
                                max(self.prefix_hits + self.prefix_misses, 1)),
            "overcommit": float(self.overcommit),
            "preemptions": float(self.preemptions),
            "spill_events": float(self.spill_events),
            "restore_events": float(self.restore_events),
            "spilled_bytes": float(self.spilled_bytes),
            "straggler_rounds": float(self.straggler_rounds),
            "chunked_admissions": float(self.chunked_admissions),
            "chunk_rounds": float(self.chunk_rounds),
            "peak_running": float(self.peak_running),
            "rejected": float(self.rejected),
            "deadline_misses": float(self.deadline_misses),
            "free_lwm": float(self.free_lwm),
            "fragmentation": float(self.fragmentation),
            "speculative_k": float(self.speculative_k),
            "draft_tokens": float(self.draft_tokens),
            "accepted_tokens": float(self.accepted_tokens),
            "acceptance_rate": self.acceptance_rate,
            "tp_degree": float(self.tp_degree),
            "replicas": float(self.replicas),
            "collective_bytes_per_step":
                float(self.collective_bytes_per_step),
            "first_token_latency_mean_s":
                float(np.mean(first)) if first else 0.0,
            "first_token_latency_p95_s": pct(first, 95),
            "total_latency_mean_s": float(np.mean(total)) if total else 0.0,
            "total_latency_p95_s": pct(total, 95),
        }


class ServingEngine:
    def __init__(self, model, params, *, quant: QuantContext = FP_CONTEXT,
                 max_len: int = 256, eos_id: int = EOS,
                 burst_len: Union[int, str] = 8, paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_cache: bool = False, prefix_pages: int = 256,
                 draft_quant: Optional[QuantContext] = None,
                 mesh=None, device: str = "cuda"):
        """``paged``/``page_size``/``n_pages`` choose ``serve``'s KV cache
        (``generate`` always uses the contiguous one); ``max_len`` must
        then be a page multiple, so the paged logical view has exactly the
        contiguous shape.  ``burst_len="auto"`` adapts ``serve``'s burst
        cap (:class:`AdaptiveBurst`).  ``prefix_cache`` is ``serve``'s
        default for its own ``prefix_cache`` argument; the cache's chain
        pool holds ``prefix_pages`` pages of ``page_size`` tokens, built at
        first use and kept across serves.  ``draft_quant`` is the context
        of speculative decoding's draft steps (None: ``quant``); it shares
        the engine's params, and the KV cache layout follows ``quant``."""
        self.device = torch.device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        # tensor parallel: every rank runs this engine on the same requests
        # with its shard of the weights (serving.sharding) and its slice of
        # the decode state's heads; the layers run the collectives
        self.mesh = mesh
        self.tp = tp_degree(mesh)
        self._full_model = model
        if mesh is not None:
            if getattr(model, "recurrent", False):
                raise NotImplementedError(
                    f"tensor-parallel serving of {type(model).__name__} is "
                    f"not ported yet ({MESH_ITEM}); the encoder-decoder "
                    f"and the decoder-only attention families serve on a "
                    f"mesh")
            params, local_cfg = shard_for_serving(params, mesh, model.cfg)
            model = build_model(local_cfg, device=str(model.device))
        self.model = model
        self.params = params
        self.quant = quant
        self.draft_quant = quant if draft_quant is None else draft_quant
        self.max_len = max_len
        self.eos_id = eos_id
        self.burst_len = self._check_burst(burst_len)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.n_pages = n_pages
        if self.paged and max_len % self.page_size:
            raise ValueError(f"paged cache needs max_len % page_size == 0, "
                             f"got {max_len} % {self.page_size}")
        self._enc_bucket_hwm = 0
        self.prefix_cache_default = bool(prefix_cache)
        self.prefix_pages = int(prefix_pages)
        self._prefix_cache_obj: Optional[PrefixCache] = None
        self._prefix_pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # ------------------------------------------------------------------ util
    def _check_speculative(self, speculative_k: Optional[int]) -> int:
        """The draft window ``k`` (0: plain decode)."""
        spec = int(speculative_k or 0)
        if spec < 0:
            raise ValueError(f"speculative_k must be >= 0, got {spec}")
        if spec and not hasattr(self.model, "decode_step_multi"):
            raise ValueError(
                "speculative decoding needs a model with decode_step_multi "
                f"(multi-position verify); {type(self.model).__name__} "
                "does not provide one")
        return spec

    @staticmethod
    def _check_burst(k) -> Union[int, str]:
        """An int cap ≥ 1, or ``"auto"``."""
        if isinstance(k, str):
            if k == "auto":
                return k
            raise ValueError(f"burst_len must be an int ≥ 1 or 'auto', "
                             f"got {k!r}")
        k = int(k)
        if k < 1:
            raise ValueError(f"burst_len must be ≥ 1, got {k}")
        return k

    def _resolve_burst(self, burst_len) -> Union[int, str]:
        """A call's burst length: its own, else the engine's."""
        return self._check_burst(self.burst_len if burst_len is None
                                 else burst_len)

    def _static_burst(self, burst_len) -> int:
        """``generate``'s and ``generate_beam``'s cap: ``"auto"`` adapts
        ``serve`` only, and static batches take a mid cap of 8."""
        K = self._resolve_burst(burst_len)
        return 8 if K == "auto" else K

    def _burst_controller(self, K) -> Optional[AdaptiveBurst]:
        """An :class:`AdaptiveBurst` when ``K == "auto"``, else None."""
        if K != "auto":
            return None
        start = self.burst_len if isinstance(self.burst_len, int) else 8
        return AdaptiveBurst(start=start, max_burst=AUTO_MAX_BURST)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _new_state(self, batch_size: int, **kw):
        """A fresh decode state, this rank's shard of it on a mesh."""
        return self._shard_state(self._full_model.init_decode_state(
            batch_size, self.max_len, quantized=self.quant.quantize_kv, **kw))

    def _shard_state(self, state):
        """This rank's shard of a fresh decode state (or prefix pool): the
        K/V pools cut to its heads, the rest whole.  No-op without a
        mesh."""
        if self.mesh is None:
            return state
        cfg = self._full_model.cfg
        return shard_decode_state(state, self.mesh, kv_heads=cfg.n_kv_heads,
                                  head_dim=cfg.hd)

    def _mesh_result_fields(self, rows: int) -> Dict[str, Any]:
        """ServeResult fields of the mesh the serve ran on."""
        if self.mesh is None:
            return {}
        cfg = self._full_model.cfg
        return dict(
            mesh_shape=mesh_axis_sizes(self.mesh), tp_degree=self.tp,
            collective_bytes_per_step=decode_collective_bytes(
                n_layers=cfg.n_layers, d_model=cfg.d_model, rows=rows,
                tp=self.tp, act_bytes=cfg.activation_dtype.itemsize,
                vocab=cfg.vocab))

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    @staticmethod
    def _beam_gather_state(state: Dict[str, Any], idx: torch.Tensor):
        """Reorder every batch-major leaf of the decode state (paper §5.3).

        Paged cache: the reorder is a block-table permutation plus one
        partial-page copy a row (``kv_cache.gather_beams_paged``), and the
        cross K/V and source lengths are left alone: a beam reorder only
        permutes rows within a group, whose rows share one encoder memory.
        """
        idx = idx.long()
        cache = state["cache"]
        if isinstance(cache, kvc.PagedKVCache):
            out = dict(state)
            out["cache"] = kvc.gather_beams_paged(cache, idx)
            return out
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
    @staticmethod
    def _drain(*parts: torch.Tensor) -> List[np.ndarray]:
        """Copy several device tensors to the host in one transfer.

        Integer and bool tensors travel as int32, float32 ones by their bit
        pattern; each comes back as a numpy array of its own shape (bool as
        int32, float32 as float32).
        """
        flat = [p.reshape(-1).view(torch.int32) if p.dtype == torch.float32
                else p.reshape(-1).to(torch.int32) for p in parts]
        host = torch.cat(flat).cpu().numpy()
        out, i = [], 0
        for p in parts:
            a = host[i:i + p.numel()].reshape(tuple(p.shape))
            out.append(a.view(np.float32) if p.dtype == torch.float32 else a)
            i += p.numel()
        return out

    def _greedy_burst(self, tokens, remaining, steps_cap: int, state):
        """``steps_cap`` greedy decode steps (``engine.py:1083-1125``).

        A row is active while ``remaining > 0``; emitting EOS or exhausting
        the budget zeroes it.  Inactive rows keep stepping, their outputs
        masked to EOS.  Returns ``(tokens, remaining, state, buf, live)``:
        ``live`` (a device scalar) counts the steps at whose start a row
        was active, the reference's ``while_loop`` trip count.
        """
        model, quant, eos = self.model, self.quant, self.eos_id
        buf = torch.full((tokens.shape[0], steps_cap), eos, dtype=torch.int32,
                         device=self.device)
        live = torch.zeros((), dtype=torch.int32, device=self.device)
        for step in range(steps_cap):
            active = remaining > 0
            live = live + active.any()
            logits, state = model.decode_step(self.params, tokens, state,
                                              quant=quant)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(active, nxt, eos)
            buf[:, step] = nxt
            remaining = torch.where(active & (nxt != eos), remaining - 1,
                                    torch.zeros_like(remaining))
            tokens = nxt
        return tokens, remaining, state, buf, live

    def _spec_burst(self, tokens, remaining, steps_cap: int, state,
                    spec: int):
        """``steps_cap`` self-speculative macro-steps
        (``_spec_greedy_while``, ``engine.py:1203-1290``).

        A macro-step runs ``spec`` draft ``decode_step``s with
        ``draft_quant``, then one verify ``decode_step_multi`` over
        ``(t0, d_1 … d_spec)`` with ``quant`` from the pre-draft cursors:
        the drafts' in-place cache writes are scratch, and the verify's
        appends overwrite each of them before it reads.  :func:`_spec_accept`
        picks how many verifier tokens each row emits; the cursors roll back
        to ``n0 + stop``, so the cache holds the verifier's K/V of exactly
        the tokens plain decode would have fed, and the tokens equal plain
        greedy decode's.

        The ring holds ``steps_cap × (spec + 1)`` columns, written at
        per-row ``emitted`` cursors, followed by 4 counter columns per row:
        ``emitted``, ``drafted``, ``accepted`` and ``act`` (macro-steps the
        row was live), so a burst still drains in one transfer.  Every live
        row emits ≥ 1 token a macro-step, so ``steps_cap`` ≤ the largest
        budget left runs no macro-step the reference would not; ``live``
        counts those at whose start a row was active, the reference's trip
        count.
        """
        model, eos = self.model, self.eos_id
        B = tokens.shape[0]
        cols = steps_cap * (spec + 1)
        # one column past the ring takes the masked writes
        buf = torch.full((B, cols + 1), eos, dtype=torch.int32,
                         device=self.device)
        rows = torch.arange(B, device=self.device)
        emitted = drafted = accepted = act = torch.zeros(
            (B,), dtype=torch.int32, device=self.device)
        live = torch.zeros((), dtype=torch.int32, device=self.device)
        for _ in range(steps_cap):
            active = remaining > 0
            live = live + active.any()
            n0 = state["cache"].lengths
            dstate, cur, drafts = state, tokens, []
            for _ in range(spec):
                lg, dstate = model.decode_step(self.params, cur, dstate,
                                               quant=self.draft_quant)
                cur = torch.argmax(lg, dim=-1).to(torch.int32)
                drafts.append(cur)
            d = torch.stack(drafts, dim=1)                    # (B, spec)
            vlogits, state = model.decode_step_multi(
                self.params, torch.cat([tokens[:, None], d], dim=1), state,
                quant=self.quant)
            v = torch.argmax(vlogits, dim=-1).to(torch.int32)  # (B, spec+1)
            stop, hit_eos, acc = _spec_accept(d, v, remaining, eos)
            state = dict(state)
            state["cache"] = kvc.with_lengths(state["cache"], n0 + stop)
            for j in range(spec + 1):
                col = torch.where(active & (j < stop), emitted + j, cols)
                buf.index_put_((rows, col.long()), v[:, j])
            remaining = torch.where(hit_eos, torch.zeros_like(remaining),
                                    remaining - stop)
            tokens = torch.where(
                active, v[rows, (stop - 1).clamp(min=0).long()], eos)
            emitted = emitted + stop
            drafted = drafted + torch.where(active, spec, 0).to(torch.int32)
            accepted = accepted + acc
            act = act + active.to(torch.int32)
        packed = torch.cat([buf[:, :cols], emitted[:, None], drafted[:, None],
                            accepted[:, None], act[:, None]], dim=1)
        return tokens, remaining, state, packed, live

    def _beam_step(self, beam: int, tokens, scores, finished, comp, state,
                   buf, step: int, act_r=None, parked=None):
        """One beam-search decode step — log-softmax, finished-beam EOS
        masking, per-group top-k, score update and the cache reorder
        (``engine.py:1305-1361``).

        ``act_r`` (R,) bool: rows of inactive groups gather themselves and
        keep their tokens, scores, finished, ``comp`` and ring entries.
        ``parked`` (R,) bool: the tail rows of a request narrower than the
        group are pinned to EOS, ``BEAM_SEED_NEG`` and finished, so they
        never enter the group's top-k ahead of a real hypothesis.  Both
        ``None`` (``generate_beam``): every row active and none parked, and
        the step skips the masking.
        """
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
        tok_new = (flat_idx % V).reshape(R).to(torch.int32)
        gidx = (src_beam + torch.arange(G, device=lp.device)[:, None]
                * beam).reshape(R)
        if act_r is None:
            tokens, scores = tok_new, scores_new.reshape(R)
            done, col = tokens == eos, tokens
        else:
            tok_new = torch.where(parked, eos, tok_new)
            gidx = torch.where(act_r & ~parked, gidx,
                               torch.arange(R, device=lp.device))
            tokens = torch.where(act_r, tok_new, tokens)
            scores = torch.where(act_r, scores_new.reshape(R), scores)
            scores = torch.where(
                parked, torch.full_like(scores, BEAM_SEED_NEG), scores)
            done = (act_r & (tokens == eos)) | parked
            col = torch.where(act_r, tokens, eos)
        state = self._beam_gather_state(state, gidx)
        finished = finished[gidx] | done
        comp = comp[gidx]
        buf = buf[gidx]
        buf[:, step] = col
        return tokens, scores, finished, comp, state, buf

    def _beam_burst(self, beam: int, tokens, scores, finished, steps_cap: int,
                    state):
        """``steps_cap`` beam steps (``engine.py:1363-1401``).

        Carries ``comp``, the composition of this burst's beam permutations,
        so the host reorders its token history once per burst; the ring
        buffer is reordered alongside the state, so at exit it is already in
        final beam order.  Once every beam has finished a step changes
        nothing the host reads: each beam extends with EOS at no cost and
        top-k keeps the beams in place.  ``live`` (a device scalar) counts
        the steps at whose start a beam was unfinished.
        """
        BB = tokens.shape[0]
        buf = torch.full((BB, steps_cap), self.eos_id, dtype=torch.int32,
                         device=self.device)
        comp = torch.arange(BB, device=self.device)
        live = torch.zeros((), dtype=torch.int32, device=self.device)
        for step in range(steps_cap):
            live = live + (~finished).any()
            tokens, scores, finished, comp, state, buf = self._beam_step(
                beam, tokens, scores, finished, comp, state, buf, step)
        return tokens, scores, finished, comp, state, buf, live

    def _beam_serve_burst(self, beam: int, tokens, scores, finished,
                          remaining, steps_cap: int, state, parked):
        """``steps_cap`` group-masked beam steps of continuous beam serving
        (``_beam_serve_while``, ``engine.py:1410-1470``).

        The grid holds ``R // beam`` groups, each with its own step budget
        ``remaining`` (G,).  A group is active while its budget is > 0 and
        not all of its rows have finished; only active groups step their
        search state and count their budget down.  Groups only deactivate
        inside a burst, so a group active at step ``s`` has taken ``s``
        steps, and the host recovers each group's steps as ``remaining``
        in minus out.  ``live`` (a device scalar) counts the steps at whose
        start a group was active, the reference's trip count.
        """
        R = tokens.shape[0]
        G = R // beam
        buf = torch.full((R, steps_cap), self.eos_id, dtype=torch.int32,
                         device=self.device)
        comp = torch.arange(R, device=self.device)
        live = torch.zeros((), dtype=torch.int32, device=self.device)
        for step in range(steps_cap):
            act_g = (remaining > 0) & ~finished.reshape(G, beam).all(dim=1)
            live = live + act_g.any()
            tokens, scores, finished, comp, state, buf = self._beam_step(
                beam, tokens, scores, finished, comp, state, buf, step,
                act_g.repeat_interleave(beam), parked)
            remaining = remaining - act_g.to(remaining.dtype)
        return tokens, scores, finished, remaining, comp, state, buf, live

    # ---------------------------------------------------------------- greedy
    def generate(self, batch: Dict[str, np.ndarray], *,
                 max_new_tokens: int = 64,
                 burst_len: Optional[int] = None,
                 speculative_k: Optional[int] = None) -> GenerationResult:
        """Greedy decode of a batch.  ``speculative_k=k`` decodes in
        self-speculative macro-steps (:meth:`_spec_burst`): the same tokens,
        with the draft and accept counts in the result."""
        spec = self._check_speculative(speculative_k)
        K = self._static_burst(burst_len)
        batch = self._device_batch(batch)
        B = next(iter(batch.values())).shape[0]

        t0 = time.perf_counter()
        state = self._new_state(B)
        logits, state = self.model.prefill(self.params, batch, state,
                                           quant=self.quant)
        self._sync()
        t1 = time.perf_counter()

        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        first, = self._drain(tokens)
        host_syncs = 1
        # per-row segments: speculative bursts emit ragged per-row counts
        rows = [[int(t)] for t in first]
        draft_total = accept_total = 0
        remaining_np = np.where(first == self.eos_id, 0,
                                max(max_new_tokens - 1, 0)).astype(np.int32)
        remaining = torch.as_tensor(remaining_np, device=self.device)
        steps = 1
        while remaining_np.any():
            cap = min(K, int(remaining_np.max()))
            if spec:
                tokens, remaining, state, buf, live = self._spec_burst(
                    tokens, remaining, cap, state, spec)
            else:
                tokens, remaining, state, buf, live = self._greedy_burst(
                    tokens, remaining, cap, state)
            buf_host, remaining_np, s = self._drain(buf, remaining, live)
            host_syncs += 1                        # one drain per burst
            emit = cap * (spec + 1)                # spec: counter columns
            for b in range(B):
                n = buf_host[b, emit] if spec else s
                rows[b].extend(int(x) for x in buf_host[b, :n])
                if spec:
                    draft_total += int(buf_host[b, emit + 1])
                    accept_total += int(buf_host[b, emit + 2])
            steps += int(s)
        t2 = time.perf_counter()

        seqs = []
        for row in rows:
            row = np.asarray(row, np.int32)
            hit = row == self.eos_id
            seqs.append(row[:np.argmax(hit)] if hit.any() else row)
        return GenerationResult(tokens=seqs, steps=steps, prefill_s=t1 - t0,
                                decode_s=t2 - t1, host_syncs=host_syncs,
                                speculative_k=spec, draft_tokens=draft_total,
                                accepted_tokens=accept_total)

    # ------------------------------------------------------------------ beam
    def generate_beam(self, batch: Dict[str, np.ndarray], *, beam: int = 4,
                      max_new_tokens: int = 64, alpha: float = 0.6,
                      burst_len: Optional[int] = None) -> GenerationResult:
        """Beam search with per-step cache reordering (paper's GatherNd).
        A recurrent model (``model.recurrent``) raises
        ``NotImplementedError``, as the reference fails on it."""
        if getattr(self.model, "recurrent", False):
            raise NotImplementedError(
                f"generate_beam is not available for "
                f"{type(self.model).__name__}: {_RECURRENT_BEAM}")
        K = self._static_burst(burst_len)
        batch = self._device_batch(batch)
        B = next(iter(batch.values())).shape[0]
        beam_batch = {k: torch.repeat_interleave(v, beam, dim=0)
                      for k, v in batch.items()}
        BB = B * beam

        t0 = time.perf_counter()
        state = self._new_state(BB)
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
        first, scores_host = self._drain(tokens, scores)
        seq = [first]
        host_syncs = 1
        finished = tokens == self.eos_id
        all_done = bool((first == self.eos_id).all())

        steps_left = max_new_tokens - 1
        while steps_left > 0 and not all_done:
            tokens, scores, finished, comp, state, buf, live = \
                self._beam_burst(beam, tokens, scores, finished,
                                 min(K, steps_left), state)
            comp_host, buf_host, fin_host, scores_host, s = self._drain(
                comp, buf, finished, scores, live)
            s = int(s)
            all_done = bool(fin_host.all())
            host_syncs += 1                        # one drain per burst
            # replay the burst's composed reorder over the host history
            seq = [c[comp_host] for c in seq]
            seq.extend(buf_host[:, i] for i in range(s))
            steps_left -= s
        t2 = time.perf_counter()

        grid = np.stack(seq, axis=1)                          # (BB, T)
        seqs = [self._winner(grid[b * beam:(b + 1) * beam],
                             scores_host[b * beam:(b + 1) * beam],
                             alpha, self.eos_id)[0]
                for b in range(B)]
        return GenerationResult(tokens=seqs, steps=len(seq), prefill_s=t1 - t0,
                                decode_s=t2 - t1, host_syncs=host_syncs)

    # ------------------------------------------------------------ continuous
    def _as_requests(self, requests: Sequence[Any],
                     max_new_tokens: Union[int, Sequence[int]]
                     ) -> List[Request]:
        per_req = (list(max_new_tokens)
                   if isinstance(max_new_tokens, (list, tuple, np.ndarray))
                   else [int(max_new_tokens)] * len(requests))
        if len(per_req) != len(requests):
            raise ValueError("max_new_tokens sequence length "
                             f"{len(per_req)} != {len(requests)} requests")
        out = []
        for i, (r, m) in enumerate(zip(requests, per_req)):
            if isinstance(r, Request):
                out.append(r)
                continue
            src = r.src if hasattr(r, "src") else np.asarray(r, np.int32)
            out.append(Request(req_id=i, src=np.asarray(src, np.int32),
                               max_new_tokens=int(m)))
        ids = [r.req_id for r in out]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate req_ids in serve() input (raw "
                             "requests are numbered by position; supplied "
                             "Request ids must not collide)")
        return out

    def _enc_bucket(self, reqs: Sequence[Request], m: int) -> int:
        """Admission ``enc_len``: the serve's longest source rounded up to a
        multiple of ``m`` (``pad_to_multiple``), then to a power of two held
        monotone across serves on this engine (the reference's default
        bucketing; padding is masked)."""
        enc_len = max(r.n_src_tokens for r in reqs)
        enc_len = ((enc_len + m - 1) // m) * m
        self._enc_bucket_hwm = max(self._enc_bucket_hwm, next_pow2(enc_len))
        return self._enc_bucket_hwm

    @property
    def _max_pages(self) -> int:
        return self.max_len // self.page_size

    def _make_allocator(self, n_rows: int,
                        overcommit: float = 1.0) -> kvc.PageAllocator:
        """Page pool for one serve: ``n_pages`` from the constructor, or
        contiguous-equivalent capacity when unset.  ``overcommit`` scales
        the *virtual* reservation cap past the physical pool (preemption
        by page spill covers the gap)."""
        n_pages = self.n_pages or n_rows * self._max_pages
        return kvc.PageAllocator(n_pages, self.page_size,
                                 overcommit_limit=overcommit)

    def _initial_pages(self, req: Request, rows: int, hint: int) -> int:
        """Pages allocated at (re-)admission under overcommit: enough for
        what the request already decoded (its spill cursor when resuming)
        plus one burst of ``hint`` steps; growth covers the rest."""
        have = 0
        if req.spill is not None:
            have = int(np.max(req.spill.lengths))
        cap_tok = min(req.max_new_tokens, self.max_len)
        return rows * kvc.pages_per_row(min(have + hint, cap_tok),
                                        self.page_size)

    def _pages_per_request(self, req: Request, rows: int) -> int:
        """Worst-case reservation: the request's full decode budget, for
        each of its ``rows`` live rows (parked rows reserve nothing)."""
        return rows * kvc.pages_per_row(
            min(req.max_new_tokens, self.max_len), self.page_size)

    def _page_rows(self, reqs: Sequence[Request], rows_per_req: int,
                   n_req_rows: int, sentinel: int,
                   widths: Optional[Sequence[int]] = None) -> np.ndarray:
        """Admitted requests' page reservations as a host
        (n_req_rows × rows_per_req, maxP) int32 matrix, sentinel-padded:
        padding requests, parked rows (past ``widths[i]`` live rows) and
        each row's tail past its reservation."""
        out = np.full((n_req_rows * rows_per_req, self._max_pages), sentinel,
                      np.int32)
        for i, r in enumerate(reqs):
            live = widths[i] if widths is not None else rows_per_req
            flat = np.asarray(r.pages, np.int32)
            if flat.size == 0:
                continue
            per_row = flat.reshape(live, flat.size // live)
            out[i * rows_per_req:i * rows_per_req + live,
                :per_row.shape[1]] = per_row
        return out

    def _in_range_rows(self, rows: np.ndarray, n: int):
        """``kv_cache.in_range_rows`` as device index tensors."""
        keep, rows = kvc.in_range_rows(rows, n)
        return (torch.as_tensor(keep, device=self.device),
                torch.as_tensor(rows, device=self.device))

    def _splice_cross(self, state, sub, tokens, sub_tokens, slots):
        """The non-cache half of a side-batch splice: cross K/V (in place),
        source lengths and current tokens of ``slots``."""
        keep, rows = self._in_range_rows(slots, tokens.shape[0])
        out = dict(state)
        out["cross_k"][:, rows] = sub["cross_k"][:, keep].to(
            out["cross_k"].dtype)
        out["cross_v"][:, rows] = sub["cross_v"][:, keep].to(
            out["cross_v"].dtype)
        out["src_lengths"] = state["src_lengths"].index_put(
            (rows,), sub["src_lengths"][keep].to(torch.int32))
        return out, tokens.index_put((rows,), sub_tokens[keep])

    def _insert_rows(self, state, sub, tokens, sub_tokens, slots):
        """Splice a prefilled side batch into the running decode state;
        ``slots`` entries ≥ n_slots are padding and dropped."""
        out, tokens = self._splice_cross(state, sub, tokens, sub_tokens,
                                         slots)
        out["cache"] = kvc.insert_at_slots(state["cache"], sub["cache"],
                                           slots)
        return out, tokens

    def _insert_rows_paged(self, state, sub, tokens, sub_tokens, slots,
                           pages):
        """Paged ``_insert_rows``: the contiguous side-batch rows are cut
        into the destination rows' page reservations (``pages``,
        sentinel-padded) and the block tables installed alongside."""
        out, tokens = self._splice_cross(state, sub, tokens, sub_tokens,
                                         slots)
        out["cache"] = kvc.insert_rows_paged(state["cache"], sub["cache"],
                                             slots, pages)
        return out, tokens

    def _prefill_padded(self, src_rows: np.ndarray, len_rows: np.ndarray):
        """Prefill a side batch padded to a power-of-two width (padding rows
        replay row 0 and are dropped by the splice).  Returns
        ``(logits, sub_state, width)``."""
        src_rows, len_rows, width = pad_rows_pow2(src_rows, len_rows)
        sub = self._new_state(width)
        logits, sub = self.model.prefill(
            self.params, self._device_batch({"src_tokens": src_rows,
                                             "src_lengths": len_rows}),
            sub, quant=self.quant)
        return logits, sub, width

    def _splice_rows(self, state, tokens, sub, sub_tokens, rows: np.ndarray,
                     width: int, pages: Optional[np.ndarray] = None):
        """Splice the first ``len(rows)`` rows of a prefilled side batch at
        ``rows``; its padding rows get the out-of-range destination
        ``n_slots``.  ``pages`` (paged cache): (width, maxP) reservations."""
        slots = np.full((width,), tokens.shape[0], np.int32)
        slots[:len(rows)] = rows
        if pages is not None:
            return self._insert_rows_paged(state, sub, tokens, sub_tokens,
                                           slots, pages)
        return self._insert_rows(state, sub, tokens, sub_tokens, slots)

    def _free_released(self, state, rows):
        """Sentinel the paged tables of rows released during unfused
        admission.  Their pages went back to the allocator, and the rows
        step on until refilled: their writes must go to the sink, not into
        pages a later admission is handed.  The reference frees them only
        when they are refilled, so its paged tokens can differ from its
        contiguous ones here; the port's cannot.  Contiguous rows
        own their slabs and need nothing."""
        if not self.paged or not len(rows):
            return state
        state = dict(state)
        state["cache"] = kvc.free_slots_paged(state["cache"],
                                              np.asarray(rows, np.int32))
        return state

    # ------------------------------------------------------------ prefix cache
    def _ensure_prefix_cache(self) -> PrefixCache:
        """The engine-lifetime prefix cache and its chain pool on the
        device: two (L, prefix_pages, ps, HKV, dh) tensors in the
        *activation* dtype, not the decode cache's (possibly int8) one.  A
        chain must read back bit-identical to a fresh ``encode_cross_kv``,
        and an INT8 round trip would break the token identity.  Pool
        writes go in place, so the pool lives here across serves."""
        if self._prefix_cache_obj is None:
            self._prefix_cache_obj = PrefixCache(
                kvc.PageAllocator(self.prefix_pages, self.page_size))
            cfg = self._full_model.cfg
            shape = (cfg.n_layers, self.prefix_pages, self.page_size,
                     cfg.n_kv_heads, cfg.hd)
            self._prefix_pool = self._shard_state(tuple(
                torch.zeros(shape, dtype=cfg.activation_dtype,
                            device=self.device) for _ in range(2)))
        return self._prefix_cache_obj

    def _resolve_prefix_cache(self, prefix_cache: Optional[bool]
                              ) -> Optional[PrefixCache]:
        use = (self.prefix_cache_default if prefix_cache is None
               else bool(prefix_cache))
        return self._ensure_prefix_cache() if use else None

    def _pool_insert(self, cross_k, cross_v, pages) -> None:
        """Scatter encoded cross K/V into reserved chain pages (host
        ``pages`` (W, maxPP), sentinel rows drop)."""
        pool_k, pool_v = self._prefix_pool
        kvc.insert_chain_pages(pool_k, cross_k, pages)
        kvc.insert_chain_pages(pool_v, cross_v, pages)

    def _seed_bos(self, tokens, base_rows, group: int):
        """BOS (id 0) into the ``group`` rows of each in-range base row:
        the next burst's first step is those rows' prefill step."""
        _, rows = self._in_range_rows(kvc.group_rows(base_rows, group),
                                      tokens.shape[0])
        return tokens.index_put((rows,), torch.zeros_like(tokens[rows]))

    def _hit_splice(self, state, tokens, hit_pages, hit_lens, hit_rows,
                    group: int, dec_pages):
        """Splice cached chains into the hit rows, with no encoder: gather
        them from the pool (host ``hit_pages`` (W, maxPP)) and splice like
        a fresh encode (paged: ``dec_pages`` reservations), then seed BOS,
        so the rows' first token comes from the next burst, as in fused
        admission."""
        enc_len = state["cross_k"].shape[2]
        pool_k, pool_v = self._prefix_pool
        hk = kvc.gather_chain_pages(pool_k, hit_pages, enc_len)
        hv = kvc.gather_chain_pages(pool_v, hit_pages, enc_len)
        state = self.model.splice_prefill(
            state, hk, hv, torch.as_tensor(hit_lens, device=self.device),
            hit_rows, group=group, pages=dec_pages)
        return state, self._seed_bos(tokens, hit_rows, group)

    def _admission_prologue(self, state, tokens, live, plan, *,
                            pages=None, hit_pages=None, insert: bool = False,
                            group: int = 1):
        """Fused admission, run just before the round's burst:

        1. reset dead rows (cursor only on the contiguous cache; cursor and
           sentinel tables on the paged one, as their pages may be handed
           to the rows this splice admits);
        2. encode the plan's sources (the misses), once per request; with
           ``insert``, scatter the fresh cross K/V into the reserved chains
           (``plan.ins_pages``); splice them into their rows (each source
           into the ``group`` rows from its base row; paged: the rows'
           reservations ``pages``) and seed BOS, so the burst's first step
           is their BOS step;
        3. splice the prefix hits (``plan.hit_*``) from the pool, with no
           encoder (paged: reservations ``hit_pages``).  The scatter of (2)
           comes first, so a source admitted twice in one round reads the
           pages its sibling wrote moments before.

        Base rows ≥ the row count are padding and are dropped.
        """
        state = dict(state)
        free = kvc.free_inactive_paged if self.paged else kvc.free_inactive
        state["cache"] = free(state["cache"], live)
        if plan.width:
            ck, cv, slens = self.model.encode_cross_kv(
                self.params, self._device_batch(
                    {"src_tokens": plan.src_tokens,
                     "src_lengths": plan.src_lengths}), quant=self.quant)
            if insert:
                self._pool_insert(ck, cv, plan.ins_pages)
            state = self.model.splice_prefill(state, ck, cv, slens,
                                              plan.base_rows, group=group,
                                              pages=pages)
            tokens = self._seed_bos(tokens, plan.base_rows, group)
        if plan.hit_width:
            state, tokens = self._hit_splice(
                state, tokens, plan.hit_pages, plan.hit_lengths,
                plan.hit_rows, group, hit_pages)
        return state, tokens

    # ------------------------------------------------- preempt-by-page-spill
    @staticmethod
    def _to_host(parts) -> List[Optional[np.ndarray]]:
        """Copy device tensors (None entries kept) to host numpy arrays in
        one transfer, bit for bit; bfloat16 comes back as its ``uint16``
        bit pattern (numpy has no bfloat16)."""
        live = [p.contiguous().reshape(-1).view(torch.uint8)
                for p in parts if p is not None]
        host = torch.cat(live).cpu().numpy()
        out, i = [], 0
        for p in parts:
            if p is None:
                out.append(None)
                continue
            n = p.numel() * p.element_size()
            dt = (np.uint16 if p.dtype == torch.bfloat16 else
                  torch.empty((), dtype=p.dtype).numpy().dtype)
            out.append(host[i:i + n].copy().view(dt).reshape(tuple(p.shape)))
            i += n
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Inverse of :meth:`_to_host` for one array."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if a.dtype == np.uint16:
            t = t.view(torch.bfloat16)
        return t.to(self.device)

    def _spill(self, state, tokens, rows: np.ndarray) -> List:
        """Gather ``rows`` of the paged decode state to the host in one
        transfer: each row's pages linearized into its logical
        ``(L, W, cap, …)`` view (INT8 payload and scales verbatim, no
        requantization), then cursors, current tokens, cross K/V and
        source lengths.  Junk past each cursor rides along and is masked on
        restore like any partially filled row.  The live state is not
        changed."""
        cache = state["cache"]
        P, cap = cache.n_pages, cache.capacity
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        tb = cache.block_tables[r].long().clamp(0, P - 1)

        def lin(pool):
            if pool is None:
                return None
            got = pool[:, tb]                       # (L, W, maxP, ps, …)
            return got.reshape((pool.shape[0], len(rows), cap)
                               + tuple(pool.shape[3:]))

        # the stores hold the sink page past the pool; ``tb`` never reads it
        return self._to_host([
            lin(cache.k_store), lin(cache.v_store), lin(cache.ks_store),
            lin(cache.vs_store), cache.lengths[r], tokens[r],
            state["cross_k"][:, r], state["cross_v"][:, r],
            state["src_lengths"][r]])

    def _resume(self, state, tokens, rows: np.ndarray, pages: np.ndarray,
                sp: SpilledRequest):
        """Splice a spill back into ``rows``: its logical rows become a
        contiguous side batch that re-enters through the paged splice
        admission uses (``kv_cache.insert_rows_paged``, into the fresh
        reservations ``pages``), with the cross K/V, source lengths and
        current tokens written alongside, so a resumed request cannot be
        told from one that was never preempted."""
        dev = self._to_device
        opt = lambda a: None if a is None else dev(a)
        sub = kvc.KVCache(k=dev(sp.k), v=dev(sp.v), k_scale=opt(sp.k_scale),
                          v_scale=opt(sp.v_scale), lengths=dev(sp.lengths))
        out = dict(state)
        out["cache"] = kvc.insert_rows_paged(state["cache"], sub, rows,
                                             pages)
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        out["cross_k"][:, r] = dev(sp.cross_k).to(out["cross_k"].dtype)
        out["cross_v"][:, r] = dev(sp.cross_v).to(out["cross_v"].dtype)
        out["src_lengths"] = state["src_lengths"].index_put(
            (r,), dev(sp.src_lengths).to(torch.int32))
        return out, tokens.index_put((r,), dev(sp.tokens_row).to(
            tokens.dtype))

    def _grow(self, state, rows: np.ndarray, upd: np.ndarray):
        """Install freshly allocated page ids into ``rows``' tables.
        ``upd``: host (len(rows), maxP) int32, -1 = keep.  A new entry goes
        into both ``block_tables`` and ``own_pages``: a grown slot is owned
        by construction, the copy-on-write invariant of every paged beam
        reorder."""
        cache = state["cache"]
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        u = torch.as_tensor(np.asarray(upd, np.int32), device=self.device)
        grow = lambda t: t.index_put((r,), torch.where(u >= 0, u, t[r]))
        out = dict(state)
        out["cache"] = dataclasses.replace(
            cache, block_tables=grow(cache.block_tables),
            own_pages=grow(cache.own_pages))
        return out

    def _check_overload_args(self, overcommit: float,
                             prefill_chunk: Optional[int], chaos,
                             fused_admission: bool) -> None:
        if overcommit < 1.0:
            raise ValueError(f"overcommit must be >= 1.0, got {overcommit}")
        if overcommit > 1.0 and not self.paged:
            raise ValueError("overcommit needs the paged KV cache "
                             "(preempt-by-page-spill backs it)")
        if chaos is not None and not self.paged:
            raise ValueError("chaos preemption needs the paged KV cache "
                             "(spill and restore move pages)")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, "
                                 f"got {prefill_chunk}")
            if not fused_admission:
                raise ValueError("prefill_chunk requires fused_admission "
                                 "(staged encodes ride the fused rounds)")

    def serve(self, requests: Sequence[Any], *, n_slots: int = 8,
              max_new_tokens: Union[int, Sequence[int]] = 64,
              prefill_token_budget: Optional[int] = None,
              admit_min_free: int = 1,
              pad_to_multiple: int = 8,
              burst_len: Optional[Union[int, str]] = None,
              beam: Optional[Union[int, Sequence[int]]] = None,
              alpha: float = 0.6,
              fused_admission: bool = True,
              prefix_cache: Optional[bool] = None,
              overcommit: float = 1.0,
              prefill_chunk: Optional[int] = None,
              chaos: Optional[ChaosSchedule] = None,
              speculative_k: Optional[int] = None) -> ServeResult:
        """Continuous batching over a request stream.

        ``requests`` may be ``Sentence``s, raw token arrays or ``Request``
        objects (which carry their own ``max_new_tokens``); submission
        order is arrival order.  All ``n_slots`` rows share one decode
        burst of up to ``burst_len`` steps; at each burst edge finished
        rows are released and refilled, in queue order, from the waiting
        requests.  Greedy decode is token-identical to per-request
        :meth:`generate` for every ``burst_len``, fused or unfused,
        contiguous or paged (on the CPU; on the card, PERF.md §6 counts
        the equal requests).

        ``beam`` switches to continuous beam search (:meth:`_serve_beam`):
        each request takes a group of ``beam`` rows, and its ``tokens`` are
        the winning hypothesis under the ``alpha`` length penalty.
        ``beam`` may also be a per-request sequence (mixed widths).

        ``fused_admission=False`` runs each admission round as a separate
        prefill plus a first-token drain (``prefill_dispatches`` counts
        them); the token streams are the same.  ``burst_len="auto"`` lets
        :class:`AdaptiveBurst` move the step cap between bursts; the
        tokens are the same.

        As in the reference: ``prefill_token_budget`` caps the source
        row-tokens a round admits (the scheduler's token budget);
        ``admit_min_free`` is admission hysteresis (a round waits until
        that many slot groups are free, or as many as there are waiting
        requests); ``pad_to_multiple`` rounds the admission ``enc_len``
        before its power-of-two bucket.

        ``prefix_cache`` (None: the engine's default) shares encoded
        sources across requests and serves: an admission whose source
        exactly matches a cached one skips the encoder and splices the
        cached cross-K/V chain; a miss caches its encode.  The tokens are
        those of a cold-cache serve.

        Overload (the paged cache only; the tokens stay those of an
        unloaded serve): ``overcommit > 1`` admits past the worst-case
        page reservation (virtual, capped at ``overcommit × n_pages``),
        allocates one burst's pages at admission and grows rows between
        bursts; when growth or a more urgent admission comes up short, a
        victim is preempted by page spill and resumes later.  ``chaos``
        (``chaos.ChaosSchedule``) forces preemptions and synthetic slow
        rounds (``StepWatchdog``) at round edges.

        ``prefill_chunk`` (fused admission only): a source longer than
        that many tokens is staged, its encode spread over the following
        rounds, one width-1 encoder layer a round, and spliced in with BOS
        when the last layer is done; its row sits idle meanwhile.  A staged
        source bypasses the prefix cache, and a preempted stage is dropped
        and restaged.  The tokens are those of an unchunked serve.

        ``speculative_k=k`` (greedy only) decodes in self-speculative
        macro-steps (:meth:`_spec_burst`): ``decode_steps`` counts
        macro-steps, and ``draft_tokens``, ``accepted_tokens`` and
        ``acceptance_rate`` report the drafts; the tokens are those of
        plain greedy serving.

        A model without ``encode_cross_kv`` (the decoder-only and the
        recurrent families) raises ``NotImplementedError``: the reference
        has no such ``serve`` either.
        """
        if getattr(self.model, "recurrent", False):
            raise NotImplementedError(
                f"serve() is not available for {type(self.model).__name__}: "
                f"{_RECURRENT_SERVE}")
        if not hasattr(self.model, "encode_cross_kv"):
            raise NotImplementedError(
                f"serve() needs an encoder-decoder model; "
                f"{type(self.model).__name__} runs generate and "
                "generate_beam only, as in the reference, and ROADMAP "
                "Queue 1 holds no decoder-only serve")
        if beam is not None and speculative_k:
            raise ValueError("speculative decoding is greedy-only; beam and "
                             "speculative_k cannot combine")
        self._check_overload_args(overcommit, prefill_chunk, chaos,
                                  fused_admission)
        spec = self._check_speculative(speculative_k)
        admission = dict(prefill_token_budget=prefill_token_budget,
                         admit_min_free=admit_min_free,
                         pad_to_multiple=pad_to_multiple,
                         burst_len=burst_len,
                         fused_admission=fused_admission,
                         prefix_cache=prefix_cache, overcommit=overcommit,
                         prefill_chunk=prefill_chunk, chaos=chaos)
        if beam is not None:
            return self._serve_beam(requests, n_slots=n_slots, beam=beam,
                                    alpha=alpha,
                                    max_new_tokens=max_new_tokens,
                                    **admission)
        return self._serve_greedy(requests, n_slots=n_slots,
                                  max_new_tokens=max_new_tokens,
                                  speculative_k=spec, **admission)

    def _check_budgets(self, reqs: Sequence[Request]) -> None:
        if max(r.max_new_tokens for r in reqs) > self.max_len:
            raise ValueError("a request's max_new_tokens exceeds the "
                             f"engine KV capacity {self.max_len}")

    def _serve_allocator(self, n_rows: int, reqs: Sequence[Request],
                         rows_of, overcommit: float
                         ) -> Optional[kvc.PageAllocator]:
        """The serve's page pool (None unpaged), refusing a request whose
        reservation (``rows_of(r)`` live rows) exceeds the whole pool."""
        if not self.paged:
            return None
        allocator = self._make_allocator(n_rows, overcommit)
        for r in reqs:
            need = self._pages_per_request(r, rows_of(r))
            if need > allocator.n_pages:
                raise ValueError(f"request {r.req_id} needs {need} pages "
                                 f"but the pool holds {allocator.n_pages}")
        return allocator

    def _serve_greedy(self, requests: Sequence[Any], *, n_slots: int,
                      max_new_tokens: Union[int, Sequence[int]],
                      prefill_token_budget: Optional[int],
                      admit_min_free: int, pad_to_multiple: int,
                      burst_len: Optional[Union[int, str]],
                      fused_admission: bool, prefix_cache: Optional[bool],
                      overcommit: float, prefill_chunk: Optional[int],
                      chaos: Optional[ChaosSchedule],
                      speculative_k: int) -> ServeResult:
        """Greedy continuous batching: one row per request
        (``engine.py:1787-2261`` of the reference).

        Each round: the round edge of :class:`_ServeRun` (chaos, growth,
        admission-driven preemption), then admission (resumed requests
        re-spliced from their spill, prefix hits from the chain pool,
        long sources staged, misses encoded), the burst (plain, or
        speculative macro-steps), its drain, and one layer of every staged
        encode.  A round with only staged encodes to run skips the burst.
        """
        spec = speculative_k
        mult = spec + 1     # KV positions a step (macro-step) may append
        K = self._resolve_burst(burst_len)
        ctrl = self._burst_controller(K)
        reqs = self._as_requests(requests, max_new_tokens)
        if not reqs:
            return ServeResult(requests=[], n_slots=n_slots, decode_steps=0,
                               busy_slot_steps=0, prefill_rounds=0,
                               wall_s=0.0, burst_len=ctrl.k if ctrl else K,
                               fused_admission=fused_admission,
                               auto_burst=ctrl is not None,
                               paged=self.paged, page_size=self.page_size,
                               speculative_k=spec,
                               **self._mesh_result_fields(n_slots))
        self._check_budgets(reqs)
        enc_len = self._enc_bucket(reqs, pad_to_multiple)
        # under speculation a macro-step appends up to spec + 1 positions,
        # so the page reach of a burst scales by that
        run = _ServeRun(
            self, reqs, n_rows=n_slots, group=1, width=lambda r: 1,
            cursor=lambda slot, r: len(r.tokens),
            burst_hint=(ctrl.max_burst if ctrl else K) * mult,
            enc_len=enc_len, prefill_token_budget=prefill_token_budget,
            prefix_cache=prefix_cache, overcommit=overcommit,
            prefill_chunk=prefill_chunk, chaos=chaos)
        sched, pc, now = run.sched, run.pc, run.now
        decode_steps = busy_slot_steps = prefill_rounds = host_syncs = 0
        prefill_dispatches = encoder_tokens = peak_running = round_idx = 0
        draft_tokens = accepted_tokens = 0

        def prefill_into_slots(admitted) -> None:
            """Unfused admission: prefill a side batch (caching the encodes
            routed "insert"), splice it in, and drain its first tokens."""
            src_pad, lens = pad_batch([r.src for r in admitted],
                                      length=enc_len)
            logits, sub, width = self._prefill_padded(src_pad, lens)
            first = torch.argmax(logits, dim=-1).to(torch.int32)
            if pc is not None and any(r.prefix_role == "insert"
                                      for r in admitted):
                self._pool_insert(sub["cross_k"], sub["cross_v"],
                                  sched.chain_pages_matrix(admitted, width,
                                                           enc_len))
            run.state, run.tokens = self._splice_rows(
                run.state, run.tokens, sub, first,
                np.asarray([r.slot for r in admitted], np.int32), width,
                pages=run.page_rows(admitted, width))
            first_host = first.cpu().numpy()[:len(admitted)]
            t = now()
            released = []
            for r, tok in zip(admitted, first_host):
                r.first_token_s = t
                tok = int(tok)
                if r.max_new_tokens <= 0 or tok == self.eos_id:
                    released.append(sched.release(r, t, step=decode_steps))
                else:
                    r.tokens.append(tok)
                    if r.max_new_tokens <= 1:
                        released.append(sched.release(r, t,
                                                      step=decode_steps))
            run.state = self._free_released(run.state, released)

        while not sched.all_done:
            rnd = round_idx
            round_idx += 1
            run.round_edge(rnd, (ctrl.k if ctrl else K) * mult)
            plan = None
            want_admit = (sched.n_waiting and sched.n_free >=
                          min(max(admit_min_free, 1), sched.n_waiting,
                              n_slots))
            if want_admit and fused_admission:
                plan = sched.plan_admission(now(), step=decode_steps,
                                            enc_len=enc_len, oob_row=n_slots)
                if plan.n_admitted:
                    prefill_rounds += 1
                encoder_tokens += (len(plan.requests)
                                   + len(plan.staged)) * enc_len
                run.restore(plan.resumed)
                run.stage(plan.staged)
            elif want_admit:
                admitted = sched.admit(now(), step=decode_steps)
                if admitted:
                    prefill_rounds += 1
                    enc_list, hits = run.split_unfused(admitted)
                    if enc_list:
                        prefill_dispatches += 1
                        host_syncs += 1       # the first-token drain
                        encoder_tokens += len(enc_list) * enc_len
                        prefill_into_slots(enc_list)
                    run.splice_hits(hits)
            peak_running = max(peak_running, sched.n_running)
            if not sched.slot_map:
                continue        # every admitted request finished on token 1

            # every occupied slot has ≥ 1 token left to emit; a staged slot
            # holds no KV yet and rides the burst at budget 0 (the fused
            # prologue treats it as dead)
            remaining = np.zeros((n_slots,), np.int32)
            for slot, req in sched.slot_map.items():
                if slot not in run.staging:
                    remaining[slot] = req.max_new_tokens - len(req.tokens)
            if not remaining.any() and not (
                    plan is not None and (plan.width or plan.hit_width)):
                run.advance_staging()       # a pure-staging round
                continue
            cap = min(ctrl.k if ctrl else K, int(remaining.max()))
            t_dispatch = time.perf_counter()
            remaining_dev = torch.as_tensor(remaining, device=self.device)
            if plan is not None:
                run.prologue(plan, remaining_dev > 0)
            burst = (functools.partial(self._spec_burst, spec=spec) if spec
                     else self._greedy_burst)
            run.tokens, _, run.state, buf, live = burst(
                run.tokens, remaining_dev, cap, run.state)
            buf_host, steps = self._drain(buf, live)
            steps = int(steps)
            burst_wall = time.perf_counter() - t_dispatch
            host_syncs += 1                           # one drain per burst
            step_base = decode_steps
            decode_steps += steps

            # release at EOS / budget exhaustion; latencies are observed at
            # the burst edge, finish steps exactly
            t = now()
            freed = []
            wasted_row_steps = 0
            emit = cap * mult               # first counter column (spec)
            for slot, req in list(sched.slot_map.items()):
                if slot in run.staging:
                    # its ring columns are masked EOS, not output
                    wasted_row_steps += steps
                    continue
                if req.first_token_s is None:
                    req.first_token_s = t   # fused: emitted by this burst
                if spec:
                    # rows emit ragged counts: drain by the emitted
                    # counter, count busy and wasted in live macro-steps,
                    # and release at burst granularity
                    for tok in buf_host[slot, :buf_host[slot, emit]]:
                        tok = int(tok)
                        if tok == self.eos_id:
                            freed.append(sched.release(
                                req, t, step=step_base + steps))
                            break
                        req.tokens.append(tok)
                        if len(req.tokens) >= req.max_new_tokens:
                            freed.append(sched.release(
                                req, t, step=step_base + steps))
                            break
                    act = int(buf_host[slot, emit + 3])
                    busy_slot_steps += act
                    wasted_row_steps += steps - act
                    draft_tokens += int(buf_host[slot, emit + 1])
                    accepted_tokens += int(buf_host[slot, emit + 2])
                    continue
                used = steps
                for s in range(steps):
                    tok = int(buf_host[slot, s])
                    if tok == self.eos_id:
                        used = s + 1
                        freed.append(sched.release(req, t,
                                                   step=step_base + s + 1))
                        break
                    req.tokens.append(tok)
                    if len(req.tokens) >= req.max_new_tokens:
                        used = s + 1
                        freed.append(sched.release(req, t,
                                                   step=step_base + s + 1))
                        break
                busy_slot_steps += used
                wasted_row_steps += steps - used
            if ctrl:
                ctrl.observe(burst_wall, steps, wasted_row_steps, n_slots)
            run.observe(rnd, burst_wall)
            if freed and (not fused_admission or run.eager_free):
                # fused rounds otherwise reset dead rows in the next
                # prologue
                run.free(freed)
            # after the drain: a stage admitted this round runs its first
            # layer now but never rides this round's burst
            run.advance_staging()

        return ServeResult(
            requests=reqs, n_slots=n_slots, decode_steps=decode_steps,
            busy_slot_steps=busy_slot_steps, prefill_rounds=prefill_rounds,
            wall_s=now(), host_syncs=host_syncs + run.store.spill_events,
            burst_len=ctrl.k if ctrl else K,
            prefill_dispatches=prefill_dispatches,
            encoder_tokens=encoder_tokens, fused_admission=fused_admission,
            auto_burst=ctrl is not None, speculative_k=spec,
            draft_tokens=draft_tokens, accepted_tokens=accepted_tokens,
            **run.result_fields(reqs, peak_running),
            **self._mesh_result_fields(n_slots))

    # ------------------------------------------------- continuous beam search
    def _beam_widths(self, reqs: Sequence[Request], beam
                     ) -> Tuple[Dict[int, int], int]:
        """Each request's beam width, by ``req_id``, and the grid's group
        width (their largest).  A ``beam`` sequence wins, then a request's
        own ``Request.beam``, then the scalar ``beam``; the caller's
        ``Request`` objects are never written."""
        if isinstance(beam, (list, tuple, np.ndarray)):
            seq = [int(b) for b in beam]
            if len(seq) != len(reqs):
                raise ValueError(f"beam sequence length {len(seq)} != "
                                 f"{len(reqs)} requests")
            width_of = {r.req_id: b for r, b in zip(reqs, seq)}
            default = max(seq) if seq else 1
        else:
            default = int(beam)
            if default < 1:
                raise ValueError(f"beam must be ≥ 1, got {default}")
            width_of = {r.req_id: (int(r.beam) if r.beam is not None
                                   else default) for r in reqs}
        for r in reqs:
            if width_of[r.req_id] < 1:
                raise ValueError(f"beam must be ≥ 1, got "
                                 f"{width_of[r.req_id]} (request "
                                 f"{r.req_id})")
        return width_of, max(list(width_of.values()) + [default])

    def _serve_beam(self, requests: Sequence[Any], *, n_slots: int,
                    beam: Union[int, Sequence[int]], alpha: float,
                    max_new_tokens: Union[int, Sequence[int]],
                    prefill_token_budget: Optional[int],
                    admit_min_free: int, pad_to_multiple: int,
                    burst_len: Optional[Union[int, str]],
                    fused_admission: bool, prefix_cache: Optional[bool],
                    overcommit: float, prefill_chunk: Optional[int],
                    chaos: Optional[ChaosSchedule]) -> ServeResult:
        """Continuous beam search (``engine.py:2264-2942``).

        A request is admitted into a group of ``beam`` contiguous rows.
        Unfused, its source is prefilled tiled over the group (as
        ``generate_beam`` tiles its batch) and its first ``beam`` tokens
        come from one top-k over the group's beam-0 log-probs, taken on
        the host.  Fused, the source is encoded once and broadcast over the
        group, whose scores are seeded ``[0, BEAM_SEED_NEG, …]``: the
        burst's first beam step is then ``generate_beam``'s first step.
        Each burst runs :meth:`_beam_serve_burst`; at its edge the host
        replays each group's composed beam permutation over its token
        history, appends the new ring columns, and once the group's budget
        is spent or all its rows have finished, picks the winner and
        releases the group.  Scores and finished masks go to the device and
        back every burst, bit for bit (``_drain``).

        Mixed widths: the grid's groups are as wide as the widest request,
        and a narrower request runs only the first ``beam_req`` rows of its
        group; the rest are parked (``_beam_step``), so each step is a
        ``beam_req``-wide beam step.  On the paged cache, parked rows
        reserve no pages.

        The prefix cache and the overload machinery work on whole groups:
        a hit splices its chain over the group's rows and seeds it as fused
        admission does; a preemption spills all ``beam`` rows and the
        group's host search state (scores, finished, history, budget
        left), and a resume restores both.  A staged group (chunked
        prefill) stays frozen, finished at budget 0, until its encode is
        spliced in, and is then seeded as fused admission seeds it.
        """
        reqs = self._as_requests(requests, max_new_tokens)
        width_of, beam = self._beam_widths(reqs, beam)
        K = self._resolve_burst(burst_len)
        ctrl = self._burst_controller(K)
        n_groups = n_slots // beam
        if n_groups < 1:
            raise ValueError(f"n_slots={n_slots} rows cannot hold a "
                             f"beam-{beam} group")
        R = n_groups * beam                 # rows in the grid
        if not reqs:
            return ServeResult(requests=[], n_slots=R, decode_steps=0,
                               busy_slot_steps=0, prefill_rounds=0,
                               wall_s=0.0, burst_len=ctrl.k if ctrl else K,
                               beam=beam, fused_admission=fused_admission,
                               auto_burst=ctrl is not None,
                               paged=self.paged, page_size=self.page_size,
                               **self._mesh_result_fields(R))
        self._check_budgets(reqs)
        enc_len = self._enc_bucket(reqs, pad_to_multiple)
        # host-side per-row beam state, sent up and drained every burst
        scores_np = np.zeros((R,), np.float32)
        finished_np = np.ones((R,), bool)        # unoccupied rows are inert
        histories: Dict[int, List[np.ndarray]] = {}  # base → (beam,) columns
        budget_left: Dict[int, int] = {}             # base → steps left

        def save_search(base: int) -> dict:
            """A preempted group's host search state; its rows go inert."""
            out = {"scores": scores_np[base:base + beam].copy(),
                   "finished": finished_np[base:base + beam].copy(),
                   "history": histories.pop(base, []),
                   "budget_left": budget_left.pop(base, 0)}
            finished_np[base:base + beam] = True
            return out

        def load_search(base: int, saved: dict) -> None:
            """A resumed group's host search state, verbatim."""
            scores_np[base:base + beam] = saved["scores"]
            finished_np[base:base + beam] = saved["finished"]
            histories[base] = list(saved["history"])
            budget_left[base] = saved["budget_left"]

        run = _ServeRun(
            self, reqs, n_rows=R, group=beam,
            width=lambda r: width_of[r.req_id],
            cursor=lambda base, r: r.max_new_tokens - budget_left[base],
            burst_hint=ctrl.max_burst if ctrl else K, enc_len=enc_len,
            prefill_token_budget=prefill_token_budget,
            prefix_cache=prefix_cache, overcommit=overcommit,
            prefill_chunk=prefill_chunk, chaos=chaos,
            save=save_search, load=load_search,
            seed=lambda r: seed_group(r, r.max_new_tokens))
        sched, allocator, pc, now = run.sched, run.allocator, run.pc, run.now
        # bytes one beam step's reorder moves: paged, the table permutation
        # and one page a row; contiguous, the whole KV slab and cross K/V
        if self.paged:
            reorder_step_bytes = run.state["cache"].reorder_bytes_per_step()
        else:
            ck = run.state["cross_k"]
            reorder_step_bytes = (run.state["cache"].nbytes()
                                  + 2 * ck.numel() * ck.element_size())
        decode_steps = busy_slot_steps = prefill_rounds = host_syncs = 0
        prefill_dispatches = encoder_tokens = peak_running = round_idx = 0

        def seed_group(req: Request, budget: int) -> None:
            """A fused admission's search state: row 0 at score 0, the
            other rows at ``BEAM_SEED_NEG``, parked rows finished."""
            base, b = req.slot, width_of[req.req_id]
            scores_np[base] = 0.0
            scores_np[base + 1:base + beam] = BEAM_SEED_NEG
            finished_np[base:base + b] = False
            finished_np[base + b:base + beam] = True
            histories[base] = []
            budget_left[base] = budget

        def finalize(req: Request, base: int, t: float, step: int) -> int:
            """The group's winner among the request's own rows, then its
            release (returns the freed base row)."""
            b = width_of[req.req_id]
            grid = np.stack(histories.pop(base), axis=1)[:b]   # (b, T)
            toks, score = self._winner(grid, scores_np[base:base + b],
                                       alpha, self.eos_id)
            req.tokens = [int(x) for x in toks]
            req.score = score
            budget_left.pop(base, None)
            finished_np[base:base + beam] = True
            return sched.release(req, t, step=step)

        def prefill_groups(admitted) -> None:
            """Unfused admission: prefill the sources tiled ``beam×``
            (caching the encodes routed "insert" from each group's first
            row), splice the groups in, and take each group's first
            ``beam`` tokens on the host (the first-token drain)."""
            g = len(admitted)
            rows = g * beam
            src_pad, lens = pad_batch([r.src for r in admitted],
                                      length=enc_len)
            logits, sub, width = self._prefill_padded(
                np.repeat(src_pad, beam, axis=0),
                np.repeat(lens, beam, axis=0))
            if pc is not None and any(r.prefix_role == "insert"
                                      for r in admitted):
                self._pool_insert(sub["cross_k"], sub["cross_v"],
                                  sched.chain_pages_matrix(
                                      admitted, width, enc_len, stride=beam))
            lp = torch.log_softmax(logits.to(torch.float32),
                                   dim=-1).cpu().numpy()
            first = lp[:rows].reshape(g, beam, -1)[:, 0]     # (g, V)
            # a stable argsort of the negated log-probs is top-k: values
            # descending, ties toward the lower index
            tok_host = np.argsort(-first, axis=-1,
                                  kind="stable")[:, :beam].astype(np.int32)
            sc_host = np.take_along_axis(first, tok_host, axis=-1)
            for i, r in enumerate(admitted):
                b = width_of[r.req_id]          # parked rows: EOS, floor
                tok_host[i, b:] = self.eos_id
                sc_host[i, b:] = BEAM_SEED_NEG
            sub_np = np.full((width,), self.eos_id, np.int32)
            sub_np[:rows] = tok_host.reshape(rows)
            pages = None
            if allocator:
                pages = np.full((width, self._max_pages), allocator.n_pages,
                                np.int32)
                pages[:rows] = run.page_rows(admitted, g)
            run.state, run.tokens = self._splice_rows(
                run.state, run.tokens, sub,
                torch.as_tensor(sub_np, device=self.device),
                kvc.group_rows([r.slot for r in admitted], beam), width,
                pages=pages)
            t = now()
            released = []
            for i, r in enumerate(admitted):
                base, b = r.slot, width_of[r.req_id]
                r.first_token_s = t
                if r.max_new_tokens <= 0:
                    finished_np[base:base + beam] = True
                    released.append(sched.release(r, t, step=decode_steps))
                    continue                     # zero budget: empty output
                scores_np[base:base + beam] = sc_host[i]
                fin = tok_host[i] == self.eos_id
                fin[b:] = True
                finished_np[base:base + beam] = fin
                histories[base] = [tok_host[i].copy()]
                budget_left[base] = r.max_new_tokens - 1
                if fin.all() or budget_left[base] <= 0:
                    released.append(finalize(r, base, t, step=decode_steps))
            run.state = self._free_released(
                run.state, kvc.group_rows(released, beam))

        while not sched.all_done:
            rnd = round_idx
            round_idx += 1
            run.round_edge(rnd, ctrl.k if ctrl else K)
            plan = None
            want_admit = (sched.n_waiting and sched.n_free >=
                          min(max(admit_min_free, 1), sched.n_waiting,
                              n_groups))
            if want_admit and fused_admission:
                plan = sched.plan_admission(now(), step=decode_steps,
                                            enc_len=enc_len, oob_row=R)
                if plan.n_admitted:
                    prefill_rounds += 1
                encoder_tokens += (len(plan.requests)
                                   + len(plan.staged)) * enc_len
                run.restore(plan.resumed)
                run.stage(plan.staged)
                for r in plan.requests + plan.hits:
                    seed_group(r, r.max_new_tokens)
            elif want_admit:
                admitted = sched.admit(now(), step=decode_steps)
                if admitted:
                    prefill_rounds += 1
                    enc_list, hits = run.split_unfused(admitted)
                    if enc_list:
                        prefill_dispatches += 1
                        host_syncs += 1       # the first-token drain
                        # the side batch tiles each source beam× through
                        # the encoder
                        encoder_tokens += len(enc_list) * beam * enc_len
                        prefill_groups(enc_list)
                    # no encoder: splice the chains over each group and
                    # seed it as fused admission does
                    run.splice_hits(hits)
                    for r in hits:
                        seed_group(r, r.max_new_tokens)
            peak_running = max(peak_running, sched.n_running)
            if not sched.slot_map:
                continue        # every admitted group finished on token 1

            # a staged group holds no KV yet: budget 0, rows finished
            remaining_in = np.zeros((n_groups,), np.int32)
            parked_np = np.zeros((R,), bool)
            for base, req in sched.slot_map.items():
                if base in run.staging:
                    continue
                remaining_in[base // beam] = budget_left[base]
                parked_np[base + width_of[req.req_id]:base + beam] = True
            if not remaining_in.any() and not (
                    plan is not None and (plan.width or plan.hit_width)):
                run.advance_staging()       # a pure-staging round
                continue
            cap = ctrl.k if ctrl else K
            t_dispatch = time.perf_counter()
            dev = lambda a: torch.as_tensor(a, device=self.device)
            remaining_dev = dev(remaining_in)
            if plan is not None:
                run.prologue(plan,
                             (remaining_dev > 0).repeat_interleave(beam))
            (run.tokens, scores, finished, remaining, comp, run.state, buf,
             live) = self._beam_serve_burst(
                beam, run.tokens, dev(scores_np), dev(finished_np),
                remaining_dev, min(cap, int(remaining_in.max())), run.state,
                dev(parked_np))
            (buf_host, comp_host, scores_np, finished_np, remaining_out,
             steps) = self._drain(buf, comp, scores, finished, remaining,
                                  live)
            scores_np = scores_np.copy()
            finished_np = finished_np.astype(bool)
            steps = int(steps)
            burst_wall = time.perf_counter() - t_dispatch
            host_syncs += 1                           # one drain per burst
            step_base = decode_steps
            decode_steps += steps

            # replay each group's composed permutation over its history,
            # append its new ring columns, finalize the groups that finished
            # or spent their budget
            t = now()
            freed = []
            wasted_row_steps = 0
            for base, req in list(sched.slot_map.items()):
                if base in run.staging:
                    wasted_row_steps += steps * beam    # frozen rows
                    continue
                gi = base // beam
                s_g = int(remaining_in[gi] - remaining_out[gi])
                if req.first_token_s is None:
                    req.first_token_s = t   # fused: emitted by this burst
                if s_g:
                    local = comp_host[base:base + beam] - base
                    hist = [c[local] for c in histories[base]]
                    hist.extend(buf_host[base:base + beam, j]
                                for j in range(s_g))
                    histories[base] = hist
                    budget_left[base] -= s_g
                # parked rows of a narrow request are computed but idle
                b_req = width_of[req.req_id]
                busy_slot_steps += s_g * b_req
                wasted_row_steps += (steps - s_g) * beam + \
                    s_g * (beam - b_req)
                if finished_np[base:base + beam].all() or \
                        budget_left[base] <= 0:
                    freed.append(finalize(req, base, t,
                                          step=step_base + s_g))
            if ctrl:
                ctrl.observe(burst_wall, steps, wasted_row_steps, R)
            run.observe(rnd, burst_wall)
            if freed and (not fused_admission or run.eager_free):
                # fused rounds otherwise reset dead rows in the next
                # prologue
                run.free(freed)
            run.advance_staging()

        return ServeResult(
            requests=reqs, n_slots=R, decode_steps=decode_steps,
            busy_slot_steps=busy_slot_steps, prefill_rounds=prefill_rounds,
            wall_s=now(), host_syncs=host_syncs + run.store.spill_events,
            burst_len=ctrl.k if ctrl else K, beam=beam,
            prefill_dispatches=prefill_dispatches,
            encoder_tokens=encoder_tokens, fused_admission=fused_admission,
            auto_burst=ctrl is not None,
            reorder_bytes=reorder_step_bytes * decode_steps,
            **run.result_fields(reqs, peak_running),
            **self._mesh_result_fields(R))


class _ServeRun:
    """One serve's scheduler, page pool, prefix cache and decode state, and
    the admission and overload machinery the greedy and the beam loop
    share: chaos victims, page growth, preemption by spill, resume, prefix
    hits and the fused prologue.

    A request holds ``group`` contiguous rows from its base row, of which
    ``width(req)`` are live (greedy: 1 of 1); ``cursor(base, req)`` is a
    running request's decode position.  Beam serving passes ``save`` and
    ``load``, which carry a group's host search state through a spill, and
    ``seed``, which seeds a group whose staged encode was just spliced in.
    The loops read and write the device state as ``state`` and ``tokens``.

    ``staging`` maps the base row of each request whose encode is staged
    (chunked prefill) to its progress; such a request holds its rows and
    pages but decodes nothing until :meth:`advance_staging` splices it in.
    """

    def __init__(self, eng: "ServingEngine", reqs: Sequence[Request], *,
                 n_rows: int, group: int, width, cursor, burst_hint: int,
                 enc_len: int, prefill_token_budget: Optional[int],
                 prefix_cache: Optional[bool], overcommit: float,
                 prefill_chunk: Optional[int],
                 chaos: Optional[ChaosSchedule], save=None, load=None,
                 seed=None):
        self.eng, self.n_rows, self.group = eng, n_rows, group
        self.enc_len = enc_len
        self.width, self.cursor = width, cursor
        self.save, self.load, self.seed = save, load, seed
        self.overcommit, self.chaos = overcommit, chaos
        self.n_tries = n_rows // group + len(reqs)
        self.pc = eng._resolve_prefix_cache(prefix_cache)
        self.stats0 = self.pc.stats.snapshot() if self.pc else None
        alloc = self.allocator = eng._serve_allocator(n_rows, reqs, width,
                                                      overcommit)
        # overcommit: admission allocates one burst's pages; the round edge
        # grows rows and preempts by spill under pressure
        self.overcommitted = alloc is not None and overcommit > 1.0
        self.sched = ContinuousScheduler(
            n_rows, group_size=group,
            prefill_token_budget=prefill_token_budget, allocator=alloc,
            pages_per_request=(
                (lambda r: eng._pages_per_request(r, width(r)))
                if alloc else None),
            prefix_cache=self.pc,
            initial_pages=(
                (lambda r: eng._initial_pages(r, width(r), burst_hint))
                if self.overcommitted else None),
            prefill_chunk=prefill_chunk)
        self.sched.submit_many(reqs)
        self.state = eng._new_state(
            n_rows, enc_len=enc_len, paged=eng.paged,
            page_size=eng.page_size,
            n_pages=alloc.n_pages if alloc else None)
        self.tokens = torch.zeros((n_rows,), dtype=torch.int32,
                                  device=eng.device)
        self.store, self.watchdog = SpillStore(), StepWatchdog()
        self.preemptions = 0        # a spill is one device→host transfer
        self.staging: Dict[int, Dict[str, Any]] = {}
        self.chunked_admissions = self.chunk_rounds = 0
        # with growth, preemption or staging, freed pages can be handed to
        # other rows before the next fused prologue (a round that only
        # stages runs none): free dead rows at once
        self.eager_free = (overcommit > 1.0 or chaos is not None
                           or prefill_chunk is not None)
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def rows_of(self, base: int) -> np.ndarray:
        return np.arange(base, base + self.group, dtype=np.int32)

    def page_rows(self, reqs: Sequence[Request],
                  n_reqs: int) -> Optional[np.ndarray]:
        """``reqs``' page reservations, padded to ``n_reqs`` requests
        (``ServingEngine._page_rows``); None on the contiguous cache."""
        if self.allocator is None:
            return None
        return self.eng._page_rows(reqs, self.group, n_reqs,
                                   self.allocator.n_pages,
                                   widths=[self.width(r) for r in reqs])

    # ------------------------------------------------------------ admission
    def prologue(self, plan, live: torch.Tensor) -> None:
        """Fused admission's device half (``_admission_prologue``), when
        the round encodes or hits anything; ``live`` (rows,) bool."""
        if not (plan.width or plan.hit_width):
            return
        self.state, self.tokens = self.eng._admission_prologue(
            self.state, self.tokens, live, plan,
            pages=self.page_rows(plan.requests, plan.width)
            if plan.width else None,
            hit_pages=self.page_rows(plan.hits, plan.hit_width)
            if plan.hit_width else None,
            insert=self.pc is not None, group=self.group)

    def split_unfused(self, admitted: List[Request]
                      ) -> Tuple[List[Request], List[Request]]:
        """An unfused round's admissions: resumed requests are re-spliced
        from their spill at once; the fresh ones split into those to encode
        and the prefix hits.  Zero budgets skip the routing: they release
        at their first-token drain, before any chain could pair."""
        fresh = [r for r in admitted if r.spill is None]
        self.restore([r for r in admitted if r.spill is not None])
        if self.pc is None:
            return fresh, []
        misses, hits = self.sched.assign_prefix(
            [r for r in fresh if r.max_new_tokens > 0])
        return misses + [r for r in fresh if r.max_new_tokens <= 0], hits

    def splice_hits(self, hits: List[Request]) -> None:
        """Unfused prefix hits: their chains spliced from the pool over
        their rows, with no encoder."""
        if not hits:
            return
        hrows, hlens, hpages, hw = self.sched.shape_hits(
            hits, enc_len=self.enc_len, oob_row=self.n_rows)
        self.state, self.tokens = self.eng._hit_splice(
            self.state, self.tokens, hpages, hlens, hrows, self.group,
            self.page_rows(hits, hw))

    # ------------------------------------------------------ chunked prefill
    def stage(self, staged: List[Request]) -> None:
        """Start the staged encodes of a round's long sources."""
        for r in staged:
            self.staging[r.slot] = {"req": r, "x": None, "li": 0}
        self.chunked_admissions += len(staged)

    def advance_staging(self) -> None:
        """One width-1 encoder layer for every staged encode
        (``engine.py:1976-2007``, ``:2579-2616``).  A stage whose last
        layer is done is spliced into its rows as fused admission splices
        (paged: into the request's page reservation) and seeded with BOS,
        so the request decodes from the next burst on."""
        eng, model = self.eng, self.eng.model
        for base, st in list(self.staging.items()):
            req = st["req"]
            if st["x"] is None:
                src = np.zeros((1, self.enc_len), np.int32)
                src[0, :req.n_src_tokens] = req.src
                st["lens"] = torch.as_tensor([req.n_src_tokens],
                                             dtype=torch.int32,
                                             device=eng.device)
                st["x"] = model.encode_staged_begin(
                    eng.params, {"src_tokens": torch.as_tensor(
                        src, device=eng.device)})
            st["x"] = model.encode_staged_layer(
                eng.params, st["x"], st["li"], src_lengths=st["lens"],
                quant=eng.quant)
            st["li"] += 1
            self.chunk_rounds += 1
            if st["li"] < model.cfg.n_enc_layers:
                continue
            ck, cv, slens = model.encode_staged_finish(
                eng.params, st["x"], src_lengths=st["lens"], quant=eng.quant)
            bases = np.asarray([base], np.int32)
            self.state = model.splice_prefill(
                self.state, ck, cv, slens, bases, group=self.group,
                pages=self.page_rows([req], 1))
            self.tokens = eng._seed_bos(self.tokens, bases, self.group)
            if self.seed:
                self.seed(req)
            del self.staging[base]

    def free(self, bases) -> None:
        """Reset the rows of released requests (paged: sentinel their
        tables too)."""
        free = kvc.free_slots_paged if self.eng.paged else kvc.free_slots
        self.state = dict(self.state)
        self.state["cache"] = free(self.state["cache"],
                                   kvc.group_rows(bases, self.group))

    # ------------------------------------------------------------- overload
    def round_edge(self, rnd: int, k_cap: int) -> None:
        """Before a round's admission: the chaos schedule's forced
        preemptions, then (overcommit) page growth of the running rows for
        the next ``k_cap`` steps and preemption of less urgent rows for the
        most urgent waiting request."""
        sched = self.sched
        if self.chaos is not None and sched.slot_map:
            by_id = {r.req_id: r for r in sched.slot_map.values()}
            for rid in self.chaos.victims_for(rnd, list(by_id)):
                self.preempt(by_id[rid])
        if self.overcommitted:
            self.grow(k_cap)
            self.preempt_for_admission()

    def observe(self, rnd: int, burst_wall: float) -> None:
        """A burst's wall time (plus the chaos schedule's synthetic slow
        time) into the step watchdog."""
        self.watchdog.observe(burst_wall + (self.chaos.slow_for(rnd)
                                            if self.chaos else 0.0))

    def preempt(self, req: Request) -> None:
        """Spill one running request (its ``group`` rows, and with
        ``save`` its host search state) to the host and evict it.  A staged
        request holds nothing worth saving: its stage is dropped, and it
        restages on re-admission."""
        base = req.slot
        rows = self.rows_of(base)
        if self.staging.pop(base, None) is None:
            k, v, ks, vs, lens, toks, ck, cv, slens = self.eng._spill(
                self.state, self.tokens, rows)
            req.spill = SpilledRequest(
                req_id=req.req_id, n_rows=self.group, k=k, v=v, k_scale=ks,
                v_scale=vs, lengths=lens, tokens_row=toks, cross_k=ck,
                cross_v=cv, src_lengths=slens, n_pages=len(req.pages or []),
                beam=self.save(base) if self.save else None)
            self.store.put(req.spill)
        self.sched.preempt(req, self.now())
        self.preemptions += 1
        # sentinel the victim's tables now: the next burst's masked writes
        # would otherwise land in pages growth or a resume may already have
        # handed on
        self.state = dict(self.state)
        self.state["cache"] = kvc.free_slots_paged(self.state["cache"], rows)

    def restore(self, resumed: List[Request]) -> None:
        """Splice spilled payloads into the rows just admitted, into their
        fresh page reservations (with ``load``, the host search state
        too)."""
        for req in resumed:
            sp = req.spill
            self.state, self.tokens = self.eng._resume(
                self.state, self.tokens, self.rows_of(req.slot),
                self.page_rows([req], 1), sp)
            if self.load:
                self.load(req.slot, sp.beam)
            self.store.pop(req.req_id)
            self.allocator.unspill(sp.n_pages)
            req.spill = None

    def grow(self, k_cap: int) -> None:
        """Pre-burst growth of overcommitted requests: each live row gets
        pages for its cursor plus the next ``k_cap`` steps (parked rows
        reserve none)."""
        eng, sched = self.eng, self.sched
        for base, req in list(sched.slot_map.items()):
            if sched.slot_map.get(base) is not req or base in self.staging:
                continue           # a victim of an earlier growth this round,
                                   # or a stage that holds no KV yet
            b = self.width(req)
            cap_tok = min(req.max_new_tokens, eng.max_len)
            need = kvc.pages_per_row(min(self.cursor(base, req) + k_cap,
                                         cap_tok), eng.page_size)
            have = len(req.pages) // b
            extra = need - have
            if extra <= 0:
                continue
            newp = self.alloc_growth(req, extra * b)
            upd = np.full((self.group, eng._max_pages), -1, np.int32)
            for i in range(b):
                upd[i, have:have + extra] = newp[i * extra:(i + 1) * extra]
            # a group's flat page list is interleaved from here on: only its
            # length (growth) and its release read it, and a resume
            # allocates afresh
            req.pages.extend(newp)
            self.state = eng._grow(self.state, self.rows_of(base), upd)

    @staticmethod
    def _pages_held(req: Request) -> int:
        return len(req.pages or [])

    def alloc_growth(self, req: Request, n: int) -> List[int]:
        """``n`` pages for ``req``'s growth, preempting the least urgent
        other running requests while the pool is dry.  A row that cannot
        grow cannot take its next step, so a need that no set of victims
        covers fails before anything is spilled."""
        allocator, sched = self.allocator, self.sched
        pages = allocator.alloc(n)
        while pages is None:
            victims, covered = pick_victims(
                [r for r in sched.slot_map.values() if r is not req],
                pages_needed=n - allocator.n_free, key_fn=sched.victim_key,
                pages_held_fn=self._pages_held)
            if not victims or not covered:
                raise RuntimeError(
                    "page growth wedged: no preemptable victim set covers "
                    f"request {req.req_id}'s need ({n} pages)")
            for v in victims:
                self.preempt(v)
            pages = allocator.alloc(n)
        return pages

    def preempt_for_admission(self) -> None:
        """Free pages for the most urgent waiting request by preempting
        strictly less urgent running ones, and only when that lets it in
        (equal urgency never evicts, so requests cannot evict each other in
        turn)."""
        sched = self.sched
        for _ in range(self.n_tries):
            short = sched.admission_shortfall()
            if short is None:
                return
            victims, covered = pick_victims(
                list(sched.slot_map.values()),
                pages_needed=max(short["pages_short"], 1),
                key_fn=sched.victim_key, pages_held_fn=self._pages_held,
                min_key=short["head_key"])
            if not victims or not covered:
                return
            for v in victims:
                self.preempt(v)

    # --------------------------------------------------------------- result
    def result_fields(self, reqs: Sequence[Request],
                      peak_running: int) -> Dict[str, Any]:
        """ServeResult fields of the page pool, the overload machinery and
        the prefix cache (per-serve deltas of its persistent stats)."""
        alloc, sched, eng = self.allocator, self.sched, self.eng
        misses = len(sched.rejected) + sum(
            1 for r in reqs
            if (r.status == "finished" and r.deadline_s is not None
                and r.finish_s is not None and r.finish_s > r.deadline_s))
        out = dict(
            paged=eng.paged, page_size=eng.page_size,
            pages_in_use=alloc.in_use if alloc else 0,
            page_hwm=alloc.hwm if alloc else 0,
            overcommit=self.overcommit,
            preemptions=self.preemptions,
            spill_events=self.store.spill_events,
            restore_events=self.store.restore_events,
            spilled_bytes=self.store.spilled_bytes,
            straggler_rounds=len(self.watchdog.straggler_steps),
            chunked_admissions=self.chunked_admissions,
            chunk_rounds=self.chunk_rounds,
            peak_running=peak_running,
            rejected=len(sched.rejected),
            deadline_misses=misses,
            free_lwm=alloc.free_lwm if alloc else 0,
            fragmentation=alloc.fragmentation if alloc else 0.0)
        pc, s0 = self.pc, self.stats0
        if pc is not None:
            s = pc.stats
            out.update(prefix_cache=True,
                       prefix_hits=s.hits - s0.hits,
                       prefix_misses=s.misses - s0.misses,
                       prefix_inserts=s.inserts - s0.inserts,
                       prefix_evictions=s.evictions - s0.evictions,
                       prefix_hit_pages=s.hit_pages - s0.hit_pages,
                       prefix_pages_allocated=(s.pages_allocated
                                               - s0.pages_allocated),
                       prefix_chains=pc.n_chains)
        return out
