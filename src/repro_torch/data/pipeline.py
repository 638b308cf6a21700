"""Training/serving data pipeline: batching, padding, background prefetch,
and checkpointable iterator state (exact restart — fault tolerance).

The port's own copy of ``repro/data/pipeline.py`` (numpy only): the same
batches for the same seed, and the same resumable state.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch.data.sorting import make_batches
from repro_torch.data.synthetic import Sentence, pad_batch


class TranslationBatches:
    """Deterministic, resumable batch stream over a sentence corpus.

    State = (epoch, cursor); serializes into the training checkpoint so a
    restarted job continues on the exact next batch.
    """

    def __init__(self, sentences: Sequence[Sentence], batch_size: int,
                 *, sort_mode: str = "tokens", seed: int = 0,
                 pad_to_multiple: int = 8):
        self.sentences = list(sentences)
        self.batch_size = batch_size
        self.sort_mode = sort_mode
        self.seed = seed
        self.pad_to_multiple = pad_to_multiple
        self.epoch = 0
        self.cursor = 0
        self._plan: List[List[int]] = []
        self._replan()

    def _replan(self) -> None:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(len(self.sentences))
        shuffled = [self.sentences[i] for i in order]
        batches = make_batches(shuffled, self.batch_size, self.sort_mode)
        self._plan = [[int(order[j]) for j in b] for b in batches]

    # -- checkpointable state --------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor,
                "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self._replan()

    # -- iteration ----------------------------------------------------------
    def _round(self, n: int) -> int:
        m = self.pad_to_multiple
        return ((n + m - 1) // m) * m

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.cursor >= len(self._plan):
            self.epoch += 1
            self.cursor = 0
            self._replan()
        idx = self._plan[self.cursor]
        self.cursor += 1
        sents = [self.sentences[i] for i in idx]
        src_len = self._round(max(s.n_tokens for s in sents))
        tgt_len = self._round(max(len(s.tgt) for s in sents) + 2)
        src, src_lens = pad_batch([s.src for s in sents], length=src_len)
        tgt, tgt_lens = pad_batch([s.tgt for s in sents], add_bos=True,
                                  add_eos=True, length=tgt_len)
        return {
            "src_tokens": src, "src_lengths": src_lens,
            "tgt_tokens": tgt, "tgt_lengths": tgt_lens,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class LMBatches:
    """Next-token-prediction stream for decoder-only archs (smoke training)."""

    def __init__(self, vocab: int, batch_size: int, seq_len: int,
                 seed: int = 0):
        self.vocab, self.B, self.S = vocab, batch_size, seq_len
        self.seed = seed
        self.step = 0

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, s):
        self.seed, self.step = int(s["seed"]), int(s["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + self.step)
        self.step += 1
        # a learnable sequence task: tokens follow a noisy affine recurrence
        x = np.zeros((self.B, self.S + 1), np.int32)
        x[:, 0] = rng.integers(3, self.vocab, self.B)
        noise = rng.random((self.B, self.S)) < 0.1
        nxt = rng.integers(3, self.vocab, (self.B, self.S))
        for t in range(self.S):
            det = (x[:, t] * 5 + 7) % (self.vocab - 3) + 3
            x[:, t + 1] = np.where(noise[:, t], nxt[:, t], det)
        return {"tokens": x[:, :-1], "labels": x[:, 1:]}

    def __iter__(self):
        while True:
            yield self.next_batch()


class Prefetcher:
    """Background-thread prefetch so input never stalls the step (one of the
    straggler-mitigation pieces: host input jitter is hidden)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
