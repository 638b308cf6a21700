"""Synthetic translation corpus (laptop-scale stand-in for WMT En→De).

The paper evaluates on newstest2014 (3003 sentences).  We generate a
deterministic "translation" task a transformer-base-family model can learn
in a few hundred steps, so the Table-1 accuracy experiments (BLEU drop per
quantization mode) are reproducible end-to-end on CPU:

* source sentences are sequences of *words*; each word is 1–3 subword
  *tokens* (so word-count and token-count sorting — paper §5.4 — genuinely
  differ; words are metadata only);
* the target maps every source token through a fixed affine permutation of
  the vocabulary (order preserved) — a deterministic cross-attention
  copy+substitute task a small model learns in a few hundred steps, so the
  Table-1 BLEU-drop experiments run end-to-end on CPU.

Special tokens: PAD=0, BOS=1, EOS=2; content ids start at 3.

The port's own copy of ``repro/data/synthetic.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2
SPECIALS = 3


@dataclasses.dataclass(frozen=True)
class Sentence:
    src: np.ndarray            # (S,) int32 source tokens (no BOS/EOS)
    tgt: np.ndarray            # (T,) int32 target tokens
    n_words: int

    @property
    def n_tokens(self) -> int:
        return int(len(self.src))


def _map_token(tok: np.ndarray, vocab: int) -> np.ndarray:
    content = vocab - SPECIALS
    return (tok - SPECIALS) * 7 % content + SPECIALS  # 7 coprime w/ content


def make_corpus(
    n_sentences: int,
    vocab: int,
    *,
    min_words: int = 2,
    max_words: int = 24,
    seed: int = 0,
) -> List[Sentence]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sentences):
        n_words = int(rng.integers(min_words, max_words + 1))
        words = []
        for _ in range(n_words):
            w_len = int(rng.integers(1, 4))
            words.append(rng.integers(SPECIALS, vocab, size=w_len,
                                      dtype=np.int64))
        src = np.concatenate(words).astype(np.int32)
        tgt = _map_token(src, vocab).astype(np.int32)
        out.append(Sentence(src=src, tgt=tgt, n_words=n_words))
    return out


def reference_translation(src: np.ndarray, vocab: int) -> np.ndarray:
    return _map_token(np.asarray(src), vocab).astype(np.int32)


def pad_batch(seqs: List[np.ndarray], *, add_bos: bool = False,
              add_eos: bool = False, length: int | None = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad to the batch max (or ``length``). Returns (tokens, lengths)."""
    extra = int(add_bos) + int(add_eos)
    lens = np.asarray([len(s) + extra for s in seqs], np.int32)
    L = int(length if length is not None else lens.max())
    out = np.full((len(seqs), L), PAD, np.int32)
    for i, s in enumerate(seqs):
        row = list(s)
        if add_bos:
            row = [BOS] + row
        if add_eos:
            row = row + [EOS]
        out[i, :len(row)] = row
    return out, lens
