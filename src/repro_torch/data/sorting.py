"""Input-pipeline sentence ordering (paper §5.4).

The paper: batching unsorted variable-length sentences wastes compute on pad
tokens; sorting by **token** count beats sorting by **word** count by 28%
throughput.  Port of the ordering half of ``repro/data/sorting.py``
(``next_pow2``, ``order_indices``, ``make_batches``; the token-budget
bin-packer and padding statistics come with continuous serving).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.data.synthetic import Sentence


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (``n ≤ 1`` → 1): the reference's
    bucketing helper for batch widths and decode-burst lengths."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def order_indices(sentences: Sequence[Sentence], mode: str) -> np.ndarray:
    """mode: 'none' | 'words' | 'tokens' (descending, stable)."""
    n = len(sentences)
    if mode == "none":
        return np.arange(n)
    if mode == "words":
        keys = np.asarray([s.n_words for s in sentences])
    elif mode == "tokens":
        keys = np.asarray([s.n_tokens for s in sentences])
    else:
        raise ValueError(f"unknown sort mode {mode}")
    return np.argsort(-keys, kind="stable")


def make_batches(sentences: Sequence[Sentence], batch_size: int,
                 mode: str = "tokens") -> List[List[int]]:
    """Greedy fixed-size batches over the chosen ordering."""
    idx = order_indices(sentences, mode)
    return [list(idx[i:i + batch_size])
            for i in range(0, len(idx), batch_size)]
