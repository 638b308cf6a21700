"""Input-pipeline sentence ordering + bin packing (paper §5.4–§5.6).

The paper: batching unsorted variable-length sentences wastes compute on pad
tokens; sorting by **token** count beats sorting by **word** count by 28%
throughput.  Port of ``repro/data/sorting.py``: the three orders, the
padding-waste accounting, and the first-fit-decreasing **token-budget
bin-packer** that sets the continuous serving driver's admission order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


def pack_batches_token_budget(
    sentences: Sequence[Sentence],
    token_budget: int,
    *,
    max_rows: Optional[int] = None,
) -> List[List[int]]:
    """First-fit-decreasing bin packing to a padded-token budget.

    A bin holding rows of token lengths ``lens`` costs
    ``max(lens) * len(lens)`` padded tokens.  Sentences are placed
    longest-first into the first bin whose grid stays ≤ ``token_budget``
    (and, optionally, whose row count stays ≤ ``max_rows``).  A sentence
    longer than the whole budget gets its own bin; every index appears in
    exactly one bin.
    """
    if token_budget <= 0:
        raise ValueError(f"token_budget must be positive, got {token_budget}")
    order = order_indices(sentences, "tokens")
    bins: List[List[int]] = []
    bin_max: List[int] = []
    for i in order:
        t = sentences[i].n_tokens
        for b in range(len(bins)):
            mx = max(bin_max[b], t)
            if mx * (len(bins[b]) + 1) <= token_budget and (
                    max_rows is None or len(bins[b]) < max_rows):
                bins[b].append(int(i))
                bin_max[b] = mx
                break
        else:
            bins.append([int(i)])
            bin_max.append(t)
    return bins


def padding_stats(sentences: Sequence[Sentence],
                  batches: List[List[int]]) -> dict:
    """Fraction of the padded token grid wasted on PAD (lower = better)."""
    total_padded = 0
    total_real = 0
    per_batch_max = []
    for b in batches:
        lens = [sentences[i].n_tokens for i in b]
        mx = max(lens)
        per_batch_max.append(mx)
        total_padded += mx * len(b)
        total_real += sum(lens)
    return {
        "padded_tokens": total_padded,
        "real_tokens": total_real,
        "pad_waste": 1.0 - total_real / max(total_padded, 1),
        "mean_batch_len": float(np.mean(per_batch_max)),
    }
