"""Corpus BLEU (the paper's accuracy metric, Table 1).

The port's own copy of ``repro/data/metrics.py``, unchanged.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np


def _ngrams(seq: Sequence[int], n: int) -> Counter:
    return Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def corpus_bleu(hypotheses: List[Sequence[int]],
                references: List[Sequence[int]], max_n: int = 4) -> float:
    """Standard corpus BLEU-4 with brevity penalty, on token ids."""
    assert len(hypotheses) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        hyp, ref = list(hyp), list(ref)
        hyp_len += len(hyp)
        ref_len += len(ref)
        for n in range(1, max_n + 1):
            h = _ngrams(hyp, n)
            r = _ngrams(ref, n)
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            clipped[n - 1] += sum(min(c, r[g]) for g, c in h.items())
    if min(totals) == 0 or min(clipped) == 0:
        return 0.0
    log_p = sum(math.log(clipped[i] / totals[i]) for i in range(max_n)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_p)
