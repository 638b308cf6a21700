"""Data substrate: synthetic corpus, ordering and bin packing (paper §5.4),
the training pipeline, BLEU."""

from repro_torch.data.metrics import corpus_bleu  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    LMBatches,
    Prefetcher,
    TranslationBatches,
)
from repro_torch.data.sorting import (  # noqa: F401
    make_batches,
    next_pow2,
    order_indices,
    pack_batches_token_budget,
    padding_stats,
)
from repro_torch.data.synthetic import (  # noqa: F401
    BOS,
    EOS,
    PAD,
    Sentence,
    make_corpus,
    pad_batch,
    reference_translation,
)
