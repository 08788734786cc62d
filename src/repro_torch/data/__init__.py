"""Deterministic synthetic data: LM batches and vector corpora with
interval attributes."""
from repro_torch.data.synthetic import (CorpusConfig, LMDataConfig, host_slice, lm_batch,
                                        lm_batches, make_corpus, make_queries)

__all__ = ["CorpusConfig", "LMDataConfig", "host_slice", "lm_batch", "lm_batches",
           "make_corpus", "make_queries"]
