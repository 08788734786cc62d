"""Synthetic vector corpora with interval attributes."""
from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries

__all__ = ["CorpusConfig", "make_corpus", "make_queries"]
