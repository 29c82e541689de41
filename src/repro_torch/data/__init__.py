"""The training data: a deterministic synthetic corpus, by step."""
from .pipeline import DataConfig, PrefetchIterator, SyntheticLMStream
from .tokenizer import HashTokenizer, synthetic_document

__all__ = ["DataConfig", "HashTokenizer", "PrefetchIterator", "SyntheticLMStream",
           "synthetic_document"]
