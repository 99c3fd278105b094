"""Generative serving of the PyTorch port: the continuous-batching engine
(slot models, speculative decoding, paged models with the shared-prefix
prompt cache), its policy and the prefix cache."""

from .generative import (CacheSlotPool, GenerateFuture, GenerateRequest,
                         GenerativeEngine)
from .policy import BatchingPolicy, DecodePolicy
from .prefix_cache import PagesExhaustedError, PrefixCache

__all__ = [
    "BatchingPolicy", "CacheSlotPool", "DecodePolicy", "GenerateFuture",
    "GenerateRequest", "GenerativeEngine", "PagesExhaustedError",
    "PrefixCache",
]
