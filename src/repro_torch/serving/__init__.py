"""Synchronous weight-routed retrieval service over the device engine."""

from .batching import Batcher, ServiceConfig, merge_topk
from .retrieval import RetrievalResult, RetrievalService

__all__ = [
    "Batcher",
    "RetrievalResult",
    "RetrievalService",
    "ServiceConfig",
    "merge_topk",
]
