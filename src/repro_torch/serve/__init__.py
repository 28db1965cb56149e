"""Serving (counterpart of ``repro.serve``): the batched, cached, sharded
and durable ``QueryService``, the PQ-approximated LM head, the decode loop
that drives it (``ServeSession``, ``greedy_generate``), and the
cross-process cluster tier in ``serve.cluster``."""

from .hybrid_head import HybridHeadParams, HybridLMHead  # noqa: F401
from .query_service import (CacheInfo, JitCacheInfo,  # noqa: F401
                            QueryService, bucket_for)
from .serving import ServeSession, greedy_generate  # noqa: F401

__all__ = ["HybridLMHead", "HybridHeadParams", "QueryService", "CacheInfo",
           "JitCacheInfo", "bucket_for", "ServeSession", "greedy_generate"]
