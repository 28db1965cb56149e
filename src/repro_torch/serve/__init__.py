"""Serving (counterpart of ``repro.serve``): the batched, cached, sharded
and durable ``QueryService``, the PQ-approximated LM head, and the
cross-process cluster tier in ``serve.cluster``.  The decode loop that
consumes the head is not ported yet (ROADMAP A9a)."""

from .hybrid_head import HybridHeadParams, HybridLMHead  # noqa: F401
from .query_service import (CacheInfo, JitCacheInfo,  # noqa: F401
                            QueryService, bucket_for)

__all__ = ["HybridLMHead", "HybridHeadParams", "QueryService", "CacheInfo",
           "JitCacheInfo", "bucket_for"]
