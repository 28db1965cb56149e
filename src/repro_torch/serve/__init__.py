"""Serving (counterpart of ``repro.serve``): the batched, cached, sharded
and durable ``QueryService``, and the cross-process cluster tier in
``serve.cluster``.  The PQ LM head and its decode loop are not ported yet
(ROADMAP queue A, the LM head)."""

from .query_service import QueryService, bucket_for  # noqa: F401

__all__ = ["QueryService", "bucket_for"]
