"""Request-scoped tracing (DESIGN.md §9.2).

One :class:`Span` per unit of work — a root span per search/mutation in
``QueryService`` and ``ClusterRouter``, child spans per RPC hop and per
micro-batch.  Spans carry:

* ``tags`` — numeric/str facts (``serialize_s``, ``score_s``, ``peer``,
  ``part``); ``add()`` accumulates floats so retries fold into one tag;
* ``annotations`` — ordered event strings (``"reconnect_resend"``,
  ``"term_fenced: ..."``, failover election notes);
* ``children`` — sub-spans, ended independently.

Wire propagation rides the cluster frame protocol's JSON meta line
(serve/cluster/protocol.py): ``span.wire_context()`` is a 2-key dict
``{"tid", "sid"}`` placed under ``meta["trace"]``; a shard server that
sees it builds its own child span via ``Tracer.from_wire`` and returns
the serialized result under ``rmeta["trace"]``, which the client folds
back in with ``Span.attach_remote``.  Requests without a ``trace`` key
cost the server nothing — server-side tracing is opt-in per request.

A span entered with ``with`` is also a ``torch.profiler.record_function``
range of its name, opened on enter and closed on exit (on one thread), so
inside a ``torch.profiler`` capture each such span is a ``user_annotation``
event on the trace's own clock.  A span used without ``with`` (RPC
children, ``attach_remote``, ``to_wire``) opens no range.  A child made by
``device_child`` also times the device: on CUDA it records an event on the
current stream at enter and at exit, and the pair becomes a ``device_s``
tag when its root ends (if the events have completed) or at
``Tracer.take()``; on the CPU, where the work is synchronous, ``device_s``
is the span's host duration.  A settled root holds no CUDA events.

The disabled path is the ``NULL_SPAN`` singleton: every method is a
no-op, ``child()`` and ``device_child()`` return itself,
``wire_context()`` returns None (so nothing is added to request meta),
and ``bool(NULL_SPAN)`` is False.  Instrumented code never branches on
"tracing on?" — it just talks to whatever span it was handed (DESIGN.md
§9.4).
"""

from __future__ import annotations

import collections
import os
import threading
import time

import torch

__all__ = ["Span", "Tracer", "NULL_SPAN", "NULL_TRACER", "stage_totals",
           "STAGES"]

# The per-hop stage vocabulary (DESIGN.md §9.2): tag names ending in
# ``_s`` on "rpc" child spans, plus "merge_s" on the root.
STAGES = ("serialize_s", "wire_s", "queue_s", "score_s", "merge_s")


def _new_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed unit of work in a trace tree.  Create roots via
    :meth:`Tracer.root`; children via :meth:`child`.  Usable as a
    context manager (``__exit__`` calls :meth:`end`)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "duration_s", "tags", "annotations", "children",
                 "_tracer", "_range", "_device", "_events")

    def __init__(self, name: str, *, trace_id: str | None = None,
                 parent_id: str | None = None, tracer=None, **tags):
        self.name = name
        self.trace_id = trace_id or _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start_s = time.perf_counter()
        self.duration_s = None
        self.tags = dict(tags)
        self.annotations: list[str] = []
        self.children: list[Span] = []
        self._tracer = tracer
        self._range = None
        self._device = None     # set by device_child
        self._events = None     # CUDA (start, end) events until settled

    def __bool__(self) -> bool:
        return True

    def set(self, key: str, value) -> None:
        """Set tag ``key`` to ``value`` (overwrites)."""
        self.tags[key] = value

    def add(self, key: str, dv: float) -> None:
        """Accumulate float ``dv`` into tag ``key`` (0-initialized)."""
        self.tags[key] = self.tags.get(key, 0.0) + dv

    def annotate(self, event: str) -> None:
        """Append an event string to this span's annotation log."""
        self.annotations.append(event)

    def child(self, name: str, **tags) -> "Span":
        """Start a child span (same trace id, parent = this span)."""
        c = Span(name, trace_id=self.trace_id, parent_id=self.span_id,
                 **tags)
        self.children.append(c)
        return c

    def device_child(self, name: str, device, **tags) -> "Span":
        """A child span that also times ``device``'s work between its enter
        and exit: its ``device_s`` tag (see the module docstring)."""
        c = self.child(name, **tags)
        c._device = torch.device(device)
        return c

    def wire_context(self) -> dict:
        """The propagation context carried in frame meta under
        ``"trace"``: the trace id plus this span's id as the remote
        parent."""
        return {"tid": self.trace_id, "sid": self.span_id}

    def attach_remote(self, rdict: dict | None) -> None:
        """Fold a server-serialized child span (``rmeta["trace"]`` from
        a shard reply — see ``Span.to_wire``) in as a child of this
        span.  None is ignored so callers can pass ``rmeta.get("trace")``
        unconditionally."""
        if not rdict:
            return
        c = self.child(rdict.get("name", "remote"))
        c.span_id = rdict.get("sid", c.span_id)
        c.duration_s = rdict.get("duration_s")
        for k, v in rdict.items():
            if k not in ("name", "sid", "duration_s", "annotations"):
                c.tags[k] = v
        c.annotations.extend(rdict.get("annotations", ()))

    def end(self) -> None:
        """Stop the clock (idempotent) and, for roots created by a
        tracer, settle the tree's device times that have completed and
        publish the finished trace into its ring."""
        if self.duration_s is None:
            self.duration_s = time.perf_counter() - self.start_s
            if self._device is not None and self._device.type != "cuda":
                self.tags["device_s"] = self.duration_s
        if self._tracer is not None:
            self._settle(wait=False)
            self._tracer._finish(self)
            self._tracer = None

    def _settle(self, wait: bool) -> None:
        """Turn each completed (start, end) event pair of the tree into a
        ``device_s`` tag and drop the events; ``wait`` waits for the
        pairs still pending."""
        todo = [self]
        while todo:
            s = todo.pop()
            todo += s.children
            ev = s._events
            if ev is None or len(ev) < 2:
                continue
            if not ev[1].query():
                if not wait:
                    continue
                ev[1].synchronize()
            s.tags["device_s"] = ev[0].elapsed_time(ev[1]) / 1e3
            s._events = None

    def _record(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        self._events.append(ev)

    def __enter__(self) -> "Span":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self._device is not None and self._device.type == "cuda":
            self._events = []
            self._record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._record()
        self._range.__exit__(*exc)
        self._range = None
        self.end()

    def to_wire(self) -> dict:
        """Compact JSON form a shard server returns under
        ``rmeta["trace"]``: span id + duration + tags + annotations.
        (Children are not shipped — shard-side work is one level deep.)"""
        self.end() if self.duration_s is None else None
        out = {"name": self.name, "sid": self.span_id,
               "duration_s": self.duration_s, **self.tags}
        if self.annotations:
            out["annotations"] = list(self.annotations)
        return out

    def to_dict(self) -> dict:
        """Full JSON form of the span tree rooted here."""
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "duration_s": self.duration_s, "tags": dict(self.tags),
                "annotations": list(self.annotations),
                "children": [c.to_dict() for c in self.children]}


class _NullSpan:
    """Shared no-op span: the zero-cost disabled path.  ``child()``
    returns itself; ``wire_context()`` is None so no trace key is added
    to request meta; falsy so rare non-hot code may branch on it."""

    __slots__ = ()
    name = "null"
    trace_id = span_id = parent_id = None
    duration_s = None
    tags: dict = {}
    annotations: list = []
    children: list = []

    def __bool__(self):
        return False

    def set(self, key, value):
        """No-op."""

    def add(self, key, dv):
        """No-op."""

    def annotate(self, event):
        """No-op."""

    def child(self, name, **tags):
        """Returns itself (children of a null span are null)."""
        return self

    def device_child(self, name, device, **tags):
        """Returns itself."""
        return self

    def wire_context(self):
        """None — nothing is propagated."""
        return None

    def attach_remote(self, rdict):
        """No-op."""

    def end(self):
        """No-op."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def to_wire(self):
        """None — a null span never serializes."""
        return None

    def to_dict(self):
        """None — a null span never serializes."""
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded ring of finished root traces.

    ``root(name)`` returns :data:`NULL_SPAN` when disabled, so the
    per-request cost of "tracing off" is one branch.  Finished roots
    (``span.end()``) land in a ``deque(maxlen=keep)``; ``take()``
    settles their pending device times and drains them as JSON dicts —
    how benchmarks source their span-based breakdowns (DESIGN.md
    §9.2)."""

    def __init__(self, *, enabled: bool = True, keep: int = 256):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._finished: collections.deque = collections.deque(maxlen=keep)

    def root(self, name: str, **tags):
        """Start a root span (or :data:`NULL_SPAN` when disabled)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(name, tracer=self, **tags)

    def from_wire(self, ctx: dict | None, name: str, **tags):
        """Server-side entry: a span whose trace id / parent come from a
        request's ``meta["trace"]`` context.  Returns :data:`NULL_SPAN`
        when the context is absent — per-request opt-in."""
        if not self.enabled or not ctx:
            return NULL_SPAN
        return Span(name, trace_id=ctx.get("tid"),
                    parent_id=ctx.get("sid"), **tags)

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._finished.append(span)

    def take(self) -> list[dict]:
        """Drain and return every finished root trace as a dict, waiting
        for the device times of roots that ended before their work."""
        with self._lock:
            spans = list(self._finished)
            self._finished.clear()
        for s in spans:
            s._settle(wait=True)
        return [s.to_dict() for s in spans]


NULL_TRACER = Tracer(enabled=False)


def _walk(node: dict):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


def stage_totals(traces: list[dict]) -> dict:
    """Aggregate per-stage seconds over a batch of finished trace dicts:
    sums every ``STAGES`` tag across every span of every tree.  This is
    the span-sourced replacement for the router's old ``hop_s``
    field-scraping — benchmarks call ``tracer.take()`` then this."""
    totals = {k: 0.0 for k in STAGES}
    for t in traces:
        for node in _walk(t):
            tags = node.get("tags", {})
            for k in STAGES:
                v = tags.get(k)
                if v is not None:
                    totals[k] += v
    return totals
