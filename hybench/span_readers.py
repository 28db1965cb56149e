"""The arithmetic behind the per-layer metrics that read the program's own
spans: the ``serve.*`` phases of a ``QueryService`` search and the
``engine.pass1``-``engine.pass3`` children of its dispatch, whose
``device_s`` tags the program takes from CUDA events around each pass.

Each reader takes the traced run's context as ``readers`` describes it
and reads only ``spans`` (the span trees finished in the stretch) and
``trace`` (the stretch's ``tracecalc.DeviceTrace``, in which each span the
program entered is a ``user_annotation`` host event of its name).  A
reader that finds nothing to read, as on a program that has no such
span, returns None.

``idle_in_service`` reads the spans' ranges in the trace, which a capture
holds only where the profiler records the thread that serves: the
harness's records the thread that starts it alone, so no metric file
reads it yet.
"""

from __future__ import annotations

from .costs import pass1_work


def _walk(node: dict):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


def _named(tree: dict, name: str) -> list:
    return [n for n in _walk(tree) if n.get("name") == name]


def _device_s(tree: dict, *names: str) -> list:
    """The ``device_s`` tags of the spans under ``tree`` named ``names``."""
    return [float(n["tags"]["device_s"]) for n in _walk(tree)
            if n.get("name") in names and "device_s" in n.get("tags", {})]


def _batches(ctx) -> list:
    return [b for t in ctx.get("spans") or () for b in _named(t,
                                                             "serve.batch")]


def pass1_roofline_live(ctx):
    """% of the device time of the stretch's pass 1s that their least time
    is: the least time of pass 1 at each ``serve.batch``'s rows
    (``costs.pass1_work``) over the ``device_s`` of its ``engine.pass1``
    spans, summed over the batches that have them."""
    least = spent = 0.0
    for b in _batches(ctx):
        dev = _device_s(b, "engine.pass1")
        if dev and b.get("tags", {}).get("rows"):
            least += pass1_work(ctx["shape"], int(b["tags"]["rows"])).least_s
            spent += sum(dev)
    if spent <= 0:
        return None
    return 100.0 * least / spent


def pass23_device_ms(ctx):
    """Mean over the stretch's ``serve.batch`` spans of the ``device_s`` of
    their ``engine.pass2`` and ``engine.pass3`` spans, ms."""
    per = [_device_s(b, "engine.pass2", "engine.pass3")
           for b in _batches(ctx)]
    per = [sum(v) for v in per if v]
    if not per:
        return None
    return 1e3 * sum(per) / len(per)


def host_ms(ctx):
    """Mean over the stretch's ``serve.search`` roots of their duration
    less their ``serve.dispatch`` and ``serve.wait`` spans, ms: the host's
    serial work a request (lookup, copies in, merge, fill)."""
    vals = []
    for t in ctx.get("spans") or ():
        if t.get("name") != "serve.search" or t.get("duration_s") is None:
            continue
        inner = _named(t, "serve.dispatch") + _named(t, "serve.wait")
        if not inner:
            continue
        vals.append(t["duration_s"] - sum(n["duration_s"] for n in inner))
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_in_service(ctx):
    """% of the stretch in which the device is idle while a
    ``serve.search`` range is open on the host: the stretch's idle
    intervals intersected with the union of its ``serve.search``
    annotations."""
    tr = ctx.get("trace")
    if tr is None or not tr.kernels() or tr.window_s <= 0:
        return None
    served = _union((max(s, tr.t0), min(e, tr.t1))
                    for s, e, name in tr.host if name == "serve.search")
    served = [iv for iv in served if iv[1] > iv[0]]
    if not served:
        return None
    busy = tr.busy_intervals()
    edges = [tr.t0] + [x for iv in busy for x in iv] + [tr.t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    both, i = 0.0, 0
    for s, e in idle:
        while i < len(served) and served[i][1] <= s:
            i += 1
        j = i
        while j < len(served) and served[j][0] < e:
            both += min(e, served[j][1]) - max(s, served[j][0])
            j += 1
    return 100.0 * both / (tr.t1 - tr.t0)
