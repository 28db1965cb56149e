"""The arithmetic behind the per-layer metric files in ``metrics/``.

Each reader takes the traced run's context: ``trace`` (a
``tracecalc.DeviceTrace`` of the stretch), ``spans`` (the program's span
trees finished in the stretch), ``requests`` (the harness's records of the
requests answered in it), ``cache`` (``QueryService.cache_info()`` at the
window's start and end), ``pass1_ms`` and ``pass1_rows`` (the CUDA-event
median of the program's pass 1 alone after the window) and ``shape`` (the
cell's ``costs.SearchShape``).  A reader that finds nothing to read
returns None.
"""

from __future__ import annotations

from .costs import pass1_work, search_work


def _batches(ctx) -> list:
    out = []

    def walk(node):
        if node.get("name") == "serve.batch":
            out.append(node.get("tags", {}))
        for c in node.get("children", ()):
            walk(c)

    for t in ctx.get("spans") or ():
        walk(t)
    return out


def _device(ctx):
    """The stretch's device trace, or None where it holds no kernel: a
    stretch of a served cell always runs some, so the capture failed."""
    tr = ctx["trace"]
    return tr if tr.kernels() and tr.window_s > 0 else None


def device_idle(ctx):
    """% of the stretch with no kernel, copy or fill on the device."""
    tr = _device(ctx)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def search_mfu(ctx):
    """% of the device's busy time that the searches served in the stretch
    would take at the chip's peak: their least time (``costs``) over the
    busy time."""
    tr = _device(ctx)
    batches = [b for b in _batches(ctx) if b.get("rows")]
    if tr is None or not batches:
        return None
    busy = tr.busy_s
    least = sum(search_work(ctx["shape"], int(b["rows"])).least_s
                for b in batches)
    return 100.0 * least / busy


def pass1_roofline(ctx):
    """% of pass 1's time at the largest bucket that its least time is."""
    ms = ctx.get("pass1_ms")
    if not ms:
        return None
    least = pass1_work(ctx["shape"], int(ctx["pass1_rows"])).least_s
    return 100.0 * least / (ms / 1e3)


def cache_hit_rate(ctx):
    """% of the window's row lookups that the result cache answered."""
    a, b = ctx["cache"]
    hits, misses = b.hits - a.hits, b.misses - a.misses
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)


def dispatch_ms(ctx):
    """Mean ``dispatch_s`` of the stretch's ``serve.batch`` spans, ms."""
    vals = [float(b["dispatch_s"]) for b in _batches(ctx)
            if "dispatch_s" in b]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)


def launches_per_request(ctx):
    """Kernels the device ran in the stretch over the requests answered
    in it."""
    n = len(ctx.get("requests") or ())
    tr = _device(ctx)
    if not n or tr is None:
        return None
    return tr.kernels() / n
