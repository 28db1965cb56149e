"""Profiling hooks (DESIGN.md §9.3): opt-in ``torch.profiler`` capture
around engine dispatch, plus per-pass time attribution; counterpart of
``repro.obs.profile``, which wraps ``jax.profiler``.

Where the reference degrades to a no-op without a profiler, here a
capture that was asked for (a ``log_dir`` given) either writes a trace or
raises.  ``pass_breakdown`` times with CUDA events on a CUDA engine (the
stream's time between two events) and with the host clock on a CPU one;
its ``timer`` key says which.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["profiler_available", "device_trace", "StepAnnotation",
           "pass_breakdown"]


def profiler_available() -> bool:
    """True when ``torch.profiler`` imports (a capture directory will
    actually receive a trace)."""
    try:
        import torch.profiler  # noqa: F401
    except ImportError:
        return False
    return True


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Context manager wrapping ``torch.profiler.profile`` around a region
    of engine dispatches; the trace is written to
    ``<log_dir>/trace-<pid>-<ns>.json`` (Chrome trace format) on exit.  A
    None ``log_dir`` (the default everywhere: profiling is opt-in) makes
    this a no-op.  CUDA activity is recorded when a card is present.  A
    trace that was asked for and not written raises ``RuntimeError``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"torch.profiler wrote an empty trace to {path}")


class StepAnnotation:
    """``torch.profiler.record_function``: names one engine dispatch inside
    a device trace so per-pass time is attributable in the captured
    timeline.  Keyword arguments (e.g. ``step_num``) ride along as the
    range's argument string."""

    def __init__(self, name: str, **kw):
        args = ",".join(f"{k}={v}" for k, v in sorted(kw.items())) or None
        self._inner = torch.profiler.record_function(name, args)

    def __enter__(self):
        self._inner.__enter__()
        return self

    def __exit__(self, *exc):
        return self._inner.__exit__(*exc)


def _seconds(fn, cuda: bool) -> float:
    """One timing of ``fn()``: CUDA events around it on the card
    (synchronised on the end event), the host clock on the CPU."""
    if cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def pass_breakdown(engine, q_dims, q_vals, q_dense, *, h: int,
                   alpha: int, beta: int, iters: int = 3) -> dict:
    """Per-pass time attribution for one engine + query batch: times the
    pass-1-only top-k (the scan the roofline models) against the full
    three-pass search and reports the pass-1 fraction (DESIGN.md §9.3).

    On a CUDA engine both are timed with CUDA events on the current
    stream, so a reading is the stream's time from the first launch to the
    last kernel's end (host gaps between launches included); on the CPU
    the host clock; the two are timed in turns.  Returns ``{"pass1_s",
    "full_s", "pass23_s", "pass1_fraction", "iters", "backend", "timer"}``
    (best of ``iters`` seconds; ``timer`` is ``"cuda_events"`` or
    ``"wall"``)."""
    from ..core.pq import adc_lut

    c1, _ = engine.candidate_counts(h, alpha, beta)
    cuda = engine.arrays.codes.device.type == "cuda"
    lut = adc_lut(q_dense, engine.arrays.codebooks,
                  fixed_order=engine.backend.uses_kernels)

    def pass1():
        return engine.pass1_topk(q_dims, q_vals, lut, c1)

    def full():
        return engine.search(q_dims, q_vals, q_dense, h=h, alpha=alpha,
                             beta=beta)

    # warm both (kernel build, plan caches) outside the timed loop
    pass1()
    full()
    # in turns, so that a drift of the host's speed reaches both alike
    pairs = [(_seconds(pass1, cuda), _seconds(full, cuda))
             for _ in range(max(1, iters))]
    pass1_s = min(p for p, _ in pairs)
    full_s = min(f for _, f in pairs)
    pass23_s = max(0.0, full_s - pass1_s)
    # jitter can time pass 1 alone above the full search; an attribution
    # fraction is [0, 1] by definition, so clamp
    frac = min(1.0, pass1_s / full_s) if full_s > 0 else 0.0
    return {"pass1_s": pass1_s, "full_s": full_s, "pass23_s": pass23_s,
            "pass1_fraction": frac, "iters": iters,
            "backend": str(engine.backend),
            "timer": "cuda_events" if cuda else "wall"}
