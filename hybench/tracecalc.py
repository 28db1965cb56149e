"""Reduce a ``torch.profiler`` trace of a stretch of the window to what the
per-layer readers and the ``breakdown`` need.

The profiler's Chrome trace puts host and device events on one clock
(microseconds).  Device activity is every event of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; its union is the busy time.
An idle gap is an interval between two device intervals; it is labelled
by the innermost host event (an operator, a runtime call or an annotation)
that covers its middle, or ``host: python`` where none does.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


@dataclasses.dataclass
class DeviceTrace:
    """Device intervals (start, end, name, cat) and host events (start,
    end, name) within [t0, t1], microseconds."""
    t0: float
    t1: float
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        merged: list = []
        for s, e, _, _ in sorted(self.device):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self) -> int:
        return sum(1 for s, _, _, c in self.device
                   if c == "kernel" and self.t0 <= s <= self.t1)

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...]: device time by operation name, most
        first."""
        tot: collections.Counter = collections.Counter()
        for s, e, name, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                tot[name[:160]] += (e - s) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds], ...]: idle time summed by
        the label of each gap, most first."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host)
        tot: collections.Counter = collections.Counter()
        starts = [h[0] for h in host]
        for s, e in gaps:
            mid = (s + e) / 2
            label = "host: python"
            best = None
            j = bisect.bisect_right(starts, mid)
            # innermost: the latest-starting host event that covers mid;
            # events are short next to a scan back of this length
            for hs, he, name in reversed(host[max(0, j - 4096):j]):
                if he >= mid:
                    best = name
                    break
            if best is not None:
                label = best[:160]
            tot[label] += (e - s) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]


def load_chrome_trace(path: str, window_s: float) -> DeviceTrace:
    """Parse an exported trace; the stretch starts at its first host event
    and lasts ``window_s`` (the host clock's reading of the stretch)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((s, e, ev.get("name", ""), cat))
        elif cat in HOST_CATS:
            host.append((s, e, ev.get("name", "")))
    t0 = min((h[0] for h in host), default=min((d[0] for d in device),
                                                default=0.0))
    return DeviceTrace(t0=t0, t1=t0 + window_s * 1e6, device=device,
                       host=host)


def capture(prof, tmpdir: str, window_s: float) -> DeviceTrace:
    """Export ``prof``'s trace under ``tmpdir``, parse it, delete the file."""
    path = os.path.join(tmpdir, f"hybench-trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        return load_chrome_trace(path, window_s)
    finally:
        os.remove(path)
