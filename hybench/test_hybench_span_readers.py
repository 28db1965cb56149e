"""The readers of the program's spans (``hybench/span_readers.py``) on
hand-made contexts, on a program that has no such spans, and in a tiny
traced CPU run of ``shard1b-batch32``."""

import dataclasses
import math

import pytest
import torch

from hybench import _cell_tests as ct
from hybench import span_readers as sr
from hybench.conftest import tiny
from hybench.costs import SearchShape
from hybench.tracecalc import DeviceTrace

SHAPE = SearchShape(n=2**20, k=100, l=16, p=2, d_dense=200, nq=256, h=100,
                    c1=500, c2=200, postings_per_row=256 * 256,
                    residual_per_row=64)
# pass 1 at 32 rows is bound by its adds: the LUT 32·100·16·2, the ADC
# 32·2^20·100 and the bias 32·65536, at 33.5e12 a second
LEAST_32 = (32 * 100 * 16 * 2 + 32 * 2**20 * 100 + 32 * 65536) / 33.5e12


def _span(name, duration_s, children=(), **tags):
    return {"name": name, "duration_s": duration_s, "tags": tags,
            "children": list(children)}


def _request(total, dispatch, wait, passes):
    """A ``serve.search`` root of one 32-row batch; ``passes`` the three
    passes' ``device_s``."""
    p = [_span(f"engine.pass{i + 1}", d, device_s=d)
         for i, d in enumerate(passes)]
    batch = _span("serve.batch", dispatch + wait + 0.001,
                  [_span("serve.h2d", 0.0002),
                   _span("serve.dispatch", dispatch, p),
                   _span("serve.wait", wait),
                   _span("serve.merge", 0.0005)],
                  rows=32, bucket=32, dispatch_s=dispatch, merge_s=0.0005)
    return _span("serve.search", total,
                 [_span("serve.lookup", 0.0003), batch,
                  _span("serve.fill", 0.0001)], qn=32, h=100)


def _ctx(spans=(), trace=None):
    return {"spans": list(spans), "trace": trace, "shape": SHAPE}


HAND = _ctx([_request(0.060, 0.004, 0.050, (0.048, 0.0002, 0.0003)),
             _request(0.058, 0.003, 0.049, (0.046, 0.0001, 0.0002))])


def test_pass1_roofline_live_by_hand():
    assert sr.pass1_roofline_live(HAND) == pytest.approx(
        100 * 2 * LEAST_32 / (0.048 + 0.046), rel=1e-12)


def test_pass23_device_ms_by_hand():
    assert sr.pass23_device_ms(HAND) == pytest.approx(
        1e3 * ((0.0002 + 0.0003) + (0.0001 + 0.0002)) / 2, rel=1e-12)


def test_host_ms_by_hand():
    assert sr.host_ms(HAND) == pytest.approx(
        1e3 * ((0.060 - 0.004 - 0.050) + (0.058 - 0.003 - 0.049)) / 2,
        rel=1e-12)


def _trace(host):
    """A 1000 us stretch, busy 0-400 and 600-1000: one 200 us gap."""
    return DeviceTrace(t0=0.0, t1=1000.0,
                       device=[(0.0, 400.0, "k2", "kernel"),
                               (600.0, 1000.0, "k2", "kernel")],
                       host=host)


def test_idle_in_service_reads_the_gap_inside_a_search():
    # the gap is 20% of the stretch; a serve.search range covers half of
    # it, and another annotation covers the rest
    tr = _trace([(100.0, 300.0, "serve.search"),
                 (400.0, 500.0, "serve.lookup"),
                 (500.0, 900.0, "serve.search")])
    assert sr.idle_in_service(_ctx(trace=tr)) == pytest.approx(10.0)
    whole = _trace([(350.0, 700.0, "serve.search"),
                    (380.0, 650.0, "serve.search")])
    assert sr.idle_in_service(_ctx(trace=whole)) == pytest.approx(20.0)


@pytest.mark.parametrize("reader", [sr.pass1_roofline_live,
                                    sr.pass23_device_ms, sr.host_ms,
                                    sr.idle_in_service])
def test_readers_find_nothing(reader):
    empty = DeviceTrace(t0=0.0, t1=1000.0, device=[], host=[])
    # a program whose serve.batch spans have no phase or pass children
    bare = _span("serve.search", 0.06,
                 [_span("serve.batch", 0.05, rows=32, bucket=32,
                        dispatch_s=0.004, merge_s=0.046)])
    for ctx in (_ctx(), _ctx([bare], _trace([])), _ctx([], empty),
                _ctx([bare], _trace([(0.0, 1000.0, "serve.batch")]))):
        assert reader(ctx) is None


def test_tiny_traced_run_reports_the_span_metrics(bench):
    # the tiny pool (512 rows) lies inside the cache's reach, so the
    # stretch would hold hits alone; past it, as in the cell, no row hits
    cell = tiny(bench, "shard1b-batch32")
    cell = dataclasses.replace(cell, config={**cell.config,
                                             "fresh_pool": 2048})
    # the profiler's first start in a process can outlast a 1.5 s window
    with torch.profiler.profile():
        pass
    res = ct.run_tiny(bench, cell, trace=True, seconds=1.5)
    assert res["correct"] is True, res["checks"]
    for name in ("pass1_roofline_live.batch", "pass23_device_ms.batch",
                 "host_ms.batch"):
        got = res["metrics"][name]["value"]
        assert math.isfinite(got) and got > 0, (name, got)
    # the CPU's trace holds no kernel, and the harness's profiler records
    # none of the client thread's ranges: nothing to intersect
    assert sr.idle_in_service({"trace": _trace([]), "spans": []}) is None
