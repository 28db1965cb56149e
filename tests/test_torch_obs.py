"""The port's observability layer (repro_torch.obs) against the JAX
package's, on the CPU, and the port's serving launcher end to end.

The metrics registry and the span trees are copies of the reference's: the
same operations must give the same snapshots, the same text exposition and
the same trees (ids and clocks aside).  The service's ``serve.search`` /
``serve.batch`` spans carry the reference's tags.  The port's own: the
service's full span tree, each span a ``torch.profiler`` range, the
passes' ``device_s`` (CUDA events on the card, faked here) and a
tracer that is off opening no range and recording no event.  Last,
``python -m repro_torch.launch.serve --retrieval --device cpu`` runs plain,
durable and restored, each to exit 0."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.data import make_hybrid_dataset
from repro_torch import obs
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.pq import adc_lut
from repro_torch.core.sparse_index import sparse_queries_to_padded
from repro_torch.serve import QueryService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive_registry(m):
    c = m.counter("serve.requests")
    c.inc()
    c.inc(41)
    m.counter("serve.cache.hits").inc(7)
    g = m.gauge("serve.delta_rows")
    g.set(12)
    g.add(-2.5)
    h = m.histogram("wal.fsync_s")
    for v in (0.0001, 0.003, 0.02, 0.7, 12.0):
        h.observe(v)
    b = m.histogram("wal.group_commit_batch", bounds=(1, 2, 4, 8))
    for v in (1, 1, 3, 9):
        b.observe(v)
    return m


@pytest.mark.parametrize("enabled", [True, False])
def test_registry_matches_reference(enabled):
    ours = _drive_registry(obs.MetricsRegistry(enabled=enabled))
    ref = _drive_registry(jobs.MetricsRegistry(enabled=enabled))
    assert ours.snapshot() == ref.snapshot()
    assert ours.render_text() == ref.render_text()


def _strip(tree):
    """A span tree without its ids and clocks."""
    return {"name": tree["name"], "tags": tree["tags"],
            "annotations": tree["annotations"],
            "children": [_strip(c) for c in tree["children"]]}


def _drive_tracer(tr):
    root = tr.root("serve.search", qn=3, h=10)
    with root:
        b = root.child("serve.batch", rows=3, bucket=8)
        b.set("dispatch_s", 0.25)
        b.add("merge_s", 0.5)
        b.add("merge_s", 0.25)
        b.annotate("delta")
        b.end()
        root.child("rpc", peer="p").attach_remote(
            {"name": "shard.search", "sid": "x", "duration_s": 1.0,
             "score_s": 0.125, "annotations": ["reloaded"]})
    return tr.take()


def test_span_trees_match_reference():
    ours = _drive_tracer(obs.Tracer(enabled=True))
    ref = _drive_tracer(jobs.Tracer(enabled=True))
    assert [_strip(t) for t in ours] == [_strip(t) for t in ref]
    assert obs.stage_totals(ours) == jobs.stage_totals(ref)
    assert obs.stage_totals(ours)["merge_s"] == 0.75
    assert obs.Observability.off().tracer.root("x") is obs.NULL_SPAN
    o = obs.Observability()
    assert o.metrics.enabled and not o.tracer.enabled and o.enabled


@pytest.fixture(scope="module")
def small_index():
    ds = make_hybrid_dataset(num_points=512, num_queries=6, d_sparse=700,
                             d_dense=12, nnz_per_row=12, seed=41)
    p = HybridIndexParams(keep_top=24, head_dims=16, kmeans_iters=2,
                          backend="ref")
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense, p, device="cpu")
    q_dims, q_vals = sparse_queries_to_padded(ds.q_sparse, idx.cols,
                                              nq_max=p.nq_max)
    return idx, q_dims, q_vals, np.asarray(ds.q_dense, np.float32)


def test_service_spans_and_metrics(small_index):
    idx, q_dims, q_vals, q_dense = small_index
    svc = QueryService(idx.engine, h=5, cache_size=4, device="cpu",
                       obs=obs.Observability(trace=True))
    svc.search(q_dims, q_vals, q_dense)
    svc.search(q_dims[:2], q_vals[:2], q_dense[:2])
    traces = svc.obs.tracer.take()
    assert [t["name"] for t in traces] == ["serve.search"] * 2
    first, second = traces
    assert first["tags"]["cache_misses"] == 6
    (batch,) = [c for c in first["children"] if c["name"] == "serve.batch"]
    assert batch["tags"]["bucket"] == 8
    assert batch["tags"]["dispatch_s"] >= 0 and batch["tags"]["merge_s"] >= 0
    assert second["tags"]["cache_hits"] == 0          # evicted by 6 rows
    m = svc.metrics()
    assert m["serve.requests"] == 8 and m["serve.batches"] == 2
    svc.close()
    off = QueryService(idx.engine, h=5, device="cpu",
                       obs=obs.Observability.off())
    off.search(q_dims, q_vals, q_dense)
    assert off.cache_info().misses == 0 and off.metrics() == {}
    off.close()


PASSES = ["engine.pass1", "engine.pass2", "engine.pass3"]
BATCH = ["serve.h2d", "serve.dispatch", "serve.wait", "serve.merge"]


def _traced_service(small_index, **kw):
    """A traced service at buckets (1, 2, 4): the six query rows are two
    miss batches, of 4 and 2 rows."""
    idx = small_index[0]
    return QueryService(idx.engine, h=5, buckets=(1, 2, 4), device="cpu",
                        obs=obs.Observability(trace=True), **kw)


def _names(tree):
    return [c["name"] for c in tree["children"]]


def _nodes(tree):
    yield tree
    for c in tree["children"]:
        yield from _nodes(c)


def test_service_search_span_tree(small_index):
    _, q_dims, q_vals, q_dense = small_index
    svc = _traced_service(small_index, cache_size=16)
    svc.search(q_dims, q_vals, q_dense)
    svc.search(q_dims[:4], q_vals[:4], q_dense[:4])
    cold, warm = svc.obs.tracer.take()
    svc.close()
    assert cold["tags"] == {"qn": 6, "h": 5, "gen": 0, "cache_hits": 0,
                            "cache_misses": 6}
    assert _names(cold) == ["serve.lookup", "serve.batch", "serve.batch",
                            "serve.fill"]
    for batch, rows in zip(cold["children"][1:3], (4, 2)):
        assert set(batch["tags"]) == {"rows", "bucket", "dispatch_s",
                                      "merge_s"}
        assert batch["tags"]["rows"] == batch["tags"]["bucket"] == rows
        assert _names(batch) == BATCH
        dispatch, _, merge = batch["children"][1:]
        assert batch["tags"]["dispatch_s"] == dispatch["duration_s"]
        assert batch["tags"]["merge_s"] == merge["duration_s"]
        assert _names(dispatch) == PASSES
        for p in dispatch["children"]:
            assert set(p["tags"]) == {"device_s"} and not p["children"]
    for leaf in ("serve.lookup", "serve.fill"):
        (node,) = [c for c in cold["children"] if c["name"] == leaf]
        assert node["tags"] == {} and node["children"] == []
    # every row a hit: no batch, the lookup and an empty fill
    assert warm["tags"]["cache_hits"] == 4
    assert _names(warm) == ["serve.lookup", "serve.fill"]


def test_pass_device_times_fit_in_the_dispatch(small_index):
    _, q_dims, q_vals, q_dense = small_index
    svc = _traced_service(small_index, cache_size=0)
    for _ in range(3):
        svc.search(q_dims, q_vals, q_dense)
    traces = svc.obs.tracer.take()
    svc.close()
    dispatches = [n for t in traces for n in _nodes(t)
                  if n["name"] == "serve.dispatch"]
    assert len(dispatches) == 6
    for d in dispatches:
        dev = [p["tags"]["device_s"] for p in d["children"]]
        assert len(dev) == 3 and all(v >= 0 for v in dev)
        # on the CPU the work is synchronous: device_s is the host span's
        assert dev == [p["duration_s"] for p in d["children"]]
        assert sum(dev) <= d["duration_s"]


def test_spans_are_profiler_ranges(small_index, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    _, q_dims, q_vals, q_dense = small_index
    svc = _traced_service(small_index, cache_size=0)
    svc.search(q_dims[:1], q_vals[:1], q_dense[:1])      # warm
    svc.obs.tracer.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.search(q_dims, q_vals, q_dense)
    (tree,) = svc.obs.tracer.take()
    svc.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    parent_of, count = {}, {}
    for node in _nodes(tree):
        count[node["name"]] = count.get(node["name"], 0) + 1
        for c in node["children"]:
            parent_of[c["name"]] = node["name"]
    got = {}
    for e in events:
        got.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert {k: len(v) for k, v in got.items()} == count
    assert count["serve.batch"] == 2
    for name, parent in parent_of.items():
        for s, e in got[name]:
            assert any(ps <= s + 1e-3 and e <= pe + 1e-3
                       for ps, pe in got[parent]), (name, parent)


def test_tracing_off_opens_no_range_and_records_no_event(small_index,
                                                         monkeypatch):
    _, q_dims, q_vals, q_dense = small_index
    traced = _traced_service(small_index, cache_size=0)
    want = traced.search(q_dims, q_vals, q_dense)
    traced.close()

    def refuse(*a, **k):
        raise AssertionError("tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    off = QueryService(small_index[0].engine, h=5, buckets=(1, 2, 4),
                       cache_size=0, device="cpu", obs=obs.Observability())
    got = off.search(q_dims, q_vals, q_dense)
    off.close()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(AssertionError, match="tracing is off"):
        with obs.Tracer().root("x"):
            pass


class _FakeEvent:
    """A CUDA event stand-in: ``record`` stamps a clock, ``query`` says
    whether the stream has reached it."""
    clock = 0.0
    done = True

    def __init__(self, enable_timing=False):
        self.at = None
        self.waited = False

    def record(self, stream=None):
        _FakeEvent.clock += 2.0
        self.at = _FakeEvent.clock

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other):
        return other.at - self.at


def test_device_times_settle_at_root_end_or_take(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    tr = obs.Tracer()
    with tr.root("serve.search") as root:      # work done at the root's end
        with root.device_child("engine.pass1", "cuda:0") as p:
            pass
    assert p.tags["device_s"] == 2.0 / 1e3 and p._events is None
    _FakeEvent.done = False
    try:
        with tr.root("engine.search") as root:  # the work still queued
            with root.device_child("engine.pass1", "cuda:0") as q:
                pass
        assert "device_s" not in q.tags and len(q._events) == 2
        end = q._events[1]
        first, second = tr.take()               # waits for it
    finally:
        _FakeEvent.done = True
    assert end.waited and q._events is None
    assert [c["tags"]["device_s"] for c in (first["children"][0],
                                            second["children"][0])] == [
        2.0 / 1e3, 2.0 / 1e3]


def test_three_pass_spans_and_pass1_topk_keep_the_bits(small_index):
    idx, q_dims, q_vals, q_dense = small_index
    q = [torch.from_numpy(a) for a in (q_dims, q_vals, q_dense)]
    kw = dict(h=5, alpha=4, beta=2)
    tr = obs.Tracer()
    with tr.root("engine.search") as root:
        traced = idx.engine.search(*q, span=root, **kw)
    plain = idx.engine.search(*q, **kw)
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)
    c1, _ = idx.engine.candidate_counts(**kw)
    lut = adc_lut(q[2], idx.engine.arrays.codebooks)
    with tr.root("pass1") as root:
        top = idx.engine.pass1_topk(q[0], q[1], lut, c1, span=root)
    for a, b in zip(top, idx.engine.pass1_topk(q[0], q[1], lut, c1)):
        assert torch.equal(a, b)
    search, p1 = tr.take()
    assert _names(search) == PASSES and _names(p1) == ["engine.pass1"]
    assert all(c["tags"]["device_s"] >= 0 for c in search["children"])


def test_metrics_endpoint_serves_the_registry():
    m = _drive_registry(obs.MetricsRegistry())
    server = obs.start_metrics_server(m, 0)
    try:
        url = f"http://127.0.0.1:{server.port}"
        text = urllib.request.urlopen(url + "/metrics", timeout=10).read()
        assert text.decode() == m.render_text()
        js = urllib.request.urlopen(url + "/metrics.json", timeout=10).read()
        assert json.loads(js) == json.loads(json.dumps(m.snapshot()))
    finally:
        server.close()


def _launch(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--retrieval",
         "--device", "cpu", "--points", "2000", "--queries", "16", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_launch_serve_retrieval_plain_durable_restored(tmp_path):
    plain = _launch("--metrics-port", "0")
    assert plain.returncode == 0, plain.stderr
    assert "QPS" in plain.stdout and "metrics endpoint" in plain.stdout
    store = str(tmp_path / "store")
    durable = _launch("--persist-dir", store)
    assert durable.returncode == 0, durable.stderr
    assert "logged 64 inserts + 8 deletes" in durable.stdout
    restored = _launch("--restore", store)
    assert restored.returncode == 0, restored.stderr
    assert "'recovered_replayed': 2" in restored.stdout
    top = [ln.split("top ids")[1] for ln in (durable.stdout + restored.stdout)
           .splitlines() if "top ids" in ln]
    assert len(top) == 2 and top[0] == top[1]



@pytest.mark.parametrize("flag", ["--role", "--arch"])
def test_launch_serve_unported_modes_name_their_item(flag, capsys):
    """``--role`` and ``--arch`` are ported (the cluster tier, the LM mode):
    an unknown role is refused with the two it takes, an unknown arch
    raises the reference's "unknown arch" ``KeyError``."""
    from repro_torch.launch.serve import main
    if flag == "--arch":
        with pytest.raises(KeyError, match="unknown arch 'x'"):
            main(["--arch", "x", "--device", "cpu"])
        return
    with pytest.raises(SystemExit) as e:
        main(["--retrieval", flag, "x"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice: 'x'" in err and "{router,shard}" in err


def test_launch_serve_lm_mode_on_cpu(capsys):
    """``--arch qwen2-7b-smoke --pq-head`` decodes on the CPU and prints
    the reference's two lines."""
    from repro_torch.launch.serve import main
    main(["--arch", "qwen2-7b-smoke", "--device", "cpu", "--tokens", "2",
          "--pq-head"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (4, 2) in ")
    assert out[0].endswith("ms/step, head=pq-hybrid)")
    assert out[1].startswith("sample: [") and len(out) == 2
