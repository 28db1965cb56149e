"""The port's observability layer (repro_torch.obs) against the JAX
package's, on the CPU, and the port's serving launcher end to end.

The metrics registry and the span trees are copies of the reference's: the
same operations must give the same snapshots, the same text exposition and
the same trees (ids and clocks aside).  The service's ``serve.search`` /
``serve.batch`` spans carry the reference's tags.  ``pass_breakdown`` and
``device_trace`` are the port's own (torch.profiler, CUDA events on the
card): their keys and their trace file are checked here.  Last,
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
    (batch,) = first["children"]
    assert batch["name"] == "serve.batch" and batch["tags"]["bucket"] == 8
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


def test_pass_breakdown_keys_on_cpu(small_index):
    idx, q_dims, q_vals, q_dense = small_index
    out = obs.pass_breakdown(idx.engine, torch.from_numpy(q_dims),
                             torch.from_numpy(q_vals),
                             torch.from_numpy(q_dense), h=5, alpha=4,
                             beta=2, iters=2)
    assert set(out) == {"pass1_s", "full_s", "pass23_s", "pass1_fraction",
                        "iters", "backend", "timer"}
    assert out["timer"] == "wall" and 0.0 <= out["pass1_fraction"] <= 1.0
    assert out["pass23_s"] == max(0.0, out["full_s"] - out["pass1_s"])


def test_device_trace_writes_a_trace(small_index, tmp_path):
    idx, q_dims, q_vals, q_dense = small_index
    with obs.device_trace(str(tmp_path)):
        with obs.StepAnnotation("engine.search", step_num=1):
            idx.engine.search(torch.from_numpy(q_dims),
                              torch.from_numpy(q_vals),
                              torch.from_numpy(q_dense), h=5, alpha=4,
                              beta=2)
    (name,) = os.listdir(tmp_path)
    trace = json.load(open(tmp_path / name))
    assert any(e.get("name") == "engine.search"
               for e in trace["traceEvents"])
    with obs.device_trace(None):        # profiling off: a no-op
        pass
    assert obs.profiler_available()


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
