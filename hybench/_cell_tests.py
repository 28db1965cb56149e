"""The checks that every cell's CPU test file runs at test size: a run's
last line, and ``correct`` false under the control and each fault."""

from __future__ import annotations

import json

import numpy as np

from hybench import run
from hybench.readings import control_search

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def answer_altered(send, built):
    """Every answer's best id replaced by the id of another row."""
    def f(rows):
        s, ids = send(rows)
        ids = ids.copy()
        ids[:, 0] = built.prog_ids(
            (built.ref_ids(ids[:, 0]).cpu().numpy() + 1) % built.shape.n)
        return s, ids
    return f


def half_left_out(send, built):
    """Half of each request's rows searched; the rest given their answers."""
    def f(rows):
        half = (len(rows) + 1) // 2
        s, ids = send(rows[:half])
        pick = np.arange(len(rows)) % half
        return s[pick], ids[pick]
    return f


def answer_duplicated(send, built):
    """Every answer's best row returned twice, its second best dropped."""
    def f(rows):
        s, ids = send(rows)
        s, ids = s.copy(), ids.copy()
        s[:, 1], ids[:, 1] = s[:, 0], ids[:, 0]
        return s, ids
    return f


FAULTS = {"answer_altered": answer_altered, "half_left_out": half_left_out,
          "answer_duplicated": answer_duplicated}


def run_tiny(bench, cell, *, trace=False, wrap=None, seconds=0.6,
             seed=2**33 + 7):
    return run.run_cell(bench, cell, seed=seed, seconds=seconds,
                        trace=trace, device="cpu", wrap_search=wrap)


def check_sound_run(bench, cell, capsys):
    res = run_tiny(bench, cell)
    assert list(res) == TOP_KEYS + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and np.isfinite(got["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    run.emit(res)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == res
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def check_traced_run(bench, cell):
    res = run_tiny(bench, cell, trace=True, seconds=1.5)
    assert list(res) == TOP_KEYS + ["breakdown", "checks"]
    assert res["correct"] is True, res["checks"]
    names = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= names
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def check_fails(bench, cell, fault: str):
    wrap = (control_search(cell.config["control"],
                           cell.config["reference_block"])
            if fault == "control" else FAULTS[fault])
    res = run_tiny(bench, cell, wrap=wrap)
    assert res["correct"] is False, res["checks"]
