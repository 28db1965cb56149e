"""Find a cell's configuration, traffic mix, maker and per-layer metric
readers by the names ``BENCHMARK.json`` gives, and check the file's shape.

Every lookup goes through the file system under one root, so a later
cell, mix or metric is added as new files and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration and mix loaded.

    ``end_to_end`` and ``per_layer`` are the metric entries that this cell
    reports (an entry without ``workloads`` belongs to every cell)."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Bench:
    """The benchmark rooted at ``root`` (the checkout's root)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = self.root / "hybench"

    def cell(self, name: str) -> Cell:
        by_name = {w["name"]: w for w in self.doc["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(by_name)}")
        w = by_name[name]
        cfg_entry = {c["name"]: c for c in self.doc["configs"]}[w["config"]]
        config = json.loads((self.root / cfg_entry["file"]).read_text())
        traffic = json.loads(
            (self.pkg / "traffic" / f"{w['traffic']}.json").read_text())
        return Cell(name=name, chips=int(w["chips"]),
                    config_name=w["config"], traffic_name=w["traffic"],
                    config=config, traffic=traffic,
                    end_to_end=tuple(m for m in self.doc["end_to_end"]
                                     if _applies(m, name)),
                    per_layer=tuple(m for m in self.doc["per_layer"]
                                    if _applies(m, name)))

    def maker(self, name: str):
        """``hybench/makers/<name>.py``: ``build(config, traffic, seed,
        device, trace)``."""
        return _load_module(self.pkg / "makers" / f"{name}.py",
                            f"hybench_maker_{name}")

    def reader(self, metric: str):
        """``hybench/metrics/<metric>.py``'s ``read(ctx)``."""
        mod = _load_module(self.pkg / "metrics" / f"{metric}.py",
                           "hybench_metric_" + re.sub(r"\W", "_", metric))
        return mod.read


def _need(ok: bool, msg: str, errors: list) -> None:
    if not ok:
        errors.append(msg)


def validate(doc: dict, root: str | Path | None = None) -> list[str]:
    """The contract's checks on ``BENCHMARK.json`` that need no chip: keys,
    names, units, references between entries, and (given ``root``) that
    each named file exists.  Returns the faults found (empty: none)."""
    errors: list[str] = []
    _need(set(doc) == TOP_KEYS, f"top-level keys {sorted(doc)}", errors)
    _need(1 <= doc.get("run_seconds", 0) <= 51
          and isinstance(doc.get("run_seconds"), int), "run_seconds", errors)
    cmd = doc.get("command", [])
    _need(1 <= len(cmd) <= 32 and all(isinstance(w, str) and 1 <= len(w)
                                      <= 200 for w in cmd), "command", errors)
    paths = doc.get("paths", [])
    _need(1 <= len(paths) <= 16 and all(
        re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        and not p.startswith("/") for p in paths), "paths", errors)
    names: set[str] = set()      # metric names, across both groups
    configs ={c.get("name"): c for c in doc.get("configs", [])}
    _need(1 <= len(configs) <= 24, "configs count", errors)
    for c in doc.get("configs", []):
        _need(set(c) == {"name", "source", "file", "reduced", "why"},
              f"config keys {sorted(c)}", errors)
        _need(bool(NAME.match(c.get("name", ""))), f"name {c.get('name')}",
              errors)
        _need(len(c.get("reduced", [])) <= 16 and all(
            NAME.match(k) for k in c.get("reduced", [])), "reduced", errors)
        _need(any(c.get("file", "").startswith(p.rstrip("/") + "/")
                  for p in paths), f"file {c.get('file')}", errors)
        if root is not None:
            _need((Path(root) / c.get("file", "")).is_file(),
                  f"missing {c.get('file')}", errors)
    pairs = set()
    wl = doc.get("workloads", [])
    _need(1 <= len(wl) <= 24, "workloads count", errors)
    _need(sum(w.get("chips") == 4 for w in wl) <= max(1, len(wl) // 4),
          "four-chip cells", errors)
    for w in wl:
        _need(set(w) == {"name", "config", "traffic", "chips", "why"},
              f"workload keys {sorted(w)}", errors)
        _need(w.get("config") in configs, f"config {w.get('config')}", errors)
        _need(w.get("chips") in (1, 4), "chips", errors)
        _need(bool(NAME.match(w.get("traffic", ""))), "traffic name", errors)
        pair = (w.get("config"), w.get("traffic"))
        _need(pair not in pairs, f"pair {pair} twice", errors)
        pairs.add(pair)
        if root is not None:
            _need((Path(root) / "hybench" / "traffic"
                   / f"{w.get('traffic')}.json").is_file(),
                  f"missing traffic {w.get('traffic')}", errors)
    cells = {w.get("name") for w in wl}
    texts = {"configs": ("why", "source"), "workloads": ("why",),
             "end_to_end": (), "per_layer": ("layer",)}
    for group, fields in texts.items():
        seen: set[str] = set() if group in ("configs", "workloads") \
            else names
        for e in doc.get(group, []):
            n = e.get("name", "")
            _need(bool(NAME.match(n)), f"name {n!r}", errors)
            _need(n not in seen, f"name {n!r} twice", errors)
            seen.add(n)
            for text in fields:
                v = e.get(text, "")
                _need(isinstance(v, str) and 1 <= len(v) <= 200
                      and "\n" not in v and "\t" not in v,
                      f"{n}.{text}", errors)
    e2e = {m.get("name"): m for m in doc.get("end_to_end", [])}
    _need("setup_s" in e2e, "setup_s", errors)
    _need(1 <= len(e2e) <= 16, "end_to_end count", errors)
    for m in doc.get("end_to_end", []):
        _need(set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}, f"keys {sorted(m)}",
              errors)
        _need(0.01 <= m.get("bound", 0) <= 0.25, f"bound {m.get('name')}",
              errors)
        _need(m.get("source") in ("host_clock", "device_trace"),
              f"source {m.get('name')}", errors)
    pl = doc.get("per_layer", [])
    _need(1 <= len(pl) <= 128, "per_layer count", errors)
    for m in pl:
        _need(set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"},
              f"keys {sorted(m)}", errors)
        _need(m.get("moves") in e2e, f"moves {m.get('moves')}", errors)
        _need(m.get("source") in SOURCES, f"source {m.get('name')}", errors)
        for c in m.get("workloads", []):
            _need(c in cells, f"{m.get('name')} names cell {c}", errors)
            mv = e2e.get(m.get("moves"), {})
            _need(_applies(mv, c), f"{m.get('name')}: {c} lacks its moves",
                  errors)
        if root is not None:
            _need((Path(root) / "hybench" / "metrics"
                   / f"{m.get('name')}.py").is_file(),
                  f"missing reader {m.get('name')}", errors)
    for m in list(doc.get("end_to_end", [])) + list(pl):
        _need(bool(UNIT.match(m.get("unit", ""))), f"unit {m.get('unit')}",
              errors)
        _need(m.get("better") in ("lower", "higher"), "better", errors)
    for c in cells:
        _need(any(_applies(m, c) for m in pl), f"{c}: no per-layer metric",
              errors)
        _need(sum(_applies(m, c) for m in doc.get("end_to_end", [])) >= 2,
              f"{c}: needs setup_s and another end-to-end metric", errors)
    return errors
