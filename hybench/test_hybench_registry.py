"""``BENCHMARK.json`` against the contract's checks that need no chip, and
a cell, mix and metric added as new files and entries alone."""

import json
import shutil

from hybench import run
from hybench.conftest import ROOT, later_root, tiny
from hybench.spec import Bench, validate


def test_benchmark_json_keeps_the_contract():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert validate(doc, ROOT) == []
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in doc["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert (ROOT / "hybench" / "makers" / f"{cfg['maker']}.py").is_file()


def test_validate_finds_faults():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["end_to_end"][0]["bound"] = 0.5
    doc["per_layer"][0]["moves"] = "nothing"
    doc["workloads"][0]["name"] = "has space"
    assert len(validate(doc)) >= 3


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    for part in ("BENCHMARK.json", "hybench"):
        src = ROOT / part
        (shutil.copytree if src.is_dir() else shutil.copy)(
            src, tmp_path / part)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "hybench/configs/querysim-1b-shard.json")
                     .read_text())
    (tmp_path / "hybench/configs/shard-later.json").write_text(
        json.dumps({**cfg, "cache_rows": 256}))
    mix = json.loads((ROOT / "hybench/traffic/batch32.json").read_text())
    (tmp_path / "hybench/traffic/small8.json").write_text(
        json.dumps({**mix, "sizes": [[8, 8, 1.0]], "clients": 1}))
    (tmp_path / "hybench/metrics/pass1_ms.later.py").write_text(
        "def read(ctx):\n    return ctx['pass1_ms']\n")
    doc["configs"].append({"name": "shard-later", "source": "a later PR",
                           "file": "hybench/configs/shard-later.json",
                           "reduced": ["shards"], "why": "a test"})
    doc["workloads"].append({"name": "later-small8", "config": "shard-later",
                             "traffic": "small8", "chips": 1,
                             "why": "a test"})
    doc["per_layer"].append({"name": "pass1_ms.later", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "serving", "moves": "throughput",
                             "workloads": ["later-small8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    assert validate(doc, tmp_path) == []
    bench = Bench(tmp_path)
    cell = tiny(bench, "later-small8")
    assert cell.config["cache_rows"] == 256 and cell.traffic["clients"] == 1
    assert [m["name"] for m in cell.per_layer] == ["pass1_ms.later"]
    res = run.run_cell(bench, cell, seed=2**32 + 1, seconds=1.5, trace=True,
                       device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["pass1_ms.later"]["value"] > 0


def test_the_cells_ready_as_files_keep_the_contract(tmp_path):
    root = later_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    assert validate(doc, root) == []
    assert len(doc["workloads"]) > len(json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"])
