"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro``; top-level module names are compared whole."""

import ast
import json
import os
import shutil
import subprocess
import sys

from hybench import run
from hybench.conftest import ROOT

_NO_PROGRAM = ("reference.py", "costs.py", "load.py", "tracecalc.py",
               "spec.py", "readers.py", "built.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_yardstick_imports_no_program():
    for name in _NO_PROGRAM:
        got = set(_imports(ROOT / "hybench" / name))
        assert not got & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_file_imports_jax_or_repro():
    for path in (ROOT / "hybench").rglob("*.py"):
        assert not set(_imports(path)) & {"repro", "jax", "jaxlib", "flax"}


def test_names_compared_whole():
    assert run.blocked_modules(["repro_torch", "repro_torch.core",
                                "jax_like", "flaxen", "numpy"]) == []
    assert run.blocked_modules(["repro.core", "jaxlib.xla_client",
                                "flax"]) == ["flax", "jaxlib", "repro"]


_CHILD = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from hybench import run
from hybench.conftest import later_root, tiny
from hybench.spec import Bench
b = Bench(later_root({tmp!r}))
for name in ("shard1b-batch32", "querysim524k-ragged1"):
    res = run.run_cell(b, tiny(b, name), seed=11, seconds=0.3, trace=False,
                       device="cpu")
    assert res["correct"], res
print(json.dumps(run.blocked_modules()))
"""


def test_a_run_loads_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=str(ROOT),
                                             src=str(ROOT / "src"),
                                             tmp=str(tmp_path))],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_or_a_program_no_result(tmp_path, capsys):
    assert run.main(["--workload", "shard1b-batch32", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hybench", tmp_path / "hybench")
    out = subprocess.run(
        [sys.executable, "-m", "hybench.run", "--workload",
         "shard1b-batch32", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
