"""The port stands alone: no file of src/repro_torch, and none of
chip_smoke.py, tools/lut16_probe.py, tools/context_probe.py,
tools/b4_probe.py and tools/residual_probe.py, imports
jax or the JAX package ``repro``, and the package (its serving, cluster,
persistence, observability, checkpoint and launch subpackages included)
imports in a process where jax cannot be imported at all (its configs,
models and decode loop included, and the dry-run and roofline tools:
``launch.dryrun``, ``launch.retrieval_check``, ``launch.perf_probe``,
``launch.mesh``, ``models.shardings``, ``roofline.analysis``,
``roofline.report``).
``tools/make_reference_store.py`` is the reference's tool and imports
``repro`` on purpose."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "lut16_probe.py",
    REPO / "tools" / "context_probe.py", REPO / "tools" / "b4_probe.py",
    REPO / "tools" / "residual_probe.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_package_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.interchange, "
            "repro_torch.core, repro_torch.core.baselines, "
            "repro_torch.core.distributed, repro_torch.kernels.ops, "
            "repro_torch.data, repro_torch.serve, repro_torch.persist, "
            "repro_torch.obs, repro_torch.checkpoint, "
            "repro_torch.serve.cluster, "
            "repro_torch.serve.cluster.shard_server, "
            "repro_torch.launch.serve, repro_torch.configs, "
            "repro_torch.models, repro_torch.serve.serving, "
            "repro_torch.launch.dryrun, repro_torch.launch.retrieval_check, "
            "repro_torch.launch.perf_probe, "
            "repro_torch.launch.mesh, repro_torch.models.shardings, "
            "repro_torch.roofline.analysis, repro_torch.roofline.report\n"
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr
