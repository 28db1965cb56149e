"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all started
together) into ``build/repro_torch_kernels/<hash>/lib<name>.so`` at the root
of the checkout, a shared library with a plain C interface that ``ctypes``
loads.  ``<hash>`` covers the sources and the flags, so an edited source
builds anew and an unchanged one is reused.  Nothing here runs at import
time: the first CUDA launch of a kernel triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME or in "
                       "/usr/local/cuda: the repro_torch kernels cannot be "
                       "built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile every source that is not built yet, in parallel.

    Returns ``{"dir", "seconds", "built", "ptxas"}``: the build directory,
    the wall seconds this call spent, the sources it compiled and, per
    source, nvcc's ``-Xptxas -v`` report (registers, shared memory, spills).
    Raises ``RuntimeError`` with nvcc's stderr when a source fails."""
    with _lock:
        if _build_info:
            return dict(_build_info)
        t0 = time.perf_counter()
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [s for s in _sources()
                if not (out_dir / f"lib{s.stem}.so").exists()]
        procs = []
        nvcc = _nvcc() if todo else ""
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for src, tmp, proc in procs:
            out, err = proc.communicate()
            (out_dir / f"{src.stem}.log").write_text(out + err)
            if proc.returncode != 0:
                failures.append(f"nvcc {src.name} (exit {proc.returncode}):"
                                f"\n{err}")
            else:
                os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if failures:
            raise RuntimeError("building the repro_torch kernels failed:\n"
                               + "\n".join(failures))
        ptxas = {}
        for src in _sources():
            log = out_dir / f"{src.stem}.log"
            ptxas[src.stem] = (log.read_text() if log.exists() else "")
        _build_info.update(dir=str(out_dir),
                           seconds=time.perf_counter() - t0,
                           built=[s.name for s in todo], ptxas=ptxas)
        return dict(_build_info)


def load(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>.so`` and declare each C
    function's ``argtypes`` and ``restype`` from ``signatures``."""
    info = build()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(Path(info["dir"]) / f"lib{name}.so"))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib
