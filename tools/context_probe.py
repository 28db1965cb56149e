#!/usr/bin/env python3
"""Do processes that share one GPU overlap or time-slice?

    python3 tools/context_probe.py [--iters N]

A one-thread kernel runs a chain of ``--iters`` dependent FMAs (default
5e7): work that advances only while the kernel is scheduled, on one SM.
It is timed in one process alone, then in two and in four processes at
once, each started together once every process holds its CUDA context.
Contexts that time-slice take n times as long each; contexts that overlap
take as long as alone.  (``torch.cuda._sleep`` spins on the clock, which
runs on while a context is switched out, so it cannot tell the two apart.)

The cluster tier runs a primary, its scorers and a replica as processes of
their own; on one card without MPS they share it this way.

Prints the card's name and power limit, then one JSON object of wall ms
per process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]

_CHAIN_CU = r"""
extern "C" __global__ void chain_kernel(float* out, long long n) {
    float x = out[0] + 1.0f;
    for (long long i = 0; i < n; ++i) x = x * 0.999999f + 1e-7f;
    out[0] = x;
}
extern "C" int chain(float* out, long long n, void* stream) {
    chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, n);
    return (int)cudaGetLastError();
}
"""
_CHAIN_CHILD = """
import ctypes, json, sys, time, torch
lib = ctypes.CDLL(sys.argv[1])
out = torch.zeros(1, device="cuda")
def run(n):
    code = lib.chain(ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(n),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert code == 0, code
    torch.cuda.synchronize()
run(1000)
print("READY", flush=True)
sys.stdin.readline()
t0 = time.perf_counter()
run(int(sys.argv[2]))
print(json.dumps({"ms": (time.perf_counter() - t0) * 1e3}), flush=True)
"""


def build_chain_kernel() -> str:
    """nvcc the FMA-chain kernel into build/context_probe/; its path."""
    from repro_torch.kernels import _build
    out = os.path.join(REPO, "build", "context_probe")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "chain.cu"), os.path.join(out, "libchain.so")
    with open(src, "w") as f:
        f.write(_CHAIN_CU)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True, capture_output=True, timeout=300)
    return lib


def chain_processes(lib: str, n: int, iters: int) -> list[float]:
    """Wall ms of one FMA-chain kernel of ``iters`` steps in each of ``n``
    processes on cuda:0, started together once every context is made."""
    procs = [subprocess.Popen([sys.executable, "-c", _CHAIN_CHILD, lib,
                               str(iters)], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    try:
        for p in procs:
            if p.stdout.readline().strip() != "READY":
                raise RuntimeError("a probe process did not start")
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        out = [json.loads(p.stdout.readline())["ms"] for p in procs]
        for p in procs:
            if p.wait(timeout=120) != 0:
                raise RuntimeError("a probe process failed")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50_000_000,
                    help="dependent FMAs in the chain (default 5e7)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("context_probe: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import smi_line
    print(smi_line(), flush=True)
    lib = build_chain_kernel()
    print(json.dumps({
        "chain_iters": args.iters,
        "alone_ms": chain_processes(lib, 1, args.iters),
        "two_processes_ms": chain_processes(lib, 2, args.iters),
        "four_processes_ms": chain_processes(lib, 4, args.iters)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
