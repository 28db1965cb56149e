"""Perf-iteration probe (counterpart of ``repro.launch.perf_probe``):
one cell's roofline terms from the counted 1x/2x-pattern steps (no
full-depth count) under config overrides, appended to
``results/perf_log.jsonl``.

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch qwen3-moe-235b-a22b \
        --shape train_4k --set attn_chunk=1024 --note "bigger attn chunk"

The terms are the eager step's op-by-op counts (``roofline.cost_of`` on
``meta`` tensors) over the ``H100`` constants, split evenly over the
production mesh's chips; no collective is reckoned.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import time

from ..configs import SHAPES, get_config
from ..roofline.analysis import H100, model_flops
from .dryrun import OPT_CFG, probe_costs
from .mesh import make_production_mesh

__all__ = ["parse_overrides", "probe", "main"]


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v == "true":
            v = True
        if v == "false":
            v = False
        out[k] = v
    return out


def probe(arch: str, shape_name: str, overrides: dict | None = None,
          rules: dict | None = None, verbose: bool = True) -> dict:
    """The cell's terms.  ``rules`` (logical-axis overrides) is accepted
    for the reference's signature; the reference's probe ignores it too."""
    cfg = get_config(arch)
    if overrides:
        cfg = dc.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh()

    t0 = time.time()
    flops, bytes_ = probe_costs(cfg, shape, OPT_CFG)
    terms = {
        "arch": arch, "shape": shape_name,
        "overrides": overrides or {},
        "compute_s": flops / mesh.size / H100["peak_flops"],
        "memory_s": bytes_ / mesh.size / H100["hbm_bw"],
        "collective_s": None,
        "model_flops": model_flops(cfg, shape),
        "hlo_flops_job": flops,
        "probe_s": time.time() - t0,
    }
    terms["dominant"] = max(("compute", "memory"),
                            key=lambda k: terms[f"{k}_s"])
    terms["useful_ratio"] = (terms["model_flops"] / terms["hlo_flops_job"]
                             if terms["hlo_flops_job"] else 0.0)
    if verbose:
        print(f"{arch} × {shape_name} {overrides or ''}: "
              f"compute {terms['compute_s']*1e3:.2f}ms "
              f"memory {terms['memory_s']*1e3:.2f}ms "
              f"collective - "
              f"dominant={terms['dominant']} "
              f"useful={terms['useful_ratio']:.3f} "
              f"[probe {terms['probe_s']:.0f}s]")
    return terms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", nargs="*", default=None,
                    help="config overrides k=v (e.g. attn_chunk=1024)")
    ap.add_argument("--note", default="")
    ap.add_argument("--log", default="results/perf_log.jsonl")
    args = ap.parse_args(argv)
    terms = probe(args.arch, args.shape, parse_overrides(args.set))
    terms["note"] = args.note
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    with open(args.log, "a") as f:
        f.write(json.dumps(terms) + "\n")


if __name__ == "__main__":
    main()
