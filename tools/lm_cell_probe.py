#!/usr/bin/env python3
"""One decode cell of ``chip_smoke.py`` (``decode_cell``) on one GPU, without
the rest of the smoke run.

    python3 tools/lm_cell_probe.py [--arch qwen2-moe-a2.7b] [--layers N]
        [--exact-only] [--bf16-reduced-precision]

Builds the kernels, then runs ``chip_smoke.decode_cell`` at the config's
full width and depth, random weights from a seeded generator on the card:
decode against forward on the f32 tree (MoE at capacity_factor 16) and in
bf16, ``greedy_generate(donate=True)`` at B = 1 and 32 with the exact and
(unless ``--exact-only``) the PQ head, the timed lockstep loop, and for a
MoE config the prefill's drop share at its own capacity_factor and the
layers where decode and forward route tokens to other experts.  A failed
check is printed with its reading (the bf16 decode-vs-forward check: the
rel beside its bound and, for a MoE config, the route flips by layer), and
the probe exits 1.  ``--layers`` cuts the depth;
``--bf16-reduced-precision`` runs the models' methods without their
``repro_torch.device.f32_reductions`` rule, so cuBLAS may sum bf16
products in reduced precision, PyTorch's default: the route of ROADMAP C9.

Prints the card's name and power limit, then one JSON object with the
cell's fields (or the failed check), ``max_memory_allocated`` and the
cell's seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--exact-only", action="store_true")
    ap.add_argument("--bf16-reduced-precision", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_cell_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.bf16_reduced_precision:
        for name in ("forward", "loss", "prefill", "decode_step"):
            setattr(Model, name, getattr(Model, name).__wrapped__)
    print(cs.smi_line(), flush=True)
    build_s = _build.build()["seconds"]
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    check_cfg = (dataclasses.replace(cfg, capacity_factor=16.0)
                 if cfg.family == "moe" else None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        fields, k1, sess = cs.decode_cell(torch, cfg,
                                          pq=not args.exact_only,
                                          check_cfg=check_cfg)
        if cfg.family == "moe":
            fields["prefill_drops"] = cs.moe_drop_share(torch, sess)
        fields["k1_launches"] = k1
    except AssertionError as e:          # chip_smoke.check's failure
        fields = {"config": cfg.name, "layers": cfg.num_layers,
                  "failed_check": str(e)}
    print(json.dumps({"build_s": build_s, "bf16_reduced_precision":
                      args.bf16_reduced_precision, **fields,
                      "max_memory_allocated":
                      torch.cuda.max_memory_allocated(),
                      "seconds": time.perf_counter() - t0}), flush=True)
    print(cs.smi_line(), flush=True)
    return 1 if "failed_check" in fields else 0


if __name__ == "__main__":
    sys.exit(main())
