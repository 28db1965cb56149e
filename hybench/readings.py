"""Readings for the limits of ``correct``: the program's numbers over many
seeds, and the control's, in one process.

    python -m hybench.readings --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control]

Each seed is one run of the cell (``hybench.run.run_cell``) with a window
of ``--seconds``.  With ``--control`` the plain reference, computed in the
precision the configuration names under ``control``, answers every
request in the program's place.  Prints one JSON line a seed with the
compared numbers.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def control_search(precision: str, block: int):
    """``wrap_search`` for ``run_cell``: the reference in ``precision``
    answers each request in the program's place."""
    def wrap(send, built):
        from hybench import reference

        def answer(rows):
            sc = built.scorer(rows, precision)
            s, i = reference.three_pass(sc, h=built.h, c1=built.c1,
                                        c2=built.c2, block=block)[:2]
            return (s.float().cpu().numpy(),
                    built.prog_ids(i.cpu().numpy()))
        return answer
    return wrap


def main(argv=None) -> int:
    from hybench import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    run.prepare_environment()
    import torch
    from hybench.spec import Bench
    bench = Bench(run.ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("hybench.readings: no CUDA device", file=sys.stderr)
        return 2
    cfg = cell.config
    wrap = (control_search(cfg["control"], cfg["reference_block"])
            if args.control else None)
    for seed in args.seeds:
        res = run.run_cell(bench, cell, seed=seed, seconds=args.seconds,
                           trace=False, wrap_search=wrap)
        print(json.dumps({"seed": seed, "control": args.control,
                          "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v
                                      in res["metrics"].items()},
                          "checks": {k: v["value"] for k, v
                                     in res["checks"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
