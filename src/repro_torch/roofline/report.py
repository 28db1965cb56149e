"""Render the roofline markdown table from a sweep JSONL (counterpart of
``repro.roofline.report``); a term the port does not reckon (the
collective) prints as ``-``.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_single_pod.json
"""

from __future__ import annotations

import json
import sys

__all__ = ["load", "fmt_s", "main"]


def load(path):
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(l) for l in text.splitlines() if l.strip()]


def fmt_s(x):
    if x is None:
        return "-"
    return f"{x * 1e3:.1f}ms" if x < 10 else f"{x:.2f}s"


def main(path: str):
    rows = load(path)
    print("| arch | shape | mesh | compute | memory | collective | dominant "
          "| useful | GiB/dev | fits | mb |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r.get("status") == "skip":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                  f"skip (full-attn @500k) | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAIL | | | "
                  f"{r.get('error', '')[:40]} | | | | |")
            continue
        gib = r.get("bytes_per_device", 0) / 2 ** 30
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {fmt_s(r.get('compute_s'))} | {fmt_s(r.get('memory_s'))} "
              f"| {fmt_s(r.get('collective_s'))} | {r.get('dominant', '-')} "
              f"| {r.get('useful_ratio', 0):.3f} | {gib:.2f} "
              f"| {r.get('fits_hbm', '-')} | {r.get('microbatches', '-')} |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         "results/dryrun_single_pod.json")
