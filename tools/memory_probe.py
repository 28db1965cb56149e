#!/usr/bin/env python3
"""The dry run's memory proof held to the card, without the rest of
``chip_smoke.py``: its ``train_memory_proof`` and ``decode_memory_proof``
on one GPU.

    python3 tools/memory_probe.py [--skip-train] [--skip-decode]

Train: stablelm-1.6b at full width and depth, f32 params from a seeded
generator on the card, B = 8, S = 512 (``chip_smoke.TRAIN_B`` /
``TRAIN_S``), reckoned on a one-device mesh at microbatches 1 and 2 and
measured over one step of each from a warmed state.  Decode: qwen2-7b's
f32 tree, one ``decode_step`` at B = 1 and 32 on an empty state of
``chip_smoke.DECODE_MAX_LEN`` slots, against its reckoning.  Each reading
names the ops whose CUDA kernels held buffers of their own
(``hidden_buffers``, one more step under a dispatch mode): the tool for
finding the op to count in ``roofline.analysis._INNER_BYTES`` when the
smoke's band check fails.

Prints the card's name and power limit, then one JSON object with the
readings (or the failed band check) and the seconds; exits 1 if a ratio
falls outside ``chip_smoke.MEM_BAND``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]

HIDDEN_FLOOR = 1 << 20      # an op's own buffer worth naming


def _flat_tensors(x) -> list:
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    return []


def hidden_buffers(torch, fn, *args) -> dict:
    """The ops of one call whose CUDA kernels held buffers of their own: an
    op's peak over the memory allocated before it, less the new storages it
    returned (in the allocator's blocks), where that reaches
    ``HIDDEN_FLOOR``; the largest a name.  A dispatch mode sees the ops
    that autograd's device thread runs too, and turns the index backward's
    in-place put into ``index_put`` (``analysis._OUT_OF_PLACE_UNDER_MODES``),
    whose copy is its output here, not a hidden buffer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.roofline.analysis import block_bytes

    found = {}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = {id(t.untyped_storage())
                   for t in _flat_tensors((args, kwargs))}
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = func(*args, **kwargs)
            new = {id(t.untyped_storage()):
                   block_bytes(t.untyped_storage().nbytes())
                   for t in _flat_tensors(out)
                   if id(t.untyped_storage()) not in ins}
            hidden = (torch.cuda.max_memory_allocated() - before
                      - sum(new.values()))
            if hidden >= HIDDEN_FLOOR:
                found[str(func)] = max(found.get(str(func), 0), hidden)
            return out

    with Mode():
        out = fn(*args)
    torch.cuda.synchronize()
    del out
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-decode", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("memory_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    try:
        if not args.skip_train:
            cfg = get_config(cs.TRAIN_ARCH)
            ocfg = AdamWConfig(lr_peak=cs.TRAIN_LR,
                               warmup_steps=cs.TRAIN_WARMUP,
                               decay_steps=cs.TRAIN_STEPS)
            params = Model(cfg).init(
                torch.Generator(device="cuda").manual_seed(0), device="cuda")
            batch = synthetic_batch(
                DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_S,
                           global_batch=cs.TRAIN_B, seed=0), 0, "cuda")
            out["train"] = cs.train_memory_proof(torch, cfg, ocfg, params,
                                                 batch, None, hidden_buffers)
            del params, batch
            gc.collect()
            torch.cuda.empty_cache()
        if not args.skip_decode:
            cfg = get_config(cs.DECODE_ARCH)
            model = Model(cfg)
            g = torch.Generator(device="cuda").manual_seed(0)
            params = model.init(g, device="cuda")
            prompts = {b: torch.randint(0, cfg.vocab_size,
                                        (b, cs.DECODE_PROMPT), generator=g,
                                        device="cuda")
                       for b in cs.DECODE_BATCHES}
            out["decode"] = cs.decode_memory_proof(torch, model, cfg, params,
                                                   prompts, hidden_buffers)
        rc = 0
    except AssertionError as e:
        out["failed"] = str(e)
        rc = 1
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, default=str), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
