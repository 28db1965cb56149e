"""Training launcher (counterpart of ``repro.launch.train``), on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch stablelm-1.6b-smoke --steps 100 --batch 8 --seq 128 \
        --ckpt /path/to/ckpt_run

Any registered config (full or -smoke) is accepted.  Random weights from
``--seed``, the synthetic stream of ``data.pipeline`` (seeded by ``--seed``
too), AdamW with a warm-up of steps / 20 and a cosine to ``--steps``.  A
run whose ``--ckpt`` directory holds a checkpoint resumes from it; the
default directory lies under the system's temp dir.  Prints a line every
10 steps and ``done: loss a -> b``.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: repro_torch_launch_train "
                         "under the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_launch_train")
    trainer = Trainer(
        Model(cfg),
        AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 20, 1),
                    decay_steps=args.steps),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=args.seed),
        TrainerConfig(num_steps=args.steps, microbatches=args.microbatches,
                      ckpt_every=args.ckpt_every, ckpt_dir=ckpt),
        device=args.device)
    _, _, hist = trainer.run(args.seed)
    losses = [h["loss"] for h in hist if not h.get("skipped")]
    if not losses:
        print(f"done: no step to run ({ckpt} is at step {args.steps} or "
              f"later)")
        return
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
