"""Training loop (counterpart of ``repro.train.trainer``).

``make_train_step`` builds the step: the loss and its grads by autograd
over aliases of the f32 master params (microbatched gradient accumulation:
the batch splits on axis 0 into contiguous pieces, grads and metrics are
summed in f32, then divided), then ``adamw_update`` in place.

``Trainer`` adds the production-loop concerns of the reference:
  * checkpoint / restart: batches are a pure function of (seed, step)
    (``data.pipeline``), so a resume needs only (params, opt_state, step)
    and restarts at ``latest_step``, from either package's checkpoint;
  * async checkpointing every ``ckpt_every`` steps, the tensors snapshotted
    to host memory before the writer thread starts;
  * a straggler watchdog that flags a step slower than
    ``straggler_factor`` x the median of the last 20;
  * a non-finite loss skips the step and keeps the old state.

The reference reads ``float(loss)`` after its whole step; here the loss is
read after the grads and before the in-place optimizer update, so that a
non-finite step can still be skipped with the state untouched.  That read
is the one host sync a step, as in the reference.  On the card a step's
time comes from CUDA events around it (start, grads done, update done),
read at the next step's sync: so the watchdog judges step k one step late,
and ``opt_times`` holds each step's optimizer span (from the grads' end,
the host's read of the loss included, to the update's end).  On the CPU
both come from the host clock.  ``grad_norms`` holds each applied step's
pre-clip global grad norm, read from the device once the run ends.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager, latest_step, restore_checkpoint
from ..data.pipeline import DataConfig, synthetic_batch
from ..device import f32_reductions, resolve_device
from ..models.layout import flatten, from_reference, unflatten
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainerConfig", "Trainer", "make_train_step", "TrainStep"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    num_steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    straggler_factor: float = 3.0
    skip_nonfinite: bool = True


class TrainStep:
    """step(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and optimizer state updated in place; ``grads`` and ``update``
    are its two halves."""

    def __init__(self, model, opt_cfg: AdamWConfig, microbatches: int = 1,
                 cast_params_bf16: bool = False):
        self.model = model
        self.opt_cfg = opt_cfg
        self.microbatches = microbatches
        self.cast_params_bf16 = cast_params_bf16

    def _cast(self, params):
        """bf16 copies of the leaves whose reference leaf has rank >= 2
        (every leaf under ``blocks``), inside the differentiated step: the
        grads still arrive in f32 through the cast."""
        if not self.cast_params_bf16:
            return params
        return from_reference(params, lambda path, p, repeat: (
            p.to(torch.bfloat16) if repeat is not None or p.ndim >= 2
            else p))

    def _one(self, params, batch):
        leaves = flatten(params)
        alias = [p.detach().requires_grad_() for p in leaves]
        # the backward (and its recomputed forwards) sums bf16 products in
        # f32, as ``Model.loss`` does
        with torch.enable_grad(), f32_reductions():
            loss, metrics = self.model.loss(
                self._cast(unflatten(params, alias)), batch)
            grads = torch.autograd.grad(loss, alias, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for g, a in zip(grads, alias)]
        return grads, {k: v.detach().float() for k, v in metrics.items()}

    def grads(self, params, batch):
        """(grads in the params' layout, {"nll", "aux", "zloss"}): the
        microbatches' grads and metrics summed in order, then divided."""
        n = self.microbatches
        if n <= 1:
            grads, metrics = self._one(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n:
                raise ValueError(f"batch {b} does not split into {n} "
                                 f"microbatches")
            size = b // n
            grads = metrics = None
            for i in range(n):
                piece = {k: v[i * size:(i + 1) * size]
                         for k, v in batch.items()}
                g, m = self._one(params, piece)
                if grads is None:
                    grads, metrics = g, m
                else:
                    torch._foreach_add_(grads, g)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                del g, m
            torch._foreach_div_(grads, float(n))
            metrics = {k: v / n for k, v in metrics.items()}
        return unflatten(params, grads), metrics

    def update(self, params, grads, opt_state):
        return adamw_update(params, grads, opt_state, self.opt_cfg)

    def __call__(self, params, opt_state, batch):
        grads, metrics = self.grads(params, batch)
        params, opt_state, opt_metrics = self.update(params, grads,
                                                     opt_state)
        return params, opt_state, dict(metrics, **opt_metrics)


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    cast_params_bf16: bool = False) -> TrainStep:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  With microbatches > 1 the batch splits on axis 0 and the
    grads average over the pieces: the same math, 1/microbatches of the
    activation memory.  cast_params_bf16: the matrices (reference rank >= 2)
    are cast to bf16 inside the differentiated step."""
    return TrainStep(model, opt_cfg, microbatches, cast_params_bf16)


class Trainer:
    """Fault-tolerant single-process loop on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, model, opt_cfg: AdamWConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, device="cuda"):
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, opt_cfg, tcfg.microbatches)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.step_times: list[float] = []
        self.opt_times: list[float] = []
        self.grad_norms: list[float] = []
        self.straggler_steps: list[int] = []

    def init_or_restore(self, seed):
        """``Model.init(seed)`` on the device and fresh moments, or the
        latest checkpoint of ``ckpt_dir`` restored into them: (params,
        opt_state, the step to start at)."""
        params = self.model.init(seed, device=self.device)
        opt_state = adamw_init(params, self.opt_cfg)
        start = 0
        last = latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            tree = restore_checkpoint(self.tcfg.ckpt_dir, last,
                                      {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            start = last
        return params, opt_state, start

    def _clock(self, entry: dict, dt: float, opt: float):
        """Record a step's time and judge it against the trailing median."""
        if len(self.step_times) >= 5:
            med = statistics.median(self.step_times[-20:])
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_steps.append(entry["step"])
        self.step_times.append(dt)
        self.opt_times.append(opt)
        if not entry["skipped"]:
            entry["sec"] = dt

    def run(self, seed, num_steps: int | None = None):
        """Train from ``latest_step`` (or from ``Model.init(seed)``) to
        ``num_steps``: (params, opt_state, history), history a dict a step
        with its ``loss`` (the nll), ``skipped`` and ``sec``."""
        params, opt_state, start = self.init_or_restore(seed)
        num_steps = num_steps or self.tcfg.num_steps
        cuda = self.device.type == "cuda"
        history: list[dict] = []
        norms = []                       # 0-d device tensors, read at the end
        pending = None                   # (entry, events) not yet clocked
        for step in range(start, num_steps):
            batch = synthetic_batch(self.data_cfg, step, self.device)
            t0 = time.perf_counter()
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            grads, metrics = self.step_fn.grads(params, batch)
            if cuda:
                ev[1].record()
            loss = float(metrics["nll"])     # the one host sync a step
            t1 = time.perf_counter()
            if pending is not None:          # done: it preceded this sync
                self._clock(pending[0], *_event_times(pending[1]))
                pending = None
            entry = {"step": step, "loss": loss, "skipped": False}
            history.append(entry)
            if self.tcfg.skip_nonfinite and not math.isfinite(loss):
                entry["skipped"] = True      # keep the old state, continue
                opt_metrics = None
            else:
                params, opt_state, opt_metrics = self.step_fn.update(
                    params, grads, opt_state)
                norms.append(opt_metrics["grad_norm"])
            del grads
            if cuda:
                ev[2].record()
                pending = (entry, ev)
            else:
                t2 = time.perf_counter()
                self._clock(entry, t2 - t0, t2 - t1)
            if entry["skipped"]:
                continue
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1,
                                     {"params": params, "opt": opt_state})
            if (step + 1) % self.tcfg.log_every == 0:
                if pending is not None:
                    pending[1][2].synchronize()
                    self._clock(pending[0], *_event_times(pending[1]))
                    pending = None
                print(f"step {step + 1}: loss={loss:.4f} "
                      f"lr={float(opt_metrics['lr']):.2e} "
                      f"{self.step_times[-1] * 1e3:.0f}ms", flush=True)
        if pending is not None:
            pending[1][2].synchronize()
            self._clock(pending[0], *_event_times(pending[1]))
        self.grad_norms.extend(float(g) for g in norms)
        self.ckpt.wait()
        return params, opt_state, history


def _event_times(ev) -> tuple[float, float]:
    """(step seconds, optimizer seconds) of a completed step's events."""
    return ev[0].elapsed_time(ev[2]) / 1e3, ev[1].elapsed_time(ev[2]) / 1e3
