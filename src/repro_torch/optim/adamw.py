"""AdamW with global-norm clipping, a cosine schedule and optional int8 or
bf16 moments (counterpart of ``repro.optim.adamw``).

The reference's arithmetic, element for element, not ``torch.optim.AdamW``:
the grads are clipped by their global norm first, decay enters the step as
``p - lr * (update + wd * p)``, the schedule and the int8 moment blocks are
its own.  ``adamw_update`` works in place under ``torch.no_grad()``, one
``torch._foreach_*`` op at a time over each reference leaf's tensors (no
new kernel), and reads nothing back to the host: the step, the learning
rate and the bias corrections stay 0-d tensors on the device.  Where the
reference rounds twice (``b1 * m + (1 - b1) * g``), an op here may round
once (``add_`` with ``alpha``, ``addcmul_``): an element differs from the
reference's by an ulp at most there, not by the order of a sum.

Two rules go by the reference's tree, not the port's per-layer tensors
(``models.layout``; a reference leaf under ``params["blocks"][pos]`` is the
stack of one leaf over the repeats):

  * weight decay applies where the reference leaf has rank >= 2: every
    leaf under ``blocks`` (a block's norm scale and bias and its QKV bias
    included, their stacked rank being 2 or more), and elsewhere by the
    leaf's own rank (``final_norm`` and a tail layer's norms and biases are
    not decayed);
  * int8 moments are block-quantized over the reference leaf: its
    per-layer tensors concatenated in repeat order, flattened in C order,
    padded to a multiple of ``quant_block`` and scaled a block of 256 (a
    block may straddle two layers); a leaf smaller than one block keeps
    ``moment_dtype``.

So the moments ``opt_state["m"]`` / ``["v"]`` follow the reference's
layout: a blocks position is one dict of stacked (R, ...) moments, or of
{"q": (nblk, 256) int8, "scale": (nblk, 1) f32}, and the checkpoint writes
them under the reference's names (``opt/m/blocks/0/attn/wq/q``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.layout import named_leaves, to_reference

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_moments: bool = False   # int8 block-quantized m/v
    quant_block: int = 256
    moment_dtype: str = "float32"    # "bfloat16" halves the moments' bytes


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr_peak``, then a cosine down to ``lr_min`` at
    ``decay_steps``; f32, in the reference's order of operations."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(
        math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _leaf_tensors(tree) -> list:
    return [t for _, ts, _ in named_leaves(tree) for t in ts]


def _norm(tensors) -> torch.Tensor:
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return _norm(_leaf_tensors(tree))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled by min(1, max_norm / norm), in new tensors of each
    leaf's dtype; the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return (x * scale).to(x.dtype)
    return walk(tree), norm


# ---------------------------------------------------------------------------
# int8 block quantization for moments (optional)
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor, block: int):
    """x (any shape) -> (q (nblk, block) int8, scale (nblk, 1) f32): C-order
    flat, zero-padded to a multiple of ``block``, one scale a block of
    max|x| / 127; q rounds half to even."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.float()


def _dequantize(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ---------------------------------------------------------------------------

def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """{"step": int32 (), "m", "v"}: zero moments in the reference's layout
    (a blocks position's leaves stacked over its repeats), each an int8
    block-quantized dict where ``quantize_moments`` and the reference leaf
    holds at least one block, else ``moment_dtype``; on the params'
    device."""
    mdt = _moment_dtype(cfg)

    def zeros(shape, device):
        n = math.prod(shape)
        if cfg.quantize_moments and n >= cfg.quant_block:
            nblk = -(-n // cfg.quant_block)
            return {"q": torch.zeros((nblk, cfg.quant_block), dtype=torch.int8,
                                     device=device),
                    "scale": torch.zeros((nblk, 1), device=device)}
        return torch.zeros(shape, dtype=mdt, device=device)

    def one(p):
        return zeros(tuple(p.shape), p.device)

    def stacked(ps):
        return zeros((len(ps),) + tuple(ps[0].shape), ps[0].device)

    device = _leaf_tensors(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": to_reference(params, leaf=one, stack=stacked),
            "v": to_reference(params, leaf=one, stack=stacked)}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and ``opt_state`` are updated
    and returned, with metrics {"lr", "grad_norm", "step"} (0-d tensors).
    ``grads`` has the params' layout (f32 or any float dtype); the clip's
    scale is applied to one reference leaf's grads at a time as the leaf is
    updated, not to a copy of the whole tree."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    lr = cosine_schedule(cfg, step)
    gnorm = _norm(_leaf_tensors(grads))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1.0 - torch.pow(cfg.b1, step.float())
    bc2 = 1.0 - torch.pow(cfg.b2, step.float())
    for (path, ps, stacked), (_, gs, _) in zip(named_leaves(params),
                                                named_leaves(grads)):
        m, v = _at(opt_state["m"], path), _at(opt_state["v"], path)
        shape = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
        g = torch._foreach_mul([x.float() for x in gs], scale)
        if isinstance(m, dict):
            m_f = _dequantize(m["q"], m["scale"], shape)
            v_f = _dequantize(v["q"], v["scale"], shape)
        elif m.dtype == torch.float32:
            m_f, v_f = m, v                       # updated in place
        else:
            m_f, v_f = m.float(), v.float()
        m_l = list(m_f.unbind(0)) if stacked else [m_f]
        v_l = list(v_f.unbind(0)) if stacked else [v_f]
        torch._foreach_mul_(m_l, cfg.b1)
        torch._foreach_add_(m_l, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v_l, cfg.b2)
        torch._foreach_addcmul_(v_l, g, g, value=1 - cfg.b2)
        del g
        den = torch._foreach_div(v_l, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(m_l, bc1)
        torch._foreach_div_(upd, den)
        del den
        if len(shape) >= 2 and cfg.weight_decay:
            torch._foreach_add_(upd, ps, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ps, upd)
        del upd
        if isinstance(m, dict):
            for store, full in ((m, m_f), (v, v_f)):
                q, s = _quantize(full, cfg.quant_block)
                store["q"].copy_(q)
                store["scale"].copy_(s)
        elif m_f is not m:
            m.copy_(m_f)
            v.copy_(v_f)
    metrics = {"lr": lr, "grad_norm": gnorm, "step": step.clone()}
    return params, opt_state, metrics
