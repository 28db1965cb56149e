"""Shared model plumbing (counterpart of ``repro.models.common``): the
logical-axis rule table and its resolution into per-dim mesh axes, norms,
RoPE, the fan-in init and the MLP activations.

The reference's model code annotates tensors with *logical* axis names and
a context-installed rule set maps them to mesh axes.  The port runs no SPMD
program, so ``logical_constraint`` (``with_sharding_constraint``) is not
ported; the rest is arithmetic on a mesh's axis names and sizes and is:
``resolve_spec`` gives the spec the reference's ``PartitionSpec`` holds, as
a plain tuple (one entry a dim: None, an axis name, or a tuple of names),
which ``models/shardings.py`` and ``launch/dryrun.py`` read to reckon each
device's share of a cell's arrays on a ``launch.mesh.LogicalMesh``.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["DEFAULT_RULES", "sharding_rules", "resolve_spec", "current_mesh",
           "logical_spec", "compute_dtype", "rms_norm", "layer_norm",
           "apply_norm", "init_norm", "rope", "rope_angles", "apply_rope",
           "META_DRAWS", "draw_source", "dense_init", "activation"]

_STATE = threading.local()

# logical axis -> mesh axis (or tuple), as the reference's table
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",          # demoted to None when heads % shards != 0
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "capacity": None,
    "fsdp": "data",               # parameter sharding axis
    "kv_seq": "model",            # decode-time KV cache sequence sharding
    "state": "model",             # recurrent state width
    "cond": None,
    "moe_tokens": "model",        # MoE dispatch token axis (EP all-to-all)
}


@contextlib.contextmanager
def sharding_rules(mesh, rules: dict | None = None):
    """Install (mesh, rules) for the block: ``current_mesh`` returns the
    mesh inside it."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        yield
    finally:
        _STATE.ctx = prev


def resolve_spec(mesh, rules, names, shape) -> tuple:
    """Map logical axis names -> a spec tuple, claiming each mesh axis at
    most once and *only* when it divides the dimension (so 28 heads on a
    16-way model axis degrade to replication, and a later logical axis may
    claim the freed mesh axis).  ``mesh`` needs ``axis_names`` and
    ``shape`` (axis -> size); the result has one entry a (name, dim) pair,
    as the reference's ``PartitionSpec`` does."""
    axes = []
    used: set[str] = set()
    for nm, dim in zip(names, shape):
        ax = rules.get(nm) if nm is not None else None
        if ax is None:
            axes.append(None)
            continue
        cand = []
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a in mesh.axis_names and a not in used:
                cand.append(a)
                size *= mesh.shape[a]
        # greedy shrink until it divides
        while cand and (dim % size != 0 or dim < size):
            size //= mesh.shape[cand.pop()]
        used.update(cand)
        axes.append(tuple(cand) if len(cand) > 1 else
                    (cand[0] if cand else None))
    return tuple(axes)


def current_mesh():
    """Mesh installed by sharding_rules (None outside one)."""
    ctx = getattr(_STATE, "ctx", None)
    return ctx[0] if ctx else None


def logical_spec(mesh, shape, *names, rules: dict | None = None) -> tuple:
    """The spec of an array of ``shape`` whose dims carry ``names``."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return resolve_spec(mesh, rules, names, shape)


def compute_dtype(cfg) -> torch.dtype:
    """The activations' dtype: bf16 for ``"bfloat16"``, else f32 (as the
    reference's ``jnp.bfloat16 if cfg.dtype == "bfloat16" else f32``)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back; ``scale`` is stored as ``1 + scale``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x, p, kind: str):
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def init_norm(d: int, kind: str, device="cuda") -> dict:
    """A norm's f32 params on ``device`` (the card unless the caller asks
    for the CPU)."""
    device = resolve_device(device)
    if kind == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.zeros((d,), device=device)}  # rms: (1 + scale)


def rope_angles(positions: torch.Tensor, hd: int, theta: float,
                fraction: float = 1.0):
    """(cos, sin) of RoPE at ``positions`` (broadcastable to (..., S)), each
    (..., S, 1, half) f32; None when no dim rotates.  A layer stack at one
    set of positions computes them once and shares them."""
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return None
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None, None].float() * freq    # (..., S, 1, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, angles) -> torch.Tensor:
    """Rotate the leading dims of ``x`` (..., S, H, hd) by ``rope_angles``:
    the products in f32, cast back to ``x``'s dtype."""
    if angles is None:
        return x
    cos, sin = angles
    half = cos.shape[-1]
    rot = 2 * half
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of head dims.

    x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return apply_rope(x, rope_angles(positions, x.shape[-1], theta, fraction))


class _MetaDraws:
    """Stands for a generator on the ``meta`` device, where no
    ``torch.Generator`` exists: an init given it makes tensors of the
    drawn shapes and dtypes and draws nothing."""
    device = torch.device("meta")


META_DRAWS = _MetaDraws()


def draw_source(generator):
    """The ``generator=`` argument of an in-place draw: None for
    ``META_DRAWS`` (nothing is drawn on ``meta``)."""
    return None if generator is META_DRAWS else generator


def dense_init(generator: torch.Generator, shape,
               in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init, f32 master weights: N(0, 1) cut to
    [-2, 2] (by inverting the normal CDF on a uniform draw, as
    ``torch.nn.init.trunc_normal_`` does), times ``fan_in ** -0.5`` with
    ``fan_in = shape[in_axis]``, on ``generator``'s device (``META_DRAWS``:
    on ``meta``, shapes only)."""
    lo = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    if generator is META_DRAWS:
        return t
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t.mul_(shape[in_axis] ** -0.5)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``jax.nn.gelu`` (its tanh approximation) or ``jax.nn.silu``."""
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)
