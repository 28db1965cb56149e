"""Feed-forward layers of the dense family (counterpart of
``repro.models.mlp``): the gated MLP (SwiGLU / GeGLU per ``cfg.act``).  The
capacity MoE waits for the other families (ROADMAP A9b)."""

from __future__ import annotations

from .common import activation, dense_init

__all__ = ["init_mlp", "mlp"]


def init_mlp(generator, cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(generator, (d, f)),
        "w_up": dense_init(generator, (d, f)),
        "w_down": dense_init(generator, (f, d)).div_(
            (2.0 * cfg.num_layers) ** 0.5),
    }


def mlp(x, p, cfg):
    dtype = x.dtype
    h = x @ p["w_gate"].to(dtype)
    u = x @ p["w_up"].to(dtype)
    return (activation(h, cfg.act) * u) @ p["w_down"].to(dtype)
