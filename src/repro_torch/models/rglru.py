"""Griffin / RecurrentGemma recurrent block (RG-LRU), arXiv:2402.19427
(counterpart of ``repro.models.rglru``).

Block: x -> {gate branch: linear -> GeLU (tanh form)} * {recurrent branch:
linear -> causal conv1d (width 4) -> RG-LRU} -> linear out.

RG-LRU (Real-Gated LRU), c = 8:
  r_t = sigmoid(W_a x_t + b_a)          recurrence gate
  i_t = sigmoid(W_x x_t + b_x)          input gate
  log a_t = -c * softplus(lam) * r_t    per-channel decay (lam in f32)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the diagonal recurrence as a log-depth scan over S
(Hillis-Steele doubling; the reference's ``associative_scan`` pairs the
terms in another order, so f32 results agree to rounding, not bit for
bit); decode is the O(1) update.  The state ``h`` is f32, the conv state is
in the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init, draw_source

__all__ = ["init_rglru", "rglru_block", "rglru_decode_init",
           "rglru_decode_step", "linear_scan"]

_C = 8.0


def init_rglru(generator, cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = generator.device
    conv_w = torch.empty((4, w), device=dev)
    conv_w.normal_(generator=draw_source(generator)).mul_(0.1)
    # a^c in [0.9, 0.999] at init, as in the paper
    a_c = torch.linspace(0.9, 0.999, w, device=dev)
    return {
        "w_gate": dense_init(generator, (d, w)),        # GeLU branch
        "w_rec": dense_init(generator, (d, w)),         # recurrent branch
        "conv_w": conv_w,
        "conv_b": torch.zeros((w,), device=dev),
        "wa": dense_init(generator, (w, w)),
        "ba": torch.zeros((w,), device=dev),
        "wx": dense_init(generator, (w, w)),
        "bx": torch.zeros((w,), device=dev),
        "lam": torch.log(torch.expm1(-torch.log(a_c) / _C)),
        "out": dense_init(generator, (w, d)).div_(
            (2.0 * cfg.num_layers) ** 0.5),
    }


def _conv(x, w, b, state=None):
    k = w.shape[0]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2]))
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    return y + b.to(x.dtype), xp[:, -(k - 1):, :]


def _gates(xr, p, dtype):
    r = torch.sigmoid(xr @ p["wa"].to(dtype) + p["ba"].to(dtype))
    i = torch.sigmoid(xr @ p["wx"].to(dtype) + p["bx"].to(dtype))
    log_a = -_C * F.softplus(p["lam"].float()) * r.float()   # (B,S,W)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta, i


def linear_scan(a, v):
    """h_t = a_t h_{t-1} + v_t over dim 1 from h_{-1} = 0, in
    ceil(log2 S) doubling steps: after the step of offset o each position
    holds the pair (product of a, sum) over its last 2o positions."""
    s = a.shape[1]
    for o in (1 << j for j in range(math.ceil(math.log2(max(s, 1))))):
        v = torch.cat([v[:, :o], v[:, o:] + a[:, o:] * v[:, :-o]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
    return v


def rglru_block(x, p, cfg, return_state: bool = False):
    """Prefill path.  x (B,S,D) -> (B,S,D); with return_state also the
    decode state after the sequence."""
    dtype = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dtype), approximate="tanh")
    xr_raw = x @ p["w_rec"].to(dtype)
    xr, _ = _conv(xr_raw, p["conv_w"], p["conv_b"])
    a, beta, i = _gates(xr, p, dtype)
    v = beta * i.float() * xr.float()                        # (B,S,W) f32
    h = linear_scan(a, v)
    out = (h.to(dtype) * gate) @ p["out"].to(dtype)
    if return_state:
        return out, {"conv": xr_raw[:, -3:, :], "h": h[:, -1]}
    return out


def rglru_decode_init(cfg, batch: int, dtype, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
            "h": torch.zeros((batch, w), device=device)}


def rglru_decode_step(x, p, cfg, state):
    """x (B,1,D) -> (B,1,D) and the new state: the O(1) update."""
    dtype = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dtype), approximate="tanh")
    xr = x @ p["w_rec"].to(dtype)
    xr, conv_state = _conv(xr, p["conv_w"], p["conv_b"], state=state["conv"])
    a, beta, i = _gates(xr, p, dtype)
    v = beta * i.float() * xr.float()
    h = a[:, 0] * state["h"] + v[:, 0]                       # (B,W)
    out = (h[:, None, :].to(dtype) * gate) @ p["out"].to(dtype)
    return out, {"conv": conv_state, "h": h}
