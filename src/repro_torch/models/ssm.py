"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060 (counterpart
of ``repro.models.ssm``).

Prefill runs the chunked SSD algorithm: within a chunk the terms are dense
"attention-like" products, across chunks a linear recurrence over the
chunks' summary states (a loop of S / chunk steps).  Decode is the O(1)
recurrent update.

Layout (n_groups = 1):
  in_proj : D -> [z (d_in), xBC (d_in + 2N), dt (H)]
  conv1d  : causal depthwise width-4 over xBC
  SSD     : x (B,S,H,P), dt (B,S,H), A (H,) negative, b, c (B,S,N)
  out     : y * silu(z) -> RMSNorm -> out_proj (d_in -> D)

As in the reference, ``dt`` is formed in f32 (``dt + dt_bias``, softplus)
and cast to the compute dtype, ``A = -exp(a_log)`` is taken in f32 and
cast, and the decode state ``ssm`` is kept in the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init, draw_source, rms_norm

__all__ = ["init_ssd", "ssd_chunked", "ssd_block", "ssd_decode_init",
           "ssd_decode_step"]


def _dims(cfg):
    # ssm_expand may be a fraction (an inner width below d_model), so long
    # as the width it gives is whole
    d_in = cfg.ssm_expand * cfg.d_model
    if d_in != int(d_in):
        raise ValueError(f"ssm_expand {cfg.ssm_expand} x d_model "
                         f"{cfg.d_model} is not a whole width")
    d_in = int(d_in)
    heads = d_in // cfg.ssm_headdim
    return d_in, heads, cfg.ssm_state, cfg.ssm_headdim


def init_ssd(generator, cfg) -> dict:
    d = cfg.d_model
    d_in, h, n, _ = _dims(cfg)
    dev = generator.device
    conv_ch = d_in + 2 * n
    conv_w = torch.empty((cfg.ssm_conv, conv_ch), device=dev)
    conv_w.normal_(generator=draw_source(generator)).mul_(0.1)
    return {
        "in_proj": dense_init(generator, (d, 2 * d_in + 2 * n + h)),
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.full((h,), math.log(math.expm1(0.01)), device=dev),
        "d_skip": torch.ones((h,), device=dev),
        "norm": torch.zeros((d_in,), device=dev),
        "out_proj": dense_init(generator, (d_in, d)).div_(
            (2.0 * cfg.num_layers) ** 0.5),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x (B,S,C); w (K,C); state (B,K-1,C) for
    decode.  Returns (y, new_state): the last K-1 inputs, pre-activation."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return y, new_state


def _split_proj(proj, cfg):
    d_in, _, n, _ = _dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """SSD scan.  x (B,S,H,P); dt (B,S,H); a (H,) negative; b, c (B,S,N).
    Returns (B,S,H,P) and the final state (B,H,P,N).  S off the chunk is
    padded on the right with dt = 0 tokens: zero contribution, decay 1."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    lc = min(chunk, s)
    s_orig = s
    if s % lc:
        pad = lc - s % lc
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        s = s + pad
    nc = s // lc

    xd = x * dt[..., None]                               # dt-weighted input
    la = a[None, None, :] * dt                           # log-decay a token
    xc = xd.reshape(bt, nc, lc, h, p)
    lac = la.reshape(bt, nc, lc, h)
    bc = b.reshape(bt, nc, lc, n)
    cc = c.reshape(bt, nc, lc, n)

    cum = torch.cumsum(lac, dim=2)                       # (B,nc,Lc,H)

    # within a chunk: L[i, j] = exp(cum_i - cum_j) for i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Li,Lj,H)
    ii = torch.arange(lc, device=x.device)
    lower = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.where(lower, torch.exp(diff), 0.0)
    scores = torch.einsum("bkin,bkjn->bkij", cc, bc)     # (B,nc,Li,Lj)
    y_intra = torch.einsum("bkijh,bkjhp->bkihp",
                           scores[..., None] * decay.to(scores.dtype), xc)

    # the chunks' summary states
    tail = torch.exp(cum[:, :, -1:, :] - cum)            # decay to chunk end
    state_k = torch.einsum("bkjh,bkjhp,bkjn->bkhpn", tail.to(bc.dtype), xc,
                           bc)                           # (B,nc,H,P,N)
    total = torch.exp(cum[:, :, -1, :]).to(x.dtype)      # (B,nc,H)

    # across chunks: the state before each chunk
    s_prev = x.new_zeros((bt, h, p, n))
    before = []
    for i in range(nc):
        before.append(s_prev)
        s_prev = s_prev * total[:, i, :, None, None] + state_k[:, i]
    s_before = torch.stack(before, dim=1)                # (B,nc,H,P,N)

    pre = torch.exp(cum)                                 # decay from start
    y_inter = torch.einsum("bkin,bkih,bkhpn->bkihp", cc, pre.to(cc.dtype),
                           s_before)
    y = (y_intra + y_inter).reshape(bt, s, h, p)
    return y[:, :s_orig], s_prev


def _dt_a(dt, p, dtype):
    """softplus(dt + dt_bias) in f32, cast; A = -exp(a_log) in f32, cast."""
    dt = F.softplus(dt.float() + p["dt_bias"]).to(dtype)
    return dt, (-torch.exp(p["a_log"])).to(dtype)


def ssd_block(x, p, cfg, return_state: bool = False):
    """Full Mamba2 block (prefill).  x (B,S,D) -> (B,S,D); with
    return_state also the decode state after the sequence."""
    dtype = x.dtype
    d_in, h, n, hd = _dims(cfg)
    proj = x @ p["in_proj"].to(dtype)
    z, xbc_raw, dt = _split_proj(proj, cfg)
    xbc, _ = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    conv_tail = xbc_raw[:, -(cfg.ssm_conv - 1):, :]  # pre-activation stream
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(*x.shape[:2], h, hd)
    b = xbc[..., d_in:d_in + n]
    c = xbc[..., d_in + n:]
    dt, a = _dt_a(dt, p, dtype)
    y, s_last = ssd_chunked(xs, dt, a, b, c, cfg.ssm_chunk)
    y = y + xs * p["d_skip"].to(dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:2], d_in)
    y = rms_norm(y, p["norm"]) * F.silu(z)
    out = y @ p["out_proj"].to(dtype)
    if return_state:
        return out, {"conv": conv_tail, "ssm": s_last}
    return out


def ssd_decode_init(cfg, batch: int, dtype, device) -> dict:
    d_in, h, n, hd = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, hd, n), dtype=dtype, device=device),
    }


def ssd_decode_step(x, p, cfg, state):
    """x (B,1,D) -> (B,1,D) and the new state: the O(1) update."""
    dtype = x.dtype
    d_in, h, n, hd = _dims(cfg)
    proj = x @ p["in_proj"].to(dtype)
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state=state["conv"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(x.shape[0], h, hd)      # (B,H,P)
    b = xbc[:, 0, d_in:d_in + n]                         # (B,N)
    c = xbc[:, 0, d_in + n:]
    dt, a = _dt_a(dt[:, 0], p, dtype)                    # (B,H)
    decay = torch.exp(a[None] * dt)                      # (B,H)
    s_new = (state["ssm"] * decay[:, :, None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xs, b, dt))
    y = torch.einsum("bhpn,bn->bhp", s_new, c)
    y = y + xs * p["d_skip"].to(dtype)[None, :, None]
    y = y.reshape(x.shape[0], 1, d_in)
    y = rms_norm(y, p["norm"]) * F.silu(z)
    out = y @ p["out_proj"].to(dtype)
    return out, {"conv": conv_state, "ssm": s_new}
