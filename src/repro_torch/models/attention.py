"""Attention layers of the dense family (counterpart of
``repro.models.attention``): GQA self-attention over the full sequence
(masked, or banded for long sequences) and one-token decode against a KV
cache.

Projections keep the reference's *grouped* layout ``wq: (D, Hkv, G, hd)``,
``wk``/``wv: (D, Hkv, hd)``, ``wo: (Hkv, G, hd, D)`` with ``G = Hq / Hkv``, so
params cross between the packages leaf for leaf.  Each product is one matmul
over the flattened head dims.  Attention is the reference's plain masked
softmax with its ``-1e30`` fill (not ``scaled_dot_product_attention``, whose
masking and summation order differ).  Cross-attention, windowed
self-attention and the local-window ring-buffer decode wait for the other
families (ROADMAP A9b).
"""

from __future__ import annotations

import torch

from .common import apply_rope, dense_init

__all__ = ["NEG_INF", "init_attention", "banded_causal_attention",
           "full_attention", "self_attention", "decode_self_attention"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, cross: bool = False) -> dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.effective_kv_heads
    if hq % hkv:
        raise ValueError(f"kv_repeat={cfg.kv_repeat} must keep kv heads "
                         f"dividing {cfg.num_heads} query heads")
    g = hq // hkv
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, (d, hkv, g, hd)),
        "wk": dense_init(generator, (d, hkv, hd)),
        "wv": dense_init(generator, (d, hkv, hd)),
        "wo": dense_init(generator, (hkv, g, hd, d), in_axis=2).div_(
            (2.0 * cfg.num_layers) ** 0.5),
    }
    if cfg.qkv_bias and not cross:
        device = generator.device
        p["bq"] = torch.zeros((hkv, g, hd), device=device)
        p["bk"] = torch.zeros((hkv, hd), device=device)
        p["bv"] = torch.zeros((hkv, hd), device=device)
    return p


def _project_q(x, p, dtype):
    """(B, S, D) -> (B, S, Hkv, G, hd)."""
    wq = p["wq"]
    q = (x @ wq.reshape(wq.shape[0], -1).to(dtype)).unflatten(-1,
                                                             wq.shape[1:])
    if "bq" in p:
        q = q + p["bq"].to(dtype)
    return q


def _project_kv(x, p, dtype):
    wk, wv = p["wk"], p["wv"]
    k = (x @ wk.reshape(wk.shape[0], -1).to(dtype)).unflatten(-1,
                                                             wk.shape[1:])
    v = (x @ wv.reshape(wv.shape[0], -1).to(dtype)).unflatten(-1,
                                                             wv.shape[1:])
    if "bk" in p:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return k, v


def _out_proj(attn, p, dtype):
    """attn: (B, S, Hkv, G, hd) -> (B, S, D)."""
    wo = p["wo"]
    return attn.flatten(-3) @ wo.reshape(-1, wo.shape[-1]).to(dtype)


def _rope_grouped(q, angles):
    """rope over (B, S, Hkv, G, hd): flatten the head dims for the helper."""
    b, s, hkv, g, hd = q.shape
    return apply_rope(q.reshape(b, s, hkv * g, hd), angles).reshape(
        b, s, hkv, g, hd)


# ---------------------------------------------------------------------------
# core softmax-attention
# ---------------------------------------------------------------------------

def banded_causal_attention(q, k, v, *, chunk: int, window: int = 0,
                            dtype=torch.bfloat16):
    """Exact-work causal (optionally windowed) attention, one chunk-diagonal
    band at a time with an online softmax.

    q: (B,S,Hkv,G,hd); k,v: (B,S,Hkv,hd).  Returns (B,S,Hkv,G,hd)."""
    b, s, hkv, g, hd = q.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
    nc = s // c
    scale = hd ** -0.5
    dev = q.device

    qc = q.reshape(b, nc, c, hkv, g, hd)
    kc = k.reshape(b, nc, c, hkv, hd)
    vc = v.reshape(b, nc, c, hkv, hd)

    acc = torch.zeros((b, nc, c, hkv, g, hd), device=dev)
    m = torch.full((b, nc, c, hkv, g), NEG_INF, device=dev)
    l = torch.zeros((b, nc, c, hkv, g), device=dev)

    max_band = nc if window <= 0 else min(nc, -(-window // c) + 1)
    iq = torch.arange(c, device=dev).reshape(1, 1, c, 1, 1, 1)
    ik = torch.arange(c, device=dev).reshape(1, 1, 1, 1, 1, c)

    for band in range(max_band):
        nq = nc - band
        qs = qc[:, band:]                        # (B,nq,C,Hkv,G,hd)
        ks = kc[:, :nq]
        vs = vc[:, :nq]
        sc = torch.einsum("bnchgk,bnmhk->bnchgm", qs, ks).float()
        sc = sc * scale                          # (B,nq,Cq,Hkv,G,Ck)
        dist = iq + band * c - ik                # query_pos - key_pos >= 0
        mask = dist >= 0
        if window > 0:
            mask &= dist < window
        sc = torch.where(mask, sc, NEG_INF)

        m_prev = m[:, band:]
        m_band = torch.maximum(m_prev, sc.amax(dim=-1))
        alpha = torch.exp(m_prev - m_band)
        pr = torch.exp(sc - m_band[..., None])
        l_band = l[:, band:] * alpha + pr.sum(dim=-1)
        acc_band = (acc[:, band:] * alpha[..., None]
                    + torch.einsum("bnchgm,bnmhk->bnchgk", pr.to(dtype),
                                   vs).float())
        m = torch.cat([m[:, :band], m_band], dim=1)
        l = torch.cat([l[:, :band], l_band], dim=1)
        acc = torch.cat([acc[:, :band], acc_band], dim=1)

    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, hkv, g, hd).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, dtype=torch.bfloat16):
    """Plain masked attention.

    q: (B,S,Hkv,G,hd); k,v: (B,M,Hkv,hd) -> (B,S,Hkv,G,hd)."""
    s, hd = q.shape[1], q.shape[-1]
    m = k.shape[1]
    sc = torch.einsum("bshgk,bmhk->bshgm", q, k).float() * hd ** -0.5
    if causal:
        iq = torch.arange(s, device=q.device).reshape(1, s, 1, 1, 1)
        ik = torch.arange(m, device=q.device).reshape(1, 1, 1, 1, m)
        sc = torch.where(iq >= ik, sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bshgm,bmhk->bshgk", pr.to(dtype), v)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# layer-level entry points
# ---------------------------------------------------------------------------

def self_attention(x, p, cfg, angles, *, chunk: int = 1024):
    """Causal self-attention over the full sequence (prefill): banded when
    S > chunk and chunk divides S, else masked full attention.  ``angles``:
    ``rope_angles`` at the sequence's positions, shared across layers.
    Returns (out (B, S, D), (k, v)) with k, v (B, S, Hkv, hd) after RoPE."""
    dtype = x.dtype
    s = x.shape[1]
    q = _project_q(x, p, dtype)
    k, v = _project_kv(x, p, dtype)
    q = _rope_grouped(q, angles)
    k = apply_rope(k, angles)
    if s > chunk and s % chunk == 0:
        attn = banded_causal_attention(q, k, v, chunk=chunk, dtype=dtype)
    else:
        attn = full_attention(q, k, v, causal=True, dtype=dtype)
    return _out_proj(attn, p, dtype), (k, v)


def decode_self_attention(x, p, cfg, cache_k, cache_v, cur_index: int,
                          angles):
    """One-token decode: x (B,1,D); caches (B,S_max,Hkv,hd); ``cur_index``
    (a host int) is the position being written, ``angles`` RoPE's there.
    The new K/V are written into the caches in place at ``cur_index``; the
    query then attends over all S_max slots under the mask
    ``slot <= cur_index`` (-1e30 elsewhere).  Returns (out, cache_k,
    cache_v)."""
    dtype = x.dtype
    s_max = cache_k.shape[1]
    if not 0 <= cur_index < s_max:
        raise IndexError(f"decode position {cur_index} is outside the "
                         f"{s_max}-slot cache")
    q = _project_q(x, p, dtype)
    k_new, v_new = _project_kv(x, p, dtype)
    q = _rope_grouped(q, angles)
    k_new = apply_rope(k_new, angles)
    cache_k[:, cur_index] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, cur_index] = v_new[:, 0].to(cache_v.dtype)
    hd = q.shape[4]
    qg = q[:, 0]                                              # (B,Hkv,G,hd)
    sc = torch.einsum("bhgk,bmhk->bhgm", qg,
                      cache_k.to(dtype)).float() * hd ** -0.5
    valid = torch.arange(s_max, device=x.device) <= cur_index
    sc = torch.where(valid, sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgm,bmhk->bhgk", pr.to(dtype),
                       cache_v.to(dtype))[:, None]            # (B,1,Hkv,G,hd)
    return _out_proj(out, p, dtype), cache_k, cache_v
