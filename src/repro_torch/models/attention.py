"""Attention layers (counterpart of ``repro.models.attention``): GQA
self-attention over the full sequence (masked, or banded for long sequences;
full causal or a local window), cross-attention over precomputed
conditioning K/V, one-token decode against a KV cache, and the local-window
ring-buffer decode of the Griffin attention layers.

Projections keep the reference's *grouped* layout ``wq: (D, Hkv, G, hd)``,
``wk``/``wv: (D, Hkv, hd)``, ``wo: (Hkv, G, hd, D)`` with ``G = Hq / Hkv``, so
params cross between the packages leaf for leaf.  Each product is one matmul
over the flattened head dims.  Attention is the reference's plain masked
softmax with its ``-1e30`` fill (not ``scaled_dot_product_attention``, whose
masking and summation order differ).
"""

from __future__ import annotations

import torch

from .common import apply_rope, compute_dtype, dense_init

__all__ = ["NEG_INF", "init_attention", "banded_causal_attention",
           "full_attention", "self_attention", "cross_attention", "cond_kv",
           "decode_self_attention", "decode_local_attention"]

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

def self_attention(x, p, cfg, angles, *, window: int = 0,
                   chunk: int = 1024):
    """Causal self-attention over the full sequence (prefill), over the last
    ``window`` positions when ``window`` > 0: banded (windowed) when S >
    window > 0, banded when S > chunk and chunk divides S, else masked full
    attention, as the reference picks.  ``angles``: ``rope_angles`` at the
    sequence's positions, shared across layers.  Returns (out (B, S, D),
    (k, v)) with k, v (B, S, Hkv, hd) after RoPE."""
    dtype = x.dtype
    s = x.shape[1]
    q = _project_q(x, p, dtype)
    k, v = _project_kv(x, p, dtype)
    q = _rope_grouped(q, angles)
    k = apply_rope(k, angles)
    if window > 0 and s > window:
        c = chunk if s % chunk == 0 else _largest_divisor_chunk(s, chunk)
        attn = banded_causal_attention(q, k, v, chunk=c, window=window,
                                       dtype=dtype)
    elif s > chunk and s % chunk == 0:
        attn = banded_causal_attention(q, k, v, chunk=chunk, window=window,
                                       dtype=dtype)
    else:
        attn = full_attention(q, k, v, causal=True, dtype=dtype)
    return _out_proj(attn, p, dtype), (k, v)


def _largest_divisor_chunk(s: int, chunk: int) -> int:
    for c in range(min(chunk, s), 0, -1):
        if s % c == 0:
            return c
    return s


def cross_attention(x, ckv, p, cfg):
    """x (B,S,D) attends over precomputed conditioning K/V ``ckv`` (no
    mask, no RoPE)."""
    dtype = x.dtype
    q = _project_q(x, p, dtype)
    k, v = ckv
    attn = full_attention(q, k, v, causal=False, dtype=dtype)
    return _out_proj(attn, p, dtype)


def cond_kv(cond_embed, p, cfg):
    """Cross-attention K/V (B, Tc, Hkv, hd) from conditioning embeddings
    (B, Tc, D), in the compute dtype."""
    dtype = compute_dtype(cfg)
    return _project_kv(cond_embed.to(dtype), p, dtype)


def _decode_qkv(x, p, angles):
    dtype = x.dtype
    q = _rope_grouped(_project_q(x, p, dtype), angles)
    k_new, v_new = _project_kv(x, p, dtype)
    return q, apply_rope(k_new, angles), v_new


def _attend_one(q, cache_k, cache_v, valid, p):
    """The new token's query (B,1,Hkv,G,hd) over the cache's slots where
    ``valid`` (broadcast over (B,Hkv,G,slots)) holds, -1e30 elsewhere."""
    dtype = q.dtype
    hd = q.shape[4]
    sc = torch.einsum("bhgk,bmhk->bhgm", q[:, 0],
                      cache_k.to(dtype)).float() * hd ** -0.5
    pr = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
    out = torch.einsum("bhgm,bmhk->bhgk", pr.to(dtype),
                       cache_v.to(dtype))[:, None]            # (B,1,Hkv,G,hd)
    return _out_proj(out, p, dtype)


def decode_self_attention(x, p, cfg, cache_k, cache_v, cur_index: int,
                          angles):
    """One-token decode: x (B,1,D); caches (B,S_max,Hkv,hd); ``cur_index``
    (a host int) is the position being written, ``angles`` RoPE's there.
    The new K/V are written into the caches in place at ``cur_index``; the
    query then attends over all S_max slots under the mask
    ``slot <= cur_index`` (-1e30 elsewhere).  Returns (out, cache_k,
    cache_v)."""
    s_max = cache_k.shape[1]
    if not 0 <= cur_index < s_max:
        raise IndexError(f"decode position {cur_index} is outside the "
                         f"{s_max}-slot cache")
    q, k_new, v_new = _decode_qkv(x, p, angles)
    cache_k[:, cur_index] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, cur_index] = v_new[:, 0].to(cache_v.dtype)
    valid = torch.arange(s_max, device=x.device) <= cur_index
    return _attend_one(q, cache_k, cache_v, valid, p), cache_k, cache_v


def decode_local_attention(x, p, cfg, cache_k, cache_v, cache_pos,
                           cur_index: int, angles, *, window: int):
    """Ring-buffer local-window decode (Griffin attention layers).

    cache_{k,v}: (B, W, Hkv, hd) with W = min(window, max_len); cache_pos
    (W,) int32 holds the absolute position stored in each slot (-1 =
    empty).  RoPE is applied at the absolute position before caching, so
    slots never need re-rotation.  The new K/V and position are written in
    place at slot ``cur_index % W`` (a host int: no read-back); the query
    attends over the slots whose position lies in (cur_index - window,
    cur_index].  Returns (out, cache_k, cache_v, cache_pos)."""
    slot = cur_index % cache_k.shape[1]
    q, k_new, v_new = _decode_qkv(x, p, angles)
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    cache_pos[slot:slot + 1].fill_(cur_index)    # no host->device copy
    valid = ((cache_pos >= 0) & (cache_pos > cur_index - window)
             & (cache_pos <= cur_index))
    return (_attend_one(q, cache_k, cache_v, valid, p), cache_k, cache_v,
            cache_pos)
