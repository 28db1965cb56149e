"""The layers of the LM zoo's other families against the JAX package's,
on the same seeded numpy inputs: the port's counterparts of
tests/test_models.py:110-197 (SSD against its recurrence, the RG-LRU scan
against its steps, MoE drops, ``kv_repeat``, ``unroll``), the local ring
across its wrap, windowed self-attention and cross-attention.  Params come
from the port's own init on a seeded CPU generator (a layer's, or a
model's stacked into the reference's tree); f32 results agree within rtol /
atol 1e-4 unless a test states another bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_helpers import (ATOL, RTOL, batch, close, inputs, perturbed,
                               port, ref_layers, reference_tree, seeded,
                               states_close)
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import mlp as ref_mlp
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch.models import Model
from repro_torch.models import attention, mlp, rglru, ssm
from repro_torch.models.common import rope_angles

S, MAX_LEN = 32, 64


def _model_params(arch, seed, **changes):
    """A whole model's params from the port's seeded init at f32, in the
    reference's numpy tree (perturbed), and the reference's Model."""
    cfg = dataclasses.replace(ref_config(arch), dtype="float32", **changes)
    own = Model(cfg).init(seed, device="cpu")
    return RefModel(cfg), perturbed(reference_tree(own), seed)

def _ssd_problem(s, seed=0, b=2, h=2, p=4, n=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s", [24, 21])
def test_ssd_chunked_matches_recurrence(s):
    """Chunked SSD at chunk 8, S on and off the chunk (padded with dt = 0):
    within rtol / atol 1e-4 of the reference's ``ssd_chunked``, and within
    the reference's 2e-3 of the step-by-step recurrence
    S_t = exp(a dt_t) S_{t-1} + dt_t B_t x_t, y_t = C_t . S_t."""
    x, dt, a, bb, cc = _ssd_problem(s)
    y, s_last = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                                chunk=8)
    ry, rs = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                 chunk=8)
    close(y, np.asarray(ry))
    close(s_last, np.asarray(rs))
    st = np.zeros((x.shape[0], x.shape[2], x.shape[3], bb.shape[2]),
                  np.float32)
    ys = np.zeros_like(x)
    for t in range(s):
        decay = np.exp(a[None, :] * dt[:, t])
        st = st * decay[:, :, None, None] + np.einsum(
            "bhp,bn,bh->bhpn", x[:, t], bb[:, t], dt[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", st, cc[:, t])
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(s_last.numpy(), st, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s", [1, 12, 19])
def test_linear_scan_matches_loop(s):
    """The doubling scan against h_t = a_t h_{t-1} + v_t step by step."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    v = rng.standard_normal((2, s, 8)).astype(np.float32)
    h, want = np.zeros((2, 8), np.float32), []
    for t in range(s):
        h = a[:, t] * h + v[:, t]
        want.append(h)
    np.testing.assert_allclose(
        rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(v)).numpy(),
        np.stack(want, 1), rtol=1e-6, atol=1e-6)


def test_rglru_scan_matches_steps_and_reference():
    """The RG-LRU block over 12 positions: within rtol / atol 1e-4 of the
    reference's block (its associative_scan pairs terms in another order),
    with its decode state; and the port's 12 decode steps within 1e-4 of
    its own block (the reference's test holds its steps to 3e-2)."""
    cfg = ref_config("recurrentgemma-9b-smoke")
    p = perturbed(seeded(rglru.init_rglru, cfg, 3), 3)
    x = np.random.default_rng(4).standard_normal((2, 12, cfg.d_model)).astype(
        np.float32)
    want, want_st = jax.jit(lambda x, p: ref_rglru.rglru_block(
        x, p, cfg, return_state=True))(jnp.asarray(x),
                                       jax.tree.map(jnp.asarray, p))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    full, st = rglru.rglru_block(torch.from_numpy(x), tp, cfg,
                                 return_state=True)
    close(full, np.asarray(want))
    close(st["h"], np.asarray(want_st["h"]))
    close(st["conv"], np.asarray(want_st["conv"]))
    state = rglru.rglru_decode_init(cfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(12):
        o, state = rglru.rglru_decode_step(torch.from_numpy(x[:, t:t + 1]),
                                           tp, cfg, state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=RTOL, atol=ATOL)


def _ref_in_cap(x, p, cfg):
    """The reference's routing steps (mlp.py:133-160) in jnp: which
    (token, choice) assignments keep a slot."""
    b, s, _ = x.shape
    k = cfg.num_experts_per_tok
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    _, ids = jax.lax.top_k(probs, k)
    flat = ids.reshape(b, s * k)
    order = jnp.argsort(flat, axis=1)
    sorted_e = jnp.take_along_axis(flat, order, axis=1)
    idx = jnp.broadcast_to(jnp.arange(s * k)[None], (b, s * k))
    start = jnp.concatenate([jnp.ones((b, 1), bool),
                             sorted_e[:, 1:] != sorted_e[:, :-1]], axis=1)
    run = jax.lax.cummax(jnp.where(start, idx, 0), axis=1)
    pos = jnp.take_along_axis(idx - run, jnp.argsort(order, axis=1), axis=1)
    return pos < ref_mlp._capacity(cfg, s), flat


@pytest.mark.parametrize("tied", [False, True])
def test_moe_drops_match_reference(tied):
    """qwen3-moe-smoke's MoE at capacity_factor 1.0 over 16 tokens (C = 4
    of 8 experts, top-2): assignments drop, and the port keeps exactly the
    reference's (expert ids and in_cap equal); output within rtol / atol
    1e-4 and the aux loss too.  ``tied``: two router columns equal, so
    every token's probabilities tie and ``lax.top_k``'s lowest-expert rule
    decides."""
    cfg = dataclasses.replace(ref_config("qwen3-moe-235b-a22b-smoke"),
                              capacity_factor=1.0)
    p = seeded(mlp.init_moe, cfg, 5)
    if tied:
        p["router"][:, 5] = p["router"][:, 2]
    x = np.random.default_rng(6).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda x, p: ref_mlp.moe(x, p, cfg))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    in_cap, experts = jax.jit(lambda x, p: _ref_in_cap(x, p, cfg))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    in_cap, experts = np.asarray(in_cap), np.asarray(experts)
    tp = jax.tree.map(torch.from_numpy, p)
    got, aux = mlp.moe(torch.from_numpy(x), tp, cfg)
    close(got, np.asarray(want))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL)
    _, _, t_exp, _, t_in_cap, c = mlp.moe_route(torch.from_numpy(x), tp, cfg)
    assert c == 4
    np.testing.assert_array_equal(t_exp.numpy(), experts)
    np.testing.assert_array_equal(t_in_cap.numpy(), in_cap)
    assert 0 < (~in_cap).sum() < in_cap.size
    if tied:                 # expert 5 only ever comes after expert 2
        for row in experts.reshape(-1, cfg.num_experts_per_tok).tolist():
            assert 5 not in row or row.index(2) < row.index(5)


def test_kv_repeat_matches_reference():
    """kv_repeat=2 on deepseek-67b-smoke (the KV heads replicated): the
    forward within rtol / atol 1e-4 of the reference's, and prefill + decode
    against the forward's last position within 1e-4."""
    m, params = _model_params("deepseek-67b-smoke", 7, kv_repeat=2)
    cfg = m.cfg
    inp = inputs(cfg, S)
    want, _ = jax.jit(m.forward)(jax.tree.map(jnp.asarray, params),
                                 batch(cfg, inp, S, jnp.asarray))
    tm, tp = port("deepseek-67b-smoke", params, kv_repeat=2)
    assert tp["blocks"][0][0]["attn"]["wk"].shape[1] == 2 * cfg.num_kv_heads
    full, _ = tm.forward(tp, batch(cfg, inp, S, torch.from_numpy))
    close(full, np.asarray(want))
    _, state = tm.prefill(tp, batch(cfg, inp, S - 1, torch.from_numpy),
                          MAX_LEN)
    got, _ = tm.decode_step(tp, state, torch.from_numpy(inp["seq"][:, -1]))
    close(got, full[:, -1].numpy())


def test_unroll_matches_reference():
    """``unroll`` changes no number: the port's forward is the same with it
    on and off, and within rtol / atol 1e-4 of the reference's unrolled
    forward (qwen2-7b-smoke, f32)."""
    m, params = _model_params("qwen2-7b-smoke", 9, unroll=True)
    cfg = m.cfg
    inp = inputs(cfg, S)
    want, _ = jax.jit(m.forward)(jax.tree.map(jnp.asarray, params),
                                 batch(cfg, inp, S, jnp.asarray))
    tb = batch(cfg, inp, S, torch.from_numpy)
    m_on, p = port("qwen2-7b-smoke", params, unroll=True)
    m_off, _ = port("qwen2-7b-smoke", params, unroll=False)
    on, _ = m_on.forward(p, tb)
    assert torch.equal(on, m_off.forward(p, tb)[0])
    close(on, np.asarray(want))


@pytest.mark.parametrize("prompt,max_len", [(40, 64), (10, 16)])
def test_local_ring_across_its_wrap(prompt, max_len):
    """recurrentgemma-smoke (local window 32) decoding past the ring's
    wrap: a prompt of 40 >= the window fills the ring through the prefill's
    roll (W = 32), a prompt of 10 at max_len 16 (W = 16) through its other
    branch; 26 decode steps then cross slot W - 1 -> 0.  Each step's logits
    and the final ring (K, V, positions) within rtol / atol 1e-4 of the
    reference's; with W = the window, the last step also within 1e-4 of
    the port's own windowed forward over the whole sequence."""
    arch = "recurrentgemma-9b-smoke"
    m, params = _model_params(arch, 11)
    cfg = m.cfg
    jp = jax.tree.map(jnp.asarray, params)
    steps = 26
    inp = inputs(cfg, prompt + steps, seed=12)
    _, state = jax.jit(m.prefill, static_argnums=2)(
        jp, batch(cfg, inp, prompt, jnp.asarray), max_len)
    tm, tp = port(arch, params)
    _, tstate = tm.prefill(tp, batch(cfg, inp, prompt, torch.from_numpy),
                           max_len)
    decode = jax.jit(m.decode_step)
    for t in range(prompt, prompt + steps):
        want, state = decode(jp, state, jnp.asarray(inp["seq"][:, t]))
        got, tstate = tm.decode_step(tp, tstate,
                                     torch.from_numpy(inp["seq"][:, t]))
        close(got, np.asarray(want))
    states_close(tm, tstate, ref_layers(m, state))
    ring = tstate["blocks"][2][0]["pos"]
    w = min(cfg.local_window, max_len)
    assert sorted(ring.tolist()) == list(range(prompt + steps - w,
                                               prompt + steps))
    if w == cfg.local_window:
        full, _ = tm.forward(tp, batch(cfg, inp, prompt + steps,
                                        torch.from_numpy))
        close(got, full[:, -1].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """``cond_kv`` + ``cross_attention`` (no mask, no RoPE) on
    llama-3.2-vision-smoke's cross layer params: within rtol / atol 1e-4 in
    f32, within one bf16 step (2^-7 relative, 2e-2 absolute) in bf16."""
    cfg = dataclasses.replace(ref_config("llama-3.2-vision-90b-smoke"),
                              dtype=dtype)
    p = seeded(attention.init_attention, cfg, 7, cross=True)
    assert set(p) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    cond = rng.standard_normal((2, cfg.num_cond_tokens,
                                cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(jnp.asarray, p)
    want = jax.jit(lambda x, cond, p: ref_attn.cross_attention(
        x, ref_attn.cond_kv(cond, p, cfg), p, cfg))(
        jnp.asarray(x, jdt), jnp.asarray(cond), jp)
    tp = jax.tree.map(torch.from_numpy, p)
    ckv = attention.cond_kv(torch.from_numpy(cond), tp, cfg)
    assert ckv[0].dtype == tdt and ckv[0].shape == (
        2, cfg.num_cond_tokens, cfg.num_kv_heads, cfg.resolved_head_dim)
    got = attention.cross_attention(torch.from_numpy(x).to(tdt), ckv, tp,
                                    cfg)
    tol = (dict(rtol=RTOL, atol=ATOL) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=2e-2))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_windowed_self_attention_matches_reference():
    """``self_attention`` with a window of 16 over 40 positions (the banded
    windowed path at chunk 40) against the reference's, K/V included."""
    cfg = dataclasses.replace(ref_config("recurrentgemma-9b-smoke"),
                              dtype="float32")
    p = seeded(attention.init_attention, cfg, 9)
    x = np.random.default_rng(10).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = jax.jit(lambda x, p: ref_attn.self_attention(
        x, p, cfg, window=16, chunk=512))(jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, p))
    angles = rope_angles(torch.arange(40)[None, :], cfg.resolved_head_dim,
                         cfg.rope_theta, cfg.rope_fraction)
    got, (k, v) = attention.self_attention(
        torch.from_numpy(x), jax.tree.map(torch.from_numpy, p), cfg, angles,
        window=16, chunk=512)
    close(got, np.asarray(want))
    close(k, np.asarray(wk))
    close(v, np.asarray(wv))
