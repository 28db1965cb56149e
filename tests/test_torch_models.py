"""The dense LM zoo (``repro_torch.models``) against the JAX package's, on
the four dense smoke configs: qwen2-7b (GQA, QKV bias), stablelm-1.6b
(LayerNorm, rotary on 25% of the head dims), qwen2.5-14b (d_model 80) and
deepseek-67b (3 layers, no bias).

The JAX package's ``Model.init`` params, with their zero biases and norm
offsets replaced by seeded noise so that every leaf matters, cross as numpy
through ``interchange.model_params_from_numpy``; both packages then run the
same params on the same tokens.  At ``dtype="float32"`` the port's forward,
prefill (logits and K/V caches) and decode logits agree with the reference
within rtol 1e-4 / atol 1e-4 (f32 sums in another order over <= 3 layers).
At the configs' own bf16 the products round differently in torch and XLA,
so there the port is held to itself by the reference's own criterion:
prefill(S - 1) + decode(1) against the forward's last position within
max-relative 3e-2 (tests/test_models.py:50-73)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro_torch.configs import get_config
from repro_torch.interchange import model_params_from_numpy
from repro_torch.models import Model
from repro_torch.models import attention, common, mlp

ARCHS = ["qwen2-7b-smoke", "stablelm-1.6b-smoke", "qwen2.5-14b-smoke",
         "deepseek-67b-smoke"]
B, S, MAX_LEN = 2, 32, 64
RTOL = ATOL = 1e-4          # f32 against f32 in another summation order
BF16_REL = 3e-2             # the reference's decode-vs-forward bound


def _perturbed(params, seed):
    """The reference's init tree as numpy, with noise on the leaves that
    init leaves constant (biases, norm scales and offsets)."""
    rng = np.random.default_rng(seed)

    def walk(x, name=""):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, name) for v in x]
        a = np.asarray(x)
        if name in ("bq", "bk", "bv", "scale", "bias"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return walk(params)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The JAX package's f32 forward, prefill and decode on its own params,
    once per arch: (arch, numpy params, tokens, reference outputs)."""
    arch = request.param
    cfg = dataclasses.replace(ref_config(arch), dtype="float32")
    m = RefModel(cfg)
    params = _perturbed(m.init(jax.random.PRNGKey(0)), len(arch))
    jp = jax.tree.map(jnp.asarray, params)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, _ = jax.jit(m.forward)(jp, {"tokens": jnp.asarray(tokens)})
    pre_logits, state = jax.jit(m.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens[:, :S - 1])}, MAX_LEN)
    dec_logits, _ = jax.jit(m.decode_step)(jp, state,
                                           jnp.asarray(tokens[:, S - 1]))
    want = {"logits": np.asarray(logits), "prefill": np.asarray(pre_logits),
            "decode": np.asarray(dec_logits),
            "state": jax.tree.map(np.asarray, state)}
    return arch, params, tokens, want


def _port(arch, params, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    return Model(cfg), model_params_from_numpy(params, cfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_init_tree_matches_reference(case):
    """The port's own init: the reference's keys, its shapes per layer, f32
    leaves; and the carried tree has the same layout."""
    arch, params, _, _ = case
    cfg = get_config(arch)
    m = Model(cfg)
    own = m.init(0, device="cpu")
    carried = model_params_from_numpy(params, cfg, device="cpu")

    def layout(tree, unstack=False):
        if isinstance(tree, dict):
            return {k: layout(v, unstack) for k, v in tree.items()}
        return (tuple(tree.shape[1:] if unstack else tree.shape),
                str(tree.dtype).split(".")[-1])

    for got in (own, carried):
        assert set(got) == set(params) == {"final_norm", "embed", "lm_head",
                                           "blocks", "tail"}
        assert got["tail"] == [] == params["tail"]
        for k in ("final_norm", "embed", "lm_head"):
            assert layout(got[k]) == layout(params[k])
        assert len(got["blocks"]) == len(params["blocks"]) == 1
        assert len(got["blocks"][0]) == cfg.num_layers == m.repeats
        for layer in got["blocks"][0]:
            assert layout(layer) == layout(params["blocks"][0], unstack=True)
    # the fan-in scales of the reference's init (wo: fan-in hd, / sqrt(2L))
    layer = own["blocks"][0][0]
    assert float(layer["attn"]["wq"].abs().max()) <= 2 * cfg.d_model ** -0.5
    assert float(layer["attn"]["wo"].abs().max()) <= (
        2 * cfg.resolved_head_dim ** -0.5 / (2 * cfg.num_layers) ** 0.5)


def test_forward_matches_reference(case):
    arch, params, tokens, want = case
    m, p = _port(arch, params)
    logits, aux = m.forward(p, {"tokens": torch.from_numpy(tokens)})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, want["logits"])


def test_prefill_matches_reference(case):
    """Last-position logits and every layer's K/V cache (RoPE'd keys,
    zero past the prompt), index = S - 1."""
    arch, params, tokens, want = case
    m, p = _port(arch, params)
    logits, state = m.prefill(p, {"tokens": torch.from_numpy(
        tokens[:, :S - 1])}, MAX_LEN)
    _close(logits, want["prefill"])
    ref_state = want["state"]
    assert state["index"] == int(ref_state["index"]) == S - 1
    assert state["tail"] == [] and len(state["blocks"][0]) == m.repeats
    for r, st in enumerate(state["blocks"][0]):
        for name in ("k", "v"):
            assert st[name].shape == ref_state["blocks"][0][name][r].shape
            _close(st[name], ref_state["blocks"][0][name][r])


def test_decode_matches_reference(case):
    arch, params, tokens, want = case
    m, p = _port(arch, params)
    _, state = m.prefill(p, {"tokens": torch.from_numpy(tokens[:, :S - 1])},
                         MAX_LEN)
    logits, new_state = m.decode_step(p, state,
                                      torch.from_numpy(tokens[:, S - 1]))
    _close(logits, want["decode"])
    assert new_state["index"] == S
    hidden, _ = m.decode_step(p, m.prefill(p, {"tokens": torch.from_numpy(
        tokens[:, :S - 1])}, MAX_LEN)[1], torch.from_numpy(tokens[:, S - 1]),
        return_hidden=True)
    assert hidden.shape == (B, m.cfg.d_model) and hidden.dtype == torch.float32
    _close(m._head(p, hidden[:, None])[:, 0], want["decode"])


def test_decode_matches_own_forward_bf16(case):
    """The reference's test_decode_matches_forward on the port at the
    config's own bf16: logits stay bf16, max-relative error < 3e-2."""
    arch, params, tokens, _ = case
    m, p = _port(arch, params, dtype="bfloat16")
    full, _ = m.forward(p, {"tokens": torch.from_numpy(tokens)})
    _, state = m.prefill(p, {"tokens": torch.from_numpy(tokens[:, :S - 1])},
                         MAX_LEN)
    got, _ = m.decode_step(p, state, torch.from_numpy(tokens[:, S - 1]))
    assert full.dtype == got.dtype == torch.bfloat16
    want = full[:, -1].float()
    rel = float((got.float() - want).abs().max() / want.abs().max())
    assert rel < BF16_REL, (arch, rel)


# ---------------------------------------------------------------------------
# layers, against the reference's on the same numpy inputs
# ---------------------------------------------------------------------------

def _qkv(seed, b=2, s=64, hkv=2, g=2, hd=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hkv, g, hd)).astype(np.float32),
            rng.standard_normal((b, s, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, s, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 24])
def test_banded_attention_matches_reference(window):
    """At chunk 16 over 64 positions: against the reference's banded
    attention within rtol / atol 1e-4 (the same online softmax), and against
    the port's own masked full attention within the reference's 2e-3
    (tests/test_models.py:86-87)."""
    q, k, v = _qkv(window)
    want = ref_attn.banded_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16,
        window=window, dtype=jnp.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention.banded_causal_attention(tq, tk, tv, chunk=16,
                                            window=window,
                                            dtype=torch.float32)
    _close(got, np.asarray(want))
    if window == 0:
        full = attention.full_attention(tq, tk, tv, causal=True,
                                        dtype=torch.float32)
    else:
        # the window mask on dense scores, as the reference's test builds it
        s = q.shape[1]
        sc = torch.einsum("bshgk,bmhk->bshgm", tq, tk) * 16 ** -0.5
        iq, ik = torch.arange(s)[:, None], torch.arange(s)[None, :]
        mask = ((iq >= ik) & (iq - ik < window))[None, :, None, None, :]
        pr = torch.softmax(torch.where(mask, sc, attention.NEG_INF), dim=-1)
        full = torch.einsum("bshgm,bmhk->bshgk", pr, tv)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    full_ref = ref_attn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       dtype=jnp.float32)
    _close(attention.full_attention(tq, tk, tv, causal=True,
                                    dtype=torch.float32),
           np.asarray(full_ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_mlp_match_reference(dtype):
    """rms_norm, layer_norm (f32 inside, cast back), rope at fractions 1 and
    0.25 and the gated MLP: within rtol / atol 1e-4 in f32; in bf16 within
    one bf16 step of the output (2^-7 relative, 2e-2 absolute), as the two
    libraries round their bf16 products independently."""
    rng = np.random.default_rng(5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = (dict(rtol=RTOL, atol=ATOL) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=2e-2))

    def check(got, want):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)

    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    check(common.rms_norm(tx, torch.from_numpy(scale)),
          ref_common.rms_norm(jx, jnp.asarray(scale)))
    check(common.layer_norm(tx, torch.from_numpy(scale),
                            torch.from_numpy(bias)),
          ref_common.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias)))
    h = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = np.arange(3, 11)[None, :]
    for fraction in (1.0, 0.25):
        check(common.rope(torch.from_numpy(h).to(tdt), torch.from_numpy(pos),
                          1e6, fraction),
              ref_common.rope(jnp.asarray(h, jdt), jnp.asarray(pos), 1e6,
                              fraction))
    cfg = dataclasses.replace(get_config("qwen2-7b-smoke"), dtype=dtype)
    p = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                      ("w_down", (128, 64)))}
    check(mlp.mlp(tx, {k: torch.from_numpy(v) for k, v in p.items()}, cfg),
          ref_mlp.mlp(jx, {k: jnp.asarray(v) for k, v in p.items()},
                      ref_config("qwen2-7b-smoke")))
    for kind in ("silu", "gelu"):
        check(common.activation(tx, kind), ref_common.activation(jx, kind))
