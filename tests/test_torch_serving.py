"""The decode loop (``repro_torch.serve.serving``) against the JAX
package's, on qwen2-7b-smoke.

At ``dtype="float32"``, on the JAX package's own init params carried across
(``interchange.model_params_from_numpy``): ``greedy_generate`` with the
exact head returns the reference's tokens, and a decode loop through
``ServeSession.next_token`` with the reference's PQ head carried across
(``interchange.hybrid_head_from_numpy``, ``ref`` backend) returns the tokens
of the reference's ``greedy_generate(use_pq_head=True)``, which builds that
same head.  At the config's own bf16 the port is held by the reference's
criteria (tests/test_serving.py:95-113): the PQ route agrees with the exact
route on >= 80% of tokens, and a repetition penalty does not raise
repetition.  Bucketed head calls give the unbucketed tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serve import greedy_generate as ref_generate
from repro.serve import serving as ref_serving
from repro.serve.hybrid_head import HybridLMHead as RefHead
from repro_torch.configs import get_config
from repro_torch.interchange import (hybrid_head_from_numpy,
                                     model_params_from_numpy)
from repro_torch.models import Model
from repro_torch.serve import HybridLMHead, ServeSession, greedy_generate
from repro_torch.serve import serving

ARCH = "qwen2-7b-smoke"
STEPS, MAX_LEN = 6, 48


@pytest.fixture(scope="module")
def ref():
    """The reference's init params (numpy), a prompt, and its greedy tokens
    at f32 with the exact and the PQ head; the PQ head's arrays."""
    cfg = dataclasses.replace(ref_config(ARCH), dtype="float32")
    m = RefModel(cfg)
    jp = m.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    exact = ref_generate(m, jp, jnp.asarray(prompt), STEPS, MAX_LEN)
    pq = ref_generate(m, jp, jnp.asarray(prompt), STEPS, MAX_LEN,
                      use_pq_head=True)
    hp = RefHead(cfg).build(jp["lm_head"])
    head = {"centers": np.asarray(hp.codebooks.centers),
            "codes": np.asarray(hp.codes), "q": np.asarray(hp.residual.q),
            "scale": np.asarray(hp.residual.scale),
            "zero": np.asarray(hp.residual.zero), "head": np.asarray(hp.head)}
    return {"params": jax.tree.map(np.asarray, jp), "prompt": prompt,
            "exact": np.asarray(exact), "pq": np.asarray(pq), "head": head}


def _port(ref, dtype="float32"):
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    return Model(cfg), model_params_from_numpy(ref["params"], cfg,
                                               device="cpu")


def test_greedy_exact_head_equals_reference(ref):
    m, p = _port(ref)
    got = greedy_generate(m, p, ref["prompt"], STEPS, MAX_LEN)
    assert got.dtype == torch.int32 and got.shape == (2, STEPS)
    np.testing.assert_array_equal(got.numpy(), ref["exact"])


def _session_loop(sess, prompt, steps, penalty=0.0):
    """prefill, the prompt's last hidden state, then decode_step +
    next_token through the session's PQ head: the loop a server runs,
    spelled out."""
    m = sess.model
    prompt = torch.as_tensor(prompt).long()
    _, state = sess.prefill({"tokens": prompt})
    counts = torch.zeros((prompt.shape[0], m.cfg.vocab_size))
    serving._bump(counts, prompt)
    hidden, _ = m.forward(sess.params, {"tokens": prompt},
                          return_hidden=True)
    tok = sess.next_token(hidden[:, -1], counts, penalty=penalty)
    out = [tok]
    for _ in range(steps - 1):
        serving._bump(counts, tok[:, None])
        hidden, state = m.decode_step(sess.params, state, tok,
                                      return_hidden=True)
        tok = sess.next_token(hidden, counts, penalty=penalty)
        out.append(tok)
    return torch.stack(out, 1)


def test_session_loop_with_carried_pq_head_equals_reference(ref):
    m, p = _port(ref)
    sess = ServeSession(
        model=m, params=p, max_len=MAX_LEN,
        pq_head=HybridLMHead(m.cfg, backend="ref"),
        pq_params=hybrid_head_from_numpy(ref["head"], codes_packed=False,
                                         device="cpu"))
    got = _session_loop(sess, ref["prompt"], STEPS)
    np.testing.assert_array_equal(got.numpy(), ref["pq"])


def test_pq_route_agrees_with_exact_route_bf16(ref):
    """The reference's test_generate_pq_vs_exact on the port at bf16, with
    the head the port builds itself (backend None: ``cuda``, whose K1 runs
    its plain version on CPU tensors)."""
    m, p = _port(ref, dtype="bfloat16")
    exact = greedy_generate(m, p, ref["prompt"], STEPS, MAX_LEN)
    pq = greedy_generate(m, p, ref["prompt"], STEPS, MAX_LEN,
                         use_pq_head=True)
    assert (exact.numpy() == pq.numpy()).mean() >= 0.8


def test_penalty_does_not_raise_repetition(ref):
    m, p = _port(ref, dtype="bfloat16")
    prompt = ref["prompt"][:, :8]
    plain = greedy_generate(m, p, prompt, 12, MAX_LEN).numpy()
    pen = greedy_generate(m, p, prompt, 12, MAX_LEN, penalty=5.0).numpy()

    def rep(x):
        return np.mean([len(row) - len(set(row.tolist())) for row in x])

    assert rep(pen) <= rep(plain)


def test_head_buckets_give_unbucketed_tokens(ref):
    """Decode batches of 2 and 3 padded to buckets (1, 4) and of 5 chunked
    into 4 + 1: the unbucketed session's tokens, with a penalty on."""
    m, p = _port(ref)
    sess = ServeSession.create(m, p, MAX_LEN, use_pq_head=True,
                               head_backend="ref")
    bucketed = dataclasses.replace(sess, head_buckets=(1, 4))
    prompt = np.random.default_rng(3).integers(0, m.cfg.vocab_size, (5, 10))
    for b in (2, 3, 5):
        want = _session_loop(sess, prompt[:b], 4, penalty=0.5)
        got = _session_loop(bucketed, prompt[:b], 4, penalty=0.5)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_bump_adds_duplicates_as_the_reference():
    tokens = np.array([[3, 3, 5, 3], [0, 7, 7, 1]], np.int32)
    counts = np.random.default_rng(4).integers(0, 3, (2, 9)).astype(
        np.float32)
    want = ref_serving._bump(jnp.asarray(counts), jnp.asarray(tokens))
    got = serving._bump(torch.from_numpy(counts.copy()),
                        torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["mamba2-780m-smoke", "qwen2-moe-a2.7b-smoke",
                                  "musicgen-medium-smoke"])
def test_other_families_raise_not_implemented(arch):
    """Every family builds its own stack, and no part of the model raises
    NotImplementedError any more: the training loss, which did until the
    training stack was ported (ROADMAP A10), runs on each family (it is
    held to the JAX package in tests/test_torch_train.py); an input the
    family does not take still raises rather than running something else
    in its place."""
    m = Model(dataclasses.replace(get_config(arch), dtype="float32"))
    assert m.pattern == {"mamba2-780m-smoke": ("ssd",),
                         "qwen2-moe-a2.7b-smoke": ("moe",),
                         "musicgen-medium-smoke": ("self_cross",)}[arch]
    cfg = m.cfg
    params = m.init(0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend != "tokens":
        with pytest.raises(ValueError, match="embeds"):
            m.loss(params, batch)
        batch = {"embeds": torch.randn((2, 8, cfg.d_model), generator=g),
                 "cond": torch.randn((2, cfg.num_cond_tokens, cfg.d_model),
                                     generator=g),
                 "labels": tokens}
    with torch.no_grad():
        loss, metrics = m.loss(params, batch)
    assert set(metrics) == {"nll", "aux", "zloss"}
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
