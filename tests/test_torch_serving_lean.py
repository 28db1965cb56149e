"""A session reached without holding two trees (``donate=True``).

``ServeSession.create(..., donate=True)`` and ``greedy_generate(...,
donate=True)`` cast the caller's f32 tree in place, a leaf at a time, so
that the f32 tree and its bf16 copies are never held together (at
qwen2-moe-a2.7b's full depth they are 57.3 GB and 28.7 GB).  Here, at the
smoke widths in the configs' own bf16:

* the donated session's params equal ``_serving_params(model.init(seed))``
  leaf by leaf, in dtype and in bits (recurrentgemma's ``lam`` stays f32),
  and its PQ head equals the one built from an undonated tree;
* every f32 leaf the session casts is released, and the leaves that stay
  f32 are the caller's own tensors;
* the LM launcher's path (``launch.serve.lm_generate``) gives
  ``greedy_generate``'s tokens on an undonated tree, with both heads;
* the donated loop gives the JAX package's bf16 greedy tokens on the MoE
  smoke: the exact head through ``greedy_generate``, and the PQ head
  carried across from the reference (``ref`` backend, as in
  tests/test_torch_serving_families_pq.py) through a donated session."""

import argparse
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_helpers import inputs, reference_tree
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serve import greedy_generate as ref_generate
from repro.serve.hybrid_head import HybridLMHead as RefHead
from repro_torch.configs import get_config
from repro_torch.interchange import (hybrid_head_from_numpy,
                                     model_params_from_numpy)
from repro_torch.launch import serve as serve_launch
from repro_torch.models import Model
from repro_torch.serve import (HybridLMHead, ServeSession, greedy_generate,
                               serving)

MOE = "qwen2-moe-a2.7b-smoke"
STEPS, MAX_LEN, SEED = 6, 48, 3


def leaves(tree, path=()):
    """(path, tensor) of every leaf of a params tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's raw bits (bf16 as int16, f32 as int32)."""
    return t.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}[t.dtype]).numpy()


def assert_same_bits(got, want):
    got, want = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=str(path))


@pytest.mark.parametrize("arch", [MOE, "recurrentgemma-9b-smoke"])
def test_donated_session_equals_serving_params_bit_for_bit(arch):
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16"
    m = Model(cfg)
    want = serving._serving_params(m.init(SEED, device="cpu"), cfg)
    params = m.init(SEED, device="cpu")
    sess = ServeSession.create(m, params, MAX_LEN, use_pq_head=False,
                               donate=True)
    assert sess.params is params
    assert_same_bits(sess.params, want)
    dtypes = {p[-2:]: t.dtype for p, t in leaves(sess.params)}
    assert dtypes[("embed",)] == torch.float32
    assert sess.params["lm_head"].dtype == torch.bfloat16
    if cfg.family == "hybrid":
        assert dtypes[("rec", "lam")] == torch.float32
        assert dtypes[("rec", "wa")] == torch.bfloat16
    else:
        assert dtypes[("moe", "w_gate")] == torch.bfloat16


def test_donated_f32_leaves_are_released_and_pq_head_kept():
    cfg = get_config(MOE)
    m = Model(cfg)
    kept = m.init(SEED, device="cpu")
    undonated = ServeSession.create(m, kept, MAX_LEN, use_pq_head=True,
                                    head_backend="ref")
    params = m.init(SEED, device="cpu")
    refs = {p: weakref.ref(t) for p, t in leaves(params)}
    sess = ServeSession.create(m, params, MAX_LEN, use_pq_head=True,
                               head_backend="ref", donate=True)
    gc.collect()
    released = 0
    for path, t in leaves(sess.params):
        if t.dtype == torch.float32:
            assert refs[path]() is t, path       # the caller's own leaf
        else:
            assert refs[path]() is None, path    # the f32 leaf is gone
            released += 1
    assert released > 0
    # the head was built from the f32 lm_head, before its cast
    assert_same_bits(sess.pq_params, undonated.pq_params)
    assert_same_bits(sess.params, undonated.params)


@pytest.mark.parametrize("pq", [False, True], ids=["exact", "pq"])
def test_launcher_tokens_equal_greedy_generate(pq):
    args = argparse.Namespace(arch=MOE, device="cpu", seed=SEED, batch=2,
                              prompt_len=8, tokens=STEPS, max_len=MAX_LEN,
                              pq_head=pq, penalty=0.0)
    got, _, _ = serve_launch.lm_generate(args)
    m = Model(get_config(MOE))
    g = torch.Generator().manual_seed(SEED)
    params = m.init(g, device="cpu")
    prompt = torch.randint(0, m.cfg.vocab_size, (2, 8), generator=g)
    want = greedy_generate(m, params, prompt, STEPS, MAX_LEN,
                           use_pq_head=pq)
    assert params["lm_head"].dtype == torch.float32   # not donated
    assert got.dtype == torch.int32 and got.shape == (2, STEPS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.fixture(scope="module")
def reference_bf16():
    """The JAX package's bf16 greedy tokens on the port's seeded init of
    the MoE smoke (stacked into its tree), with the exact head and with
    its own PQ head, whose arrays come back too."""
    cfg = ref_config(MOE)
    m = RefModel(cfg)
    tree = reference_tree(Model(get_config(MOE)).init(5, device="cpu"))
    jp = jax.tree.map(jnp.asarray, tree)
    inp = inputs(cfg, 12, seed=2)
    prompt = jnp.asarray(inp["seq"])
    hp = RefHead(cfg).build(jp["lm_head"])
    return {"tree": tree, "prompt": inp["seq"],
            "exact": np.asarray(ref_generate(m, jp, prompt, STEPS,
                                             MAX_LEN)),
            "pq": np.asarray(ref_generate(m, jp, prompt, STEPS, MAX_LEN,
                                          use_pq_head=True)),
            "head": {"centers": np.asarray(hp.codebooks.centers),
                     "codes": np.asarray(hp.codes),
                     "q": np.asarray(hp.residual.q),
                     "scale": np.asarray(hp.residual.scale),
                     "zero": np.asarray(hp.residual.zero),
                     "head": np.asarray(hp.head)}}


def test_donated_greedy_exact_head_equals_reference_bf16(reference_bf16):
    cfg = get_config(MOE)
    params = model_params_from_numpy(reference_bf16["tree"], cfg,
                                     device="cpu")
    got = greedy_generate(Model(cfg), params, reference_bf16["prompt"],
                          STEPS, MAX_LEN, donate=True)
    assert params["lm_head"].dtype == torch.bfloat16   # donated
    np.testing.assert_array_equal(got.numpy(), reference_bf16["exact"])


def test_donated_session_with_carried_pq_head_equals_reference_bf16(
        reference_bf16):
    cfg = get_config(MOE)
    m = Model(cfg)
    params = model_params_from_numpy(reference_bf16["tree"], cfg,
                                     device="cpu")
    sess = dataclasses.replace(
        ServeSession.create(m, params, MAX_LEN, donate=True),
        pq_head=HybridLMHead(cfg, backend="ref"),
        pq_params=hybrid_head_from_numpy(reference_bf16["head"],
                                         codes_packed=False, device="cpu"))
    prompt = torch.from_numpy(reference_bf16["prompt"]).long()
    _, state = sess.prefill({"tokens": prompt})
    counts = torch.zeros((prompt.shape[0], cfg.vocab_size))
    serving._bump(counts, prompt)
    tok = sess.next_token(
        serving._last_hidden(m, sess.params, {"tokens": prompt}), counts)
    out = [tok]
    for _ in range(STEPS - 1):
        serving._bump(counts, tok[:, None])
        hidden, state = m.decode_step(sess.params, state, tok,
                                      return_hidden=True)
        tok = sess.next_token(hidden, counts)
        out.append(tok)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  reference_bf16["pq"])


def test_models_sum_bf16_products_in_f32(monkeypatch):
    """``forward``, ``loss``, ``prefill`` and ``decode_step`` run with
    cuBLAS's reduced-precision bf16 sums off (``device.f32_reductions``),
    and give the caller's setting back: on the card PyTorch's default let
    decode and forward part at qwen2-moe-a2.7b's 24 layers (C9)."""
    from repro_torch.models import mlp as mlp_mod
    matmul = torch.backends.cuda.matmul
    seen, moe = [], mlp_mod.moe

    def recording(x, p, cfg):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return moe(x, p, cfg)

    monkeypatch.setattr(mlp_mod, "moe", recording)
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    m = Model(get_config(MOE))
    params = serving._serving_params(m.init(SEED, device="cpu"), m.cfg)
    tokens = torch.randint(0, m.cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    m.forward(params, {"tokens": tokens})
    m.loss(params, {"tokens": tokens, "labels": tokens})
    _, state = m.prefill(params, {"tokens": tokens}, MAX_LEN)
    m.decode_step(params, state, tokens[:, -1])
    assert seen == [False] * (4 * m.cfg.num_layers)
    assert matmul.allow_bf16_reduced_precision_reduction is True
