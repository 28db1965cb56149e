"""The PQ LM head (``repro_torch.serve.hybrid_head``) against the JAX
package's, at smoke widths (d = 64 and 80, V = 512).

The JAX package builds ``HybridHeadParams`` on a random ``lm_head``; the
arrays cross through numpy (``interchange.hybrid_head_from_numpy``), so both
packages score the same params.  ``approx_topk`` on the port's ``ref``,
``cuda`` and ``cuda-packed`` backends (the last two run K1's plain version
on CPU tensors) returns the reference's ids, with scores within the kernel
tolerance, in f32; in bf16 the exact pass 3 rounds to bf16, so scores agree
within a bf16 step and ids except among scores tied within it.  The port's
own ``build`` reaches the reference's recall floor (tests/test_serving.py)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import ATOL, RTOL, assert_topk_match

from repro.core.pq import pack_codes
from repro.serve.hybrid_head import HybridLMHead as JaxHead
from repro_torch.interchange import hybrid_head_from_numpy
from repro_torch.serve import HybridLMHead

V, B = 512, 6
F32 = types.SimpleNamespace(dtype="float32")
BF16 = types.SimpleNamespace(dtype="bfloat16")
# one bf16 step relative (8 significant bits), and near zero
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3


@pytest.fixture(scope="module", params=[64, 80], ids=["d64", "d80"])
def case(request):
    """(lm_head, hidden, counts, JAX params, their arrays as numpy)."""
    d = request.param
    rng = np.random.default_rng(d)
    lm_head = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    hidden = rng.normal(size=(B, d)).astype(np.float32)
    counts = rng.integers(0, 4, (B, V)).astype(np.float32)
    hp = JaxHead(F32).build(jnp.asarray(lm_head))
    arrays = {"centers": np.asarray(hp.codebooks.centers),
              "codes": np.asarray(hp.codes), "q": np.asarray(hp.residual.q),
              "scale": np.asarray(hp.residual.scale),
              "zero": np.asarray(hp.residual.zero),
              "head": np.asarray(hp.head)}
    return lm_head, hidden, counts, hp, arrays


def _port_params(arrays, backend):
    packed = backend == "cuda-packed"
    if packed:
        arrays = {**arrays, "codes": pack_codes(arrays["codes"])}
    return hybrid_head_from_numpy(arrays, codes_packed=packed, device="cpu")


@pytest.mark.parametrize("backend", ["ref", "cuda", "cuda-packed"])
@pytest.mark.parametrize("penalty,with_counts", [(0.0, False), (0.1, True),
                                                 (0.0, True)])
def test_approx_topk_equals_reference_f32(case, backend, penalty,
                                          with_counts):
    _, hidden, counts, hp, arrays = case
    tc = counts if with_counts else None
    ws, wi = JaxHead(F32).approx_topk(
        hp, jnp.asarray(hidden), None if tc is None else jnp.asarray(tc),
        10, 8, penalty)
    head = HybridLMHead(F32, backend=backend)
    s, i = head.approx_topk(_port_params(arrays, backend),
                            torch.from_numpy(hidden),
                            None if tc is None else torch.from_numpy(tc),
                            10, 8, penalty)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["ref", "cuda-packed"])
def test_approx_topk_bf16_pass3(case, backend):
    _, hidden, counts, hp, arrays = case
    ws, wi = JaxHead(BF16).approx_topk(hp, jnp.asarray(hidden),
                                       jnp.asarray(counts), 10, 8, 0.1)
    s, i = HybridLMHead(BF16, backend=backend).approx_topk(
        _port_params(arrays, backend), torch.from_numpy(hidden),
        torch.from_numpy(counts), 10, 8, 0.1)
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi),
                      rtol=BF16_RTOL, atol=BF16_ATOL)


def test_bucketed_and_exact_equal_reference(case):
    _, hidden, counts, hp, arrays = case
    params = _port_params(arrays, "cuda")
    head = HybridLMHead(F32)
    assert head.backend.value == "cuda"      # None resolves to the kernels
    # b = 7 with buckets (2, 4): chunks of 4 + 3, the tail padded to 4
    hid = np.concatenate([hidden, hidden[:1]])
    cnt = np.concatenate([counts, counts[:1]])
    for b in (1, 3, 7):
        s, i = head.approx_topk(params, torch.from_numpy(hid[:b]),
                                torch.from_numpy(cnt[:b]), 10, 8, 0.1)
        bs, bi = head.approx_topk_bucketed(params, torch.from_numpy(hid[:b]),
                                           torch.from_numpy(cnt[:b]), 10, 8,
                                           0.1, buckets=(2, 4))
        assert bi.shape == (b, 10)
        assert_topk_match(bs.numpy(), bi.numpy(), s.numpy(), i.numpy())
    ws, wi = JaxHead(F32).exact_topk(hp, jnp.asarray(hidden),
                                     jnp.asarray(counts), 20, 0.1)
    s, i = head.exact_topk(params, torch.from_numpy(hidden),
                           torch.from_numpy(counts), 20, 0.1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["ref", "cuda-packed"])
def test_port_build_recall(case, backend):
    """The port's own build (its own k-means draws) at the reference's
    recall@20 floor against ``exact_topk``, tests/test_serving.py:23-32."""
    lm_head, hidden, _, _, _ = case
    head = HybridLMHead(F32, backend=backend)
    params = head.build(torch.from_numpy(lm_head), device="cpu")
    d = lm_head.shape[0]
    kc = -(-(d // 2) // 2) if backend == "cuda-packed" else d // 2
    assert params.codes.shape == (V, kc)
    assert params.codes_packed == (backend == "cuda-packed")
    assert tuple(params.head.shape) == (d, V)
    _, ia = head.approx_topk(params, hidden, None, 20, 8, 0.0)
    _, ie = head.exact_topk(params, hidden, None, 20, 0.0)
    rec = np.mean([len(set(a.tolist()) & set(e.tolist())) / 20
                   for a, e in zip(ia.numpy(), ie.numpy())])
    assert rec >= 0.9


def test_build_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridLMHead(F32).build(np.zeros((8, 16), np.float32))


def test_train_codebooks_in_pieces_keeps_the_bits(monkeypatch):
    """k-means walks the subspaces in pieces where the (K, N, 16) distance
    block would pass ``pq.BLOCK_BYTES`` (17 GB at K = 4096 over 65536
    rows): the init draws and every center keep their bits."""
    from repro_torch.core import pq
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(700, 64))
                         .astype(np.float32))
    whole = pq.train_codebooks(x, 32, 16, iters=8, seed=3)
    for per_piece in (1, 5, 31):
        monkeypatch.setattr(pq, "BLOCK_BYTES", per_piece * 700 * 16 * 4)
        pieces = pq.train_codebooks(x, 32, 16, iters=8, seed=3)
        assert torch.equal(pieces.centers, whole.centers), per_piece
