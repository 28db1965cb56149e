"""Port kernels (repro_torch.kernels) against the JAX package's kernels on
the CPU.

On CPU tensors the port's wrappers run the plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does.  The same numpy inputs go through both.  Tolerance: rtol 1e-5,
atol 1e-4, the kernel tolerance of tests/test_kernels.py (the two packages
sum in different orders).  The CUDA kernels themselves run only on the card
(chip_smoke.py holds them against these plain versions there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import ATOL, RTOL, assert_topk_match

from repro.kernels import ops as jops
from repro.kernels.block_sparse import dense_to_bcsr as jax_dense_to_bcsr
from repro.kernels.lut16 import pack_codes as jax_pack
from repro.kernels.lut16 import unpack_codes as jax_unpack
from repro_torch.core.sparse_index import PaddedInvertedIndex
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_sparse import dense_to_bcsr


def _codes_lut(seed, n, k, q, l=16):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, l, (n, k)).astype(np.uint8)
    lut = rng.normal(size=(q, k, l)).astype(np.float32)
    return codes, lut


@pytest.mark.parametrize("k", [12, 13, 1])
def test_pack_unpack_match_jax(k):
    codes, _ = _codes_lut(0, 64, k, 1)
    packed = ops.pack_codes(codes)
    np.testing.assert_array_equal(packed, jax_pack(codes))
    np.testing.assert_array_equal(
        ops.unpack_codes(torch.from_numpy(packed), k).numpy(),
        np.asarray(jax_unpack(jnp.asarray(packed), k)))
    np.testing.assert_array_equal(
        ops.unpack_codes(torch.from_numpy(packed), k).numpy(), codes)


def test_pack_rejects_wide_codes():
    with pytest.raises(ValueError, match="4-bit"):
        ops.pack_codes(np.full((4, 8), 16, np.uint8))
    with pytest.raises(ValueError):
        ops.unpack_codes(torch.zeros((4, 4), dtype=torch.uint8), 6)


@pytest.mark.parametrize("zero", ["some", "all"])
def test_dense_to_bcsr_matches_jax(zero):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(512, 256)).astype(np.float32)
    if zero == "all":
        x[:] = 0.0
    else:
        x[128:256] = 0.0            # a row block without tiles
        x[:128, 128:] = 0.0         # a zero tile
    for got, want in zip(dense_to_bcsr(x, 128, 128),
                         jax_dense_to_bcsr(x, 128, 128)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k,q,l,packed", [
    (512, 16, 8, 16, False),
    (777, 13, 5, 16, True),      # odd K: phantom nibble
    (300, 1, 3, 16, True),
    (1000, 12, 4, 16, True),
    (257, 9, 3, 8, False),       # narrower codebooks
])
def test_lut16_adc_matches_jax(n, k, q, l, packed):
    codes, lut = _codes_lut(2, n, k, q, l)
    stored = ops.pack_codes(codes) if packed else codes
    got = ops.lut16_adc(torch.from_numpy(stored), torch.from_numpy(lut),
                        packed=packed)
    want = jops.lut16_adc(jnp.asarray(stored), jnp.asarray(lut), packed=packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_lut16_adc_single_query():
    codes, lut = _codes_lut(3, 256, 8, 1)
    got = ops.lut16_adc(torch.from_numpy(codes), torch.from_numpy(lut[0]))
    assert got.shape == (256,)
    want = jops.lut16_adc(jnp.asarray(codes), jnp.asarray(lut[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _topk_inputs(seed, n, k_sub, q, *, packed):
    """Codes, LUT, a (Q, N) bias and an (N,) -inf row mask, with rows
    TIES planted: identical codes and bias, so every order of summation
    gives them the same score, high enough to lead every query."""
    codes, lut = _codes_lut(seed, n, k_sub, q)
    rng = np.random.default_rng(seed + 1)
    ties = np.array([2, 3, n // 2, n - 1])
    codes[ties] = codes[2]
    bias = rng.normal(size=(q, n)).astype(np.float32)
    bias[:, ties] = 1000.0
    mask = np.where(rng.random(n) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[ties] = 0.0
    stored = ops.pack_codes(codes) if packed else codes
    return stored, lut, bias, mask, ties


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("base", ["bias", "mask", "both", "none"])
@pytest.mark.parametrize("packed", [False, True])
def test_lut16_adc_topk_matches_jax(fused, base, packed):
    n, k_sub, q, k = 700, 11, 5, 40
    stored, lut, bias, mask, ties = _topk_inputs(4, n, k_sub, q, packed=packed)
    b = bias if base in ("bias", "both") else None
    rm = mask if base in ("mask", "both") else None
    got = ops.lut16_adc_topk(
        torch.from_numpy(stored), torch.from_numpy(lut), k,
        bias=None if b is None else torch.from_numpy(b),
        row_mask=None if rm is None else torch.from_numpy(rm),
        packed=packed, fused=fused)
    want = jops.lut16_adc_topk(
        jnp.asarray(stored), jnp.asarray(lut), k,
        bias=None if b is None else jnp.asarray(b),
        row_mask=None if rm is None else jnp.asarray(rm),
        packed=packed, fused=fused)
    assert_topk_match(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                      np.asarray(want[1]))
    if b is not None:           # planted ties: lowest row first, every query
        np.testing.assert_array_equal(got[1][:, :len(ties)].numpy(),
                                      np.broadcast_to(ties, (q, len(ties))))
    if rm is not None:          # masked rows never surface
        ids = got[1].numpy()
        assert not np.isin(ids[ids >= 0], np.flatnonzero(np.isinf(rm))).any()


def test_lut16_adc_topk_fewer_finite_than_k():
    """Only 3 live rows and k=8: the rest are (-inf, -1), as in JAX."""
    n, k_sub, q = 300, 6, 2
    codes, lut = _codes_lut(5, n, k_sub, q)
    mask = np.full(n, -np.inf, np.float32)
    mask[[7, 100, 299]] = 0.0
    for fused in (True, False):
        s, ids = ops.lut16_adc_topk(torch.from_numpy(codes),
                                    torch.from_numpy(lut), 8,
                                    row_mask=torch.from_numpy(mask),
                                    fused=fused)
        ws, wids = jops.lut16_adc_topk(jnp.asarray(codes), jnp.asarray(lut), 8,
                                       row_mask=jnp.asarray(mask), fused=fused)
        assert_topk_match(s.numpy(), ids.numpy(), np.asarray(ws),
                          np.asarray(wids))
        assert (ids[:, 3:] == -1).all() and torch.isinf(s[:, 3:]).all()


@pytest.mark.parametrize("packed", [False, True])
def test_fused_and_materialised_bit_identical(packed):
    """Inside the port the fused select and materialise-then-sort return
    the same bits, above and below MAX_FUSED_CANDIDATES."""
    n, k_sub, q = 1500, 9, 3
    stored, lut, bias, mask, _ = _topk_inputs(6, n, k_sub, q, packed=packed)
    args = (torch.from_numpy(stored), torch.from_numpy(lut))
    kw = dict(bias=torch.from_numpy(bias), row_mask=torch.from_numpy(mask),
              packed=packed)
    for k in (1, 300, ops.MAX_FUSED_CANDIDATES):
        s1, i1 = ops.lut16_adc_topk(*args, k, fused=True, **kw)
        s2, i2 = ops.lut16_adc_topk(*args, k, fused=False, **kw)
        assert torch.equal(s1, s2) and torch.equal(i1, i2)


def test_topk_above_fused_cap_matches_jax():
    n, k_sub, q, k = 1300, 5, 2, 1100        # k > MAX_FUSED_CANDIDATES
    stored, lut, bias, _, _ = _topk_inputs(7, n, k_sub, q, packed=False)
    got = ops.lut16_adc_topk(torch.from_numpy(stored), torch.from_numpy(lut),
                             k, bias=torch.from_numpy(bias))
    want = jops.lut16_adc_topk(jnp.asarray(stored), jnp.asarray(lut), k,
                               bias=jnp.asarray(bias))
    assert_topk_match(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                      np.asarray(want[1]))


@pytest.mark.parametrize("q", [5, 8])
def test_block_sparse_matmul_matches_jax(q):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(640, 256)).astype(np.float32)
    x[128:384] = 0.0
    x[:128, :128] = 0.0
    qh = rng.normal(size=(q, 256)).astype(np.float32)
    tiles, ptr, col = dense_to_bcsr(x, 128, 128)
    got = ops.block_sparse_matmul_bcsr(torch.from_numpy(qh),
                                       torch.from_numpy(tiles),
                                       torch.from_numpy(ptr),
                                       torch.from_numpy(col))
    want = jops.block_sparse_matmul_bcsr(
        jnp.asarray(qh), jnp.asarray(tiles), jnp.asarray(ptr),
        jnp.asarray(col), max_steps=int(np.max(np.diff(ptr))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert (got[:, 128:384] == 0).all()


def test_onehot_matches_jax():
    """Both round the LUT to bf16 and multiply exactly by 0/1; only the f32
    sum order differs, so the kernel tolerance holds."""
    codes, lut = _codes_lut(9, 400, 10, 4)
    got = ops.lut16_adc_onehot(torch.from_numpy(codes), torch.from_numpy(lut))
    want = jops.lut16_adc_onehot(jnp.asarray(codes), jnp.asarray(lut))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_take_plain_versions():
    """The wrapper rule: CPU tensors run the plain versions and launch no
    kernel."""
    ops.reset_counts()
    codes, lut = _codes_lut(10, 300, 4, 2)
    ops.lut16_adc(torch.from_numpy(codes), torch.from_numpy(lut))
    ops.lut16_adc_topk(torch.from_numpy(codes), torch.from_numpy(lut), 5)
    tiles, ptr, col = dense_to_bcsr(np.ones((128, 128), np.float32), 128, 128)
    ops.block_sparse_matmul_bcsr(torch.ones((2, 128)), torch.from_numpy(tiles),
                                 torch.from_numpy(ptr), torch.from_numpy(col))
    stream = torch.zeros((1, 4), dtype=torch.int32)
    ops.inverted_value_forward(torch.tensor([0, 1], dtype=torch.int32),
                               stream, stream, torch.ones((1, 4)), bq=1, bn=4,
                               chunk=4, num_row_blocks=1)
    inv = PaddedInvertedIndex(rows=torch.tensor([[0, 2, 3]], dtype=torch.int32),
                              vals=torch.ones((1, 3)), num_points=3)
    ops.score_inverted_vf(inv, torch.zeros((2, 1), dtype=torch.int32),
                          torch.ones((2, 1)))
    cand = torch.zeros((2, 3), dtype=torch.int32)
    ops.adc_lut(torch.ones((2, 4)), torch.ones((2, 16, 2)))
    ops.dense_residual(torch.ones((3, 4), dtype=torch.int8), torch.ones(4),
                       torch.zeros(4), cand, torch.ones((2, 4)))
    ops.gathered_dot(torch.ones((3, 4)), cand, torch.ones((2, 4)))
    ops.sparse_residual(torch.zeros((3, 2), dtype=torch.int32),
                        torch.ones((3, 2)), cand, torch.ones((2, 5)))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert all(v == 1 for v in ref.PLAIN_CALLS.values())
    ops.reset_counts()


def test_packed_validation():
    codes, lut = _codes_lut(11, 50, 6, 2, l=8)
    with pytest.raises(ValueError, match="l == 16"):
        ops.lut16_adc(torch.from_numpy(ops.pack_codes(codes)),
                      torch.from_numpy(lut), packed=True)
    codes, lut = _codes_lut(11, 50, 6, 2)
    with pytest.raises(ValueError, match="cannot hold"):
        ops.lut16_adc(torch.from_numpy(codes), torch.from_numpy(lut),
                      packed=True)
    with pytest.raises(ValueError, match="0 < k <= N"):
        ops.lut16_adc_topk(torch.from_numpy(codes), torch.from_numpy(lut), 51)
