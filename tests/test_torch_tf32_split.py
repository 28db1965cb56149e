"""K3's 3xTF32 split (``repro_torch.kernels.ref.tf32_split``), emulated on
the CPU.

K3 (``src/repro_torch/csrc/block_sparse.cu``) runs the head product on the
tensor cores in TF32, which keeps 10 of f32's 23 mantissa bits.  It splits
each operand into ``hi = rna(x)`` and ``lo = rna(x - hi)``; per k-step of 8
it sums tile_lo·q_hi, then tile_hi·q_lo, then tile_hi·q_hi from zero and
adds that partial sum to the row block's running f32 sum.  Here that order
is emulated with f32 products summed in f32, at D_pad = 256 and, with
positive values, at D_pad = 512 (four tiles in a row block), and held
against the plain version and the JAX package's Pallas kernel (in
interpret mode) within the port's tolerance, rtol 1e-5 and atol 1e-4; and
tile_hi·q_hi alone is shown to miss it, so the split is needed.  Inputs are
made with numpy from a seed: normal values, and positive lognormal values
over 1e-3..1e3 like the head's weights (``data/hybrid_synth.py``).  The
card runs the kernel itself against the plain version in ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import ATOL, RTOL

from repro.kernels import ops as jops
from repro_torch.kernels.block_sparse import dense_to_bcsr
from repro_torch.kernels.ref import block_sparse_plain, tf32_split


def _values(rng, shape, kind):
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    return np.clip(rng.lognormal(0.0, 2.3, size=shape), 1e-3, 1e3).astype(
        np.float32)


def _inputs(q, kind, db=2, seed=14):
    """3 row blocks x ``db`` column blocks: row block 0 holds all ``db``
    tiles, row block 1 none, row block 2 all but column block 0."""
    rng = np.random.default_rng(seed)
    x = _values(rng, (384, db * 128), kind)
    x[128:256] = 0.0
    x[256:, :128] = 0.0
    qh = _values(rng, (q, db * 128), kind)
    tiles, ptr, col = dense_to_bcsr(x, 128, 128)
    assert list(ptr) == [0, db, db, 2 * db - 1]
    assert list(col) == list(range(db)) + list(range(1, db))
    return qh, tiles, ptr, col


def _emulate(q, tiles, ptr, col, terms):
    """K3's sum, one k-step of 8 at a time: the f32 products of the TF32
    slices named by ``terms`` (tile part, query part), in that order, summed
    from zero, then added to the row block's running f32 sum."""
    q_hi, q_lo = tf32_split(torch.from_numpy(q))
    t_hi, t_lo = tf32_split(torch.from_numpy(tiles))
    parts = {"hi": (t_hi, q_hi), "lo": (t_lo, q_lo)}
    nb = len(ptr) - 1
    out = torch.zeros((q.shape[0], nb, 128), dtype=torch.float32)
    for jn in range(nb):
        acc = torch.zeros((q.shape[0], 128), dtype=torch.float32)
        for t in range(ptr[jn], ptr[jn + 1]):
            c0 = int(col[t]) * 128
            for k0 in range(0, 128, 8):
                p = torch.zeros_like(acc)
                for tile_part, q_part in terms:
                    a = parts[tile_part][0][t, :, k0:k0 + 8]          # (128, 8)
                    b = parts[q_part][1][:, c0 + k0:c0 + k0 + 8]       # (Q, 8)
                    p = p + b @ a.T
                acc = acc + p
        out[:, jn] = acc
    return out.reshape(q.shape[0], nb * 128).numpy()


THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
CASES = [pytest.param(q, kind, 2, id=f"{q}-{kind}")
         for q in (1, 37) for kind in ("normal", "lognormal")
         ] + [pytest.param(37, "lognormal", 4, id="37-lognormal-dpad512")]


def _within(got, want):
    return bool(np.all(np.abs(got - want) <= ATOL + RTOL * np.abs(want)))


@pytest.mark.parametrize("kind", ["normal", "lognormal"])
def test_split_rounds_to_nearest_ties_away(kind):
    """hi and lo are TF32 values (the 13 low bits clear), rounded to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds:
    checked against a float64 rounding of the 11-bit significand."""
    rng = np.random.default_rng(3)
    x = _values(rng, 4096, kind)
    x[:4] = [1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, -(2 - 2**-12)]
    hi, lo = tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    m, e = np.frexp(np.abs(x.astype(np.float64)))
    want = np.sign(x) * np.ldexp(np.floor(np.ldexp(m, 11) + 0.5), e - 11)
    np.testing.assert_array_equal(hi.numpy(), want.astype(np.float32))
    assert hi[:4].tolist() == [1 + 2**-10, -(1 + 2**-10), 1 + 2**-9, -2.0]


@pytest.mark.parametrize("kind", ["normal", "lognormal"])
def test_hi_plus_lo_recovers_x(kind):
    x = _values(np.random.default_rng(4), 100_000, kind).astype(np.float64)
    hi, lo = tf32_split(torch.from_numpy(x.astype(np.float32)))
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x)
    assert np.all(err <= 2.0**-22 * np.abs(x))


@pytest.mark.parametrize("q,kind,db", CASES)
def test_3xtf32_holds_the_tolerance(q, kind, db):
    qh, tiles, ptr, col = _inputs(q, kind, db)
    got = _emulate(qh, tiles, ptr, col, THREE)
    plain = block_sparse_plain(torch.from_numpy(qh), torch.from_numpy(tiles),
                               torch.from_numpy(ptr),
                               torch.from_numpy(col)).numpy()
    jax_out = np.asarray(jops.block_sparse_matmul_bcsr(
        jnp.asarray(qh), jnp.asarray(tiles), jnp.asarray(ptr),
        jnp.asarray(col), max_steps=db))
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=ATOL)
    assert (got[:, 128:256] == 0).all()


@pytest.mark.parametrize("q,kind,db", CASES)
def test_1xtf32_misses_the_tolerance(q, kind, db):
    qh, tiles, ptr, col = _inputs(q, kind, db)
    plain = block_sparse_plain(torch.from_numpy(qh), torch.from_numpy(tiles),
                               torch.from_numpy(ptr),
                               torch.from_numpy(col)).numpy()
    assert _within(_emulate(qh, tiles, ptr, col, THREE), plain)
    assert not _within(_emulate(qh, tiles, ptr, col, (("hi", "hi"),)), plain)
