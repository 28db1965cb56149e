"""K1 and K2 take any K, on the CPU.

The kernels run only on the card, where ``chip_smoke.py``'s
``kernels_checked.edge_cases_wide_k`` holds their wide variants to the plain
versions bit for bit.  Here: the planners (``lut16.plan_adc`` and
``lut16.plan_topk`` with the ``topk_smem_bytes`` mirror) plan every K up to
8192 within a CTA's shared memory and with 8 warps an SM or more; K = 100
plans are the ones the kernels had before K was chunked; the wrappers on
CPU tensors at wide K equal the JAX package; and numpy replays of the wide
variants' order of adds equal the plain versions bit for bit (K1: a row
range walked once a chunk of subspaces, the partial sum carried in ``out``;
K2: a 256-row chunk's sum taken a chunk at a time in registers), while a
replay that sums each chunk from zero and then adds the chunk sums does
not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import ATOL, RTOL, assert_topk_match

from repro.kernels import ref as jref
from repro_torch.kernels import lut16, ops, ref

WIDE_KS = sorted(set(range(1, 8193, 61)) | {
    694, 704, 718, 1152, 1178, 1194, 1792, 2046, 2047, 2048, 2560, 4095,
    4096, 8191, 8192})


def _shape(k_sub, packed):
    """(kc, kl) of K subspaces: the LUT the kernels read carries odd packed
    K's phantom column."""
    kc = -(-k_sub // 2) if packed else k_sub
    return kc, (2 * kc if packed else k_sub)


@pytest.mark.parametrize("packed", [False, True])
def test_k1_plans_every_k(packed):
    for k_sub in WIDE_KS:
        kc, kl = _shape(k_sub, packed)
        for q, n in ((1, 152064), (32, 152064), (33, 3001)):
            p = lut16.plan_adc(q, n, kc, kl, 132, packed)
            where = (k_sub, q, n, p)
            assert p.smem_bytes == lut16.adc_smem_bytes(p.bq, kc, kl,
                                                        p.threads, p.chunk)
            assert p.smem_bytes <= lut16.SMEM_PER_CTA, where
            assert p.ctas_per_sm * (p.smem_bytes + 1024) <= lut16.SMEM_PER_SM
            assert 8 <= p.warps_per_sm <= lut16.ADC_WARPS_PER_SM, where
            assert p.chunk is None or (p.chunk % 4 == 0
                                       and 0 < p.chunk < kc), where
            assert p.rows_per_cta % p.threads == 0


@pytest.mark.parametrize("packed", [False, True])
def test_k2_plans_every_k(packed):
    for k_sub in WIDE_KS:
        kc, kl = _shape(k_sub, packed)
        for q in (1, 8, 128):
            for cbuf in (128, 512, 1024):
                p = lut16.plan_topk(q, kc, kl, cbuf)
                where = (k_sub, q, cbuf, p)
                assert p.smem_bytes == lut16.topk_smem_bytes(p.bq, kc, kl,
                                                             cbuf, p.chunk)
                assert p.smem_bytes <= lut16.SMEM_PER_CTA, where
                assert 1 <= p.ctas_per_sm <= lut16.TOPK_CTAS_PER_SM
                assert p.ctas_per_sm * (p.smem_bytes + 1024) \
                    <= lut16.SMEM_PER_SM
                assert p.warps_per_sm >= 8, where
                assert p.chunk is None or (p.chunk % 4 == 0
                                           and 0 < p.chunk < kc), where
                # one chunk wherever one query's whole image fits
                fits = lut16.topk_smem_bytes(1, kc, kl, cbuf) \
                    <= lut16.SMEM_PER_CTA
                assert (p.chunk is None) == fits, where


# K = 100, unpacked (kc 100) and packed (kc 50): (Q, N, packed) -> (bq,
# threads, rows_per_cta, smem_bytes, ctas_per_sm) of plan_adc before K was
# chunked, on 132 SMs
PARENT_K1 = {
    (1, 64, False): (1, 64, 64, 19200, 11),
    (1, 3001, False): (1, 512, 512, 108800, 2),
    (1, 152064, False): (1, 512, 1024, 108800, 2),
    (1, 524288, False): (1, 512, 2048, 108800, 2),
    (5, 64, False): (8, 64, 64, 64000, 3),
    (5, 3001, False): (8, 896, 896, 230400, 1),
    (8, 152064, False): (8, 896, 1792, 230400, 1),
    (8, 524288, False): (8, 896, 4480, 230400, 1),
    (33, 64, False): (16, 64, 64, 115200, 2),
    (33, 3001, False): (16, 640, 640, 230400, 1),
    (33, 152064, False): (16, 640, 3840, 230400, 1),
    (128, 524288, False): (16, 640, 33280, 230400, 1),
    (1, 64, True): (1, 64, 64, 12832, 16),
    (1, 152064, True): (1, 64, 128, 12832, 16),
    (1, 524288, True): (1, 64, 256, 12832, 16),
    (5, 64, True): (8, 64, 64, 57632, 3),
    (8, 3001, True): (8, 512, 512, 102432, 2),
    (8, 524288, True): (8, 512, 2048, 102432, 2),
    (33, 152064, True): (8, 512, 3072, 102432, 2),
    (128, 524288, True): (8, 512, 32768, 102432, 2),
}

# K = 100: (Q, cbuf, packed) -> (bq, smem_bytes) of K2 before K was chunked
# (csrc/lut16.cu's topk_smem and the largest bq <= 4 that fits)
PARENT_K2 = {
    (1, 128, False): (1, 35088), (1, 512, False): (1, 38160),
    (1, 1024, False): (1, 42256), (2, 512, False): (2, 50720),
    (8, 128, False): (4, 63552), (128, 512, False): (4, 75840),
    (128, 1024, False): (4, 92224), (1, 512, True): (1, 25872),
    (2, 1024, True): (2, 46624), (8, 512, True): (4, 63552),
    (128, 1024, True): (4, 79936),
}


@pytest.mark.parametrize("key", sorted(PARENT_K1))
def test_k100_k1_plans_unchanged(key):
    q, n, packed = key
    p = lut16.plan_adc(q, n, 50 if packed else 100, 100, 132, packed)
    assert p.chunk is None
    assert (p.bq, p.threads, p.rows_per_cta, p.smem_bytes,
            p.ctas_per_sm) == PARENT_K1[key]


def test_k100_k2_plans_unchanged():
    for (q, cbuf, packed), want in PARENT_K2.items():
        p = lut16.plan_topk(q, 50 if packed else 100, 100, cbuf)
        assert p.chunk is None and (p.bq, p.smem_bytes) == want


def _inputs(seed, n, k_sub, q, packed):
    """Codes, their stored form, a LUT whose sums are O(1) as inner
    products are (entries of scale 1/sqrt(K)), the LUT as the kernels read
    it, and a (Q, N) bias."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (n, k_sub)).astype(np.uint8)
    lut = (rng.normal(size=(q, k_sub, 16)) / np.sqrt(k_sub)).astype(
        np.float32)
    base = rng.normal(size=(q, n)).astype(np.float32)
    stored = ops.pack_codes(codes) if packed else codes
    lut_p = ops._validate_packed(stored.shape[1], k_sub, 16,
                                 torch.from_numpy(lut), packed).numpy()
    return codes, stored, lut, lut_p, base


@pytest.mark.parametrize("k_sub,packed", [(2048, False), (4095, True)])
def test_wide_ops_match_jax(k_sub, packed):
    codes, stored, lut, lut_p, base = _inputs(k_sub, 300, k_sub, 3, packed)
    st, lt, bt = map(torch.from_numpy, (stored, lut, base))
    want = np.asarray(jref.lut16_adc_ref(jnp.asarray(codes),
                                         jnp.asarray(lut)))
    got = ops.lut16_adc(st, lt, packed=packed)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ws, wi = jax.lax.top_k(jnp.asarray(base) + want, 40)
    s, i = ops.lut16_adc_topk(st, lt, 40, bias=bt, packed=packed)
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi))
    # K1's plain version + a stable sort is K2's plain selection, bit for
    # bit
    lp = torch.from_numpy(lut_p)
    dense = ref.lut16_adc_plain(st, lp, packed=packed)
    assert torch.equal(dense, got)
    want_s, want_i = ref.stable_topk(bt + dense, 40)
    ps, pi = ref.lut16_adc_topk_plain(st, lp, bt, 40, packed=packed)
    assert torch.equal(ps, want_s) and torch.equal(pi, want_i)


# -- replays of the wide variants' order of adds ------------------------------

def _stage_chunk(flat, kc, c0, cb, row0, rows, buf):
    """``stage_chunk``: bytes [c0, c0 + cb) of each row into its slot of
    code_stride(cb) words (both the word and the byte copy write exactly
    these bytes; the rest of the buffer keeps its old bytes)."""
    slot = 4 * lut16.code_stride(cb)
    for r in range(rows):
        src = (row0 + r) * kc + c0
        buf[r * slot:r * slot + cb] = flat[src:src + cb]


def _slot_words(buf, cb, rows):
    """(rows, ceil(cb / 4)) code words as ``AlignedWords`` reads a slot."""
    words = buf.view("<u4").astype(np.uint64)
    r = np.arange(rows)[:, None]
    w = np.arange(-(-cb // 4))[None, :]
    return words[r * lut16.code_stride(cb) + w]


def _add_row(acc, words, cb, image, bq, packed):
    """``add_row``: acc (bq, rows) += each code byte's subspaces in order."""
    qv = lut16.query_vec(bq)
    per_byte = (2 if packed else 1) * 16 * bq

    def add_code(base, code):
        off = base + (code & 15).astype(np.int64) * qv
        for g in range(bq // qv):
            for i in range(qv):
                acc[g * qv + i] += image[off + g * 16 * qv + i]

    for b in range(cb):
        byte = (words[:, b // 4] >> np.uint64(8 * (b % 4))) & np.uint64(0xFF)
        add_code(b * per_byte, byte)
        if packed:
            add_code(b * per_byte + 16 * bq, byte >> np.uint64(4))


def _chunk_image(lut, q0, bq, k0, kl):
    block = np.zeros((bq, kl, 16), np.float32)
    live = min(bq, lut.shape[0] - q0)
    block[:live] = lut[q0:q0 + live, k0:k0 + kl]
    image = np.empty(bq * kl * 16, np.float32)
    image[lut16.lut_image_index(bq, kl).reshape(-1)] = block.reshape(-1)
    return image


def replay_wide_k1(stored, lut, packed, plan, *, fresh_chunks=False,
                   seed=0):
    """``lut16_adc_wide_kernel`` under ``plan`` in numpy: (Q, N) f32.
    fresh_chunks=True is the mutation: each chunk summed from zero and the
    chunk sums added to ``out``."""
    n, kc = stored.shape
    q, kl, _ = lut.shape
    spb, cw, bq, threads = kl // kc, plan.chunk, plan.bq, plan.threads
    flat = np.ascontiguousarray(stored).reshape(-1)
    rng = np.random.default_rng(seed)
    out = np.full((q, n), np.nan, np.float32)
    ranges, qblocks = plan.grid(q, n)
    for qb in range(qblocks):
        q0 = qb * bq
        live = min(bq, q - q0)
        for rg in range(ranges):
            start = rg * plan.rows_per_cta
            end = min(n, start + plan.rows_per_cta)
            for c0 in range(0, kc, cw):
                cb = min(cw, kc - c0)
                image = _chunk_image(lut, q0, bq, c0 * spb, cb * spb)
                bufs = [rng.integers(0, 256, threads * 4 *
                                     lut16.code_stride(cw), dtype=np.uint8)
                        for _ in range(2)]
                for c, row0 in enumerate(range(start, end, threads)):
                    rows = min(threads, end - row0)
                    buf = bufs[c % 2]
                    _stage_chunk(flat, kc, c0, cb, row0, rows, buf)
                    acc = np.zeros((bq, rows), np.float32)
                    cells = out[q0:q0 + live, row0:row0 + rows]
                    if c0 and not fresh_chunks:
                        acc[:live] = cells
                    _add_row(acc, _slot_words(buf, cb, rows), cb, image, bq,
                             packed)
                    if c0 and fresh_chunks:
                        acc[:live] += cells
                    out[q0:q0 + live, row0:row0 + rows] = acc[:live]
    return out


def replay_wide_k2_scores(stored, lut, base, packed, bq, cw):
    """The scores ``lut16_topk_partial_kernel<..., WIDE>`` selects from:
    each 256-row chunk's sums from +0, a chunk of subspaces at a time in
    registers, then ``base +`` the full sum.  (Q, N) f32."""
    n, kc = stored.shape
    q, kl, _ = lut.shape
    spb = kl // kc
    flat = np.ascontiguousarray(stored).reshape(-1)
    out = np.empty((q, n), np.float32)
    buf = np.zeros(lut16.THREADS * 4 * lut16.code_stride(cw), np.uint8)
    for q0 in range(0, q, bq):
        live = min(bq, q - q0)
        for row0 in range(0, n, lut16.THREADS):
            rows = min(lut16.THREADS, n - row0)
            acc = np.zeros((bq, rows), np.float32)
            for c0 in range(0, kc, cw):
                cb = min(cw, kc - c0)
                _stage_chunk(flat, kc, c0, cb, row0, rows, buf)
                _add_row(acc, _slot_words(buf, cb, rows), cb,
                         _chunk_image(lut, q0, bq, c0 * spb, cb * spb), bq,
                         packed)
            out[q0:q0 + live, row0:row0 + rows] = (
                base[q0:q0 + live, row0:row0 + rows] + acc[:live])
    return out


# (N, K, Q, packed, bq, threads, rows_per_cta, chunk): kc % 4 != 0 (50,
# the byte copy, a last chunk of 2 bytes), kc % 4 == 0 (48, 16-byte
# chunks), odd packed K (99 -> kc 50, its phantom column in the last
# chunk), Q off the query block, ranges ending mid-chunk; and a plan of
# plan_adc's own at K = 2048
REPLAY_CASES = [
    (200, 50, 3, False, 4, 64, 128, 12),
    (150, 48, 5, False, 2, 32, 96, 16),
    (130, 99, 9, True, 8, 64, 64, 8),
    (70, 13, 1, False, 1, 32, 64, 4),
]


@pytest.mark.parametrize("n,k_sub,q,packed,bq,threads,rows,chunk",
                         REPLAY_CASES)
def test_wide_k1_replay_equals_plain(n, k_sub, q, packed, bq, threads, rows,
                                     chunk):
    _, stored, _, lut_p, _ = _inputs(n + k_sub, n, k_sub, q, packed)
    kc, kl = stored.shape[1], lut_p.shape[1]
    plan = lut16.AdcPlan(
        bq=bq, threads=threads, rows_per_cta=rows,
        smem_bytes=lut16.adc_smem_bytes(bq, kc, kl, threads, chunk),
        ctas_per_sm=1, chunk=chunk)
    want = ref.lut16_adc_plain(torch.from_numpy(stored),
                               torch.from_numpy(lut_p), packed=packed).numpy()
    np.testing.assert_array_equal(replay_wide_k1(stored, lut_p, packed, plan),
                                  want)
    # summing each chunk apart and adding the chunk sums is another order
    mutated = replay_wide_k1(stored, lut_p, packed, plan, fresh_chunks=True)
    assert not np.array_equal(mutated, want)


def test_wide_k1_replay_at_a_planned_k():
    n, k_sub, q = 40, 2048, 3
    _, stored, _, lut_p, _ = _inputs(7, n, k_sub, q, False)
    plan = lut16.plan_adc(q, n, k_sub, k_sub, 132)
    assert plan.chunk is not None and plan.chunks(k_sub) > 1
    want = ref.lut16_adc_plain(torch.from_numpy(stored),
                               torch.from_numpy(lut_p)).numpy()
    np.testing.assert_array_equal(replay_wide_k1(stored, lut_p, False, plan),
                                  want)


@pytest.mark.parametrize("n,k_sub,q,packed,bq,chunk", [
    (300, 50, 3, False, 4, 12), (260, 99, 2, True, 2, 8),
    (257, 1194, 1, False, 1, 204)])
def test_wide_k2_replay_equals_plain(n, k_sub, q, packed, bq, chunk):
    _, stored, _, lut_p, base = _inputs(n * k_sub, n, k_sub, q, packed)
    got = replay_wide_k2_scores(stored, lut_p, base, packed, bq, chunk)
    want = (torch.from_numpy(base) + ref.lut16_adc_plain(
        torch.from_numpy(stored), torch.from_numpy(lut_p),
        packed=packed)).numpy()
    np.testing.assert_array_equal(got, want)
