"""K1's host-side pieces on the CPU: its launch plan, the query-interleaved
LUT image, and a numpy replay of the kernel that reaches both.

The CUDA kernel (``csrc/lut16.cu:lut16_adc_kernel``) runs only on the card,
where ``chip_smoke.py`` holds it against ``ref.lut16_adc_plain`` bit for
bit.  Here ``replay_k1`` walks the same grid as the kernel: per query block
it builds the shared-memory LUT image through ``lut16.lut_image_index``, per
row range it stages each chunk's codes into one of two buffers as
``stage_codes`` does (word-aligned slots when kc % 4 == 0, else bytes back to
back in 16-byte pieces, zero-filled at the end, over stale bytes of the
chunk before), reads each row's code words as ``AlignedWords`` /
``ShiftedWords`` do (a funnel shift of two aligned words), and sums as
``score_row`` does: whole words, then the kc % 4 tail bytes, f32 from +0 in
subspace order.  So it must equal the plain version bit for bit; against
the JAX package's ``lut16_adc`` (Pallas in interpret mode, another sum
order) it holds the kernel tolerance, rtol 1e-5 / atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import ATOL, RTOL

from repro.kernels import ops as jops
from repro_torch.kernels import lut16, ops, ref

SLICE = dict(q=128, n=524288, kc=100, kl=100, sms=132)


def _u32(buf: np.ndarray) -> np.ndarray:
    return buf.view("<u4").astype(np.uint64)


def _stage(flat, kc, row0, rows, threads, buf):
    """``stage_codes`` into ``buf`` (uint8, its old bytes left where the copy
    does not write), thread by thread."""
    if kc % 4 == 0:
        wpr, stride = kc // 4, lut16.code_stride(kc)
        src = flat[row0 * kc:(row0 + rows) * kc].view("<u4")
        dst = buf.view("<u4")
        total = rows * wpr
        t = np.arange(threads)
        dr, dw = threads // wpr, threads - (threads // wpr) * wpr
        r, w, i = t // wpr, t % wpr, t.copy()
        while (i < total).any():
            live = i < total
            dst[r[live] * stride + w[live]] = src[i[live]]
            r, w = r + dr, w + dw
            wrap = w >= wpr
            w, r, i = w - wpr * wrap, r + wrap, i + threads
        return
    nbytes = rows * kc
    src = flat[row0 * kc:row0 * kc + nbytes]
    for i in range(0, nbytes, 16):
        piece = np.zeros(16, np.uint8)
        piece[:min(16, nbytes - i)] = src[i:i + 16]
        buf[i:i + 16] = piece


def _row_words(buf, kc, rows):
    """(rows, ceil(kc / 4)) code words as the kernel's readers return them."""
    nw = -(-kc // 4)
    words = _u32(buf)
    r = np.arange(rows)[:, None]
    w = np.arange(nw)[None, :]
    if kc % 4 == 0:
        return words[r * lut16.code_stride(kc) + w]
    byte0 = r * kc
    p = (byte0 >> 2) + w
    shift = 8 * (byte0 & 3)
    both = words[p] | (words[p + 1] << np.uint64(32))
    return (both >> shift.astype(np.uint64)) & np.uint64(0xFFFFFFFF)


def _score(words, kc, image, bq, packed):
    """``score_row`` for a chunk's rows: acc (bq, rows) f32."""
    qv = lut16.query_vec(bq)
    per_byte = (2 if packed else 1) * 16 * bq
    acc = np.zeros((bq, words.shape[0]), np.float32)

    def add_code(base, code):
        off = base + (code & 15).astype(np.int64) * qv
        for g in range(bq // qv):
            for i in range(qv):
                acc[g * qv + i] += image[off + g * 16 * qv + i]

    for b in range(kc):               # whole words, then the tail bytes
        byte = (words[:, b // 4] >> np.uint64(8 * (b % 4))) & np.uint64(0xFF)
        add_code(b * per_byte, byte)
        if packed:
            add_code(b * per_byte + 16 * bq, byte >> np.uint64(4))
    return acc


def replay_k1(stored: np.ndarray, lut: np.ndarray, packed: bool,
              plan: lut16.AdcPlan, seed: int = 0) -> np.ndarray:
    """K1 under ``plan`` in numpy: (Q, N) f32.  ``lut`` is (Q, kl, 16) as
    the kernel reads it (odd packed K already carrying its zero column)."""
    n, kc = stored.shape
    q, kl, _ = lut.shape
    bq, threads = plan.bq, plan.threads
    flat = np.ascontiguousarray(stored).reshape(-1)
    index = lut16.lut_image_index(bq, kl).reshape(-1)
    ranges, qblocks = plan.grid(q, n)
    rng = np.random.default_rng(seed)
    out = np.full((q, n), np.nan, np.float32)
    for qb in range(qblocks):
        q0 = qb * bq
        block = np.zeros((bq, kl, 16), np.float32)
        block[:min(bq, q - q0)] = lut[q0:q0 + bq]
        image = np.empty(bq * kl * 16, np.float32)
        image[index] = block.reshape(-1)
        for rg in range(ranges):
            # two staging buffers that start with garbage, as shared memory
            bufs = [rng.integers(0, 256, lut16.adc_stage_bytes(kc, threads),
                                 dtype=np.uint8) for _ in range(2)]
            start = rg * plan.rows_per_cta
            end = min(n, start + plan.rows_per_cta)
            for c, row0 in enumerate(range(start, end, threads)):
                rows = min(threads, end - row0)
                buf = bufs[c % 2]
                _stage(flat, kc, row0, rows, threads, buf)
                acc = _score(_row_words(buf, kc, rows), kc, image, bq,
                             packed)
                live = min(bq, q - q0)
                out[q0:q0 + live, row0:row0 + rows] = acc[:live]
    return out


def _inputs(seed, n, k_sub, q, packed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (n, k_sub)).astype(np.uint8)
    lut = rng.normal(size=(q, k_sub, 16)).astype(np.float32)
    stored = ops.pack_codes(codes) if packed else codes
    lut_p = ops._validate_packed(stored.shape[1], k_sub, 16,
                                 torch.from_numpy(lut), packed).numpy()
    return stored, lut, lut_p


# (N, K, Q, packed, SMs, explicit (threads, rows_per_cta) or None): Q not a
# multiple of the query block or group (1, 3, 5, 9, 17, 33); kc % 4 == 0
# with an odd (25) and an even (8) word count; kc % 4 != 0 (7, odd packed
# K = 99 -> 50, packed K = 13 -> 7); N not a multiple of the chunk, a range
# that ends mid-chunk, N below one chunk, several ranges and query blocks
REPLAY_CASES = [
    (1000, 100, 5, False, 1, None),
    (700, 99, 17, True, 2, None),
    (333, 7, 1, False, 3, None),
    (300, 32, 3, False, 1, (64, 192)),
    (90, 13, 2, True, 1, None),
    (517, 100, 8, True, 1, (96, 288)),
    (45, 10, 9, False, 132, None),
    (260, 100, 33, False, 1, (128, 256)),
]


@pytest.mark.parametrize("n,k_sub,q,packed,sms,explicit", REPLAY_CASES)
def test_replay_equals_plain(n, k_sub, q, packed, sms, explicit):
    stored, _, lut_p = _inputs(n + q, n, k_sub, q, packed)
    kc, kl = stored.shape[1], lut_p.shape[1]
    plan = lut16.plan_adc(q, n, kc, kl, sms, packed)
    if explicit is not None:
        threads, rows = explicit
        plan = lut16.AdcPlan(
            bq=plan.bq, threads=threads, rows_per_cta=rows,
            smem_bytes=lut16.adc_smem_bytes(plan.bq, kc, kl, threads),
            ctas_per_sm=1)
    got = replay_k1(stored, lut_p, packed, plan)
    want = ref.lut16_adc_plain(torch.from_numpy(stored),
                               torch.from_numpy(lut_p), packed=packed)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("case", [REPLAY_CASES[1], REPLAY_CASES[2]])
def test_replay_matches_jax(case):
    n, k_sub, q, packed, sms, _ = case
    stored, lut, lut_p = _inputs(n + q, n, k_sub, q, packed)
    plan = lut16.plan_adc(q, n, stored.shape[1], lut_p.shape[1], sms,
                          packed)
    got = replay_k1(stored, lut_p, packed, plan)
    want = jops.lut16_adc(jnp.asarray(stored), jnp.asarray(lut),
                          packed=packed)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bq,kl,qv", [
    (1, 7, None), (2, 100, None), (4, 50, None), (8, 100, None), (8, 1, None),
    (8, 100, 1), (8, 100, 2), (4, 7, 2), (2, 3, 1), (1, 100, 1)])
def test_lut_image_index_is_a_bijection(bq, kl, qv):
    index = lut16.lut_image_index(bq, kl, qv)
    assert index.shape == (bq, kl, 16)
    np.testing.assert_array_equal(np.sort(index.reshape(-1)),
                                  np.arange(bq * kl * 16))
    # one vector load: the qv queries of a group are adjacent floats from
    # a multiple of qv, and a group's 16 codes one span of 16 * qv floats
    qv = lut16.query_vec(bq) if qv is None else qv
    step = index[1:, :, :] - index[:-1, :, :]
    assert (step[np.arange(bq - 1) % qv != qv - 1] == 1).all()
    assert (index[::qv] % qv == 0).all()
    span = index[::qv].max(axis=2) - index[::qv].min(axis=2)
    assert (span == 15 * qv).all()


def test_image_gather_equals_plain():
    """Looking every (query, row, subspace) up through the image, summed in
    subspace order, gives the plain version's bits."""
    stored, lut, _ = _inputs(5, 200, 12, 8, False)
    image = np.empty(8 * 12 * 16, np.float32)
    index = lut16.lut_image_index(8, 12)
    image[index.reshape(-1)] = lut.reshape(-1)
    got = np.zeros((8, 200), np.float32)
    for k in range(12):
        got += image[index[:, k, :][:, stored[:, k]]]
    want = ref.lut16_adc_plain(torch.from_numpy(stored), torch.from_numpy(lut))
    np.testing.assert_array_equal(got, want.numpy())


def test_plan_at_the_slice_shapes():
    """The plans the querysim-shard's K1 launches run under (PERF.md §6):
    at Q = 128, 16 queries per CTA, 640-row chunks, one CTA of 20 warps per
    SM in 230,400 bytes, 16 x 8 CTAs; one query at 2 CTAs of 16 warps;
    packed K = 100 (kc = 50, bytes back to back, 8 queries) at 2 CTAs of 16
    warps."""
    p = lut16.plan_adc(**SLICE)
    assert (p.bq, p.threads, p.smem_bytes, p.ctas_per_sm) == (16, 640, 230400,
                                                                1)
    assert p.warps_per_sm == 20 and p.grid(128, 524288) == (16, 8)
    p1 = lut16.plan_adc(**{**SLICE, "q": 1})
    assert (p1.bq, p1.threads, p1.ctas_per_sm, p1.smem_bytes) == (1, 512, 2,
                                                                   108800)
    p8 = lut16.plan_adc(**{**SLICE, "q": 8})
    assert (p8.bq, p8.threads, p8.ctas_per_sm) == (8, 896, 1)
    pp = lut16.plan_adc(**{**SLICE, "kc": 50}, packed=True)
    assert (pp.bq, pp.threads, pp.ctas_per_sm, pp.smem_bytes) == (8, 512, 2,
                                                                   102432)


@pytest.mark.parametrize("q,n,kc,kl,packed", [
    (128, 524288, 100, 100, False), (8, 524288, 100, 100, False),
    (1, 524288, 100, 100, False), (128, 8192, 100, 100, False),
    (128, 524288, 50, 100, True), (3, 3001, 100, 100, False),
    (17, 40000, 50, 100, True), (130, 40000, 50, 100, True),
    (33, 9000, 32, 32, False), (1, 64, 50, 100, True), (5, 2500, 7, 7, False),
    (2, 1, 1, 1, False), (4, 10 ** 6, 300, 300, False),
])
def test_plan_invariants(q, n, kc, kl, packed):
    p = lut16.plan_adc(q, n, kc, kl, 132, packed)
    assert p.bq in ((1, 2, 4, 8) if packed else (1, 2, 4, 8, 16))
    assert p.bq <= max(1, 1 << (q - 1).bit_length())
    assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
    assert p.threads <= max(32, -(-n // 32) * 32)
    assert p.rows_per_cta % p.threads == 0
    assert p.smem_bytes == (p.bq * kl * 64
                            + 2 * lut16.adc_stage_bytes(kc, p.threads))
    assert p.smem_bytes <= lut16.SMEM_PER_CTA
    assert p.ctas_per_sm * (p.smem_bytes + 1024) <= lut16.SMEM_PER_SM
    assert p.warps_per_sm <= lut16.ADC_WARPS_PER_SM
    ranges, qblocks = p.grid(q, n)
    assert ranges * p.rows_per_cta >= n > (ranges - 1) * p.rows_per_cta
    assert qblocks * p.bq >= q
    # no other chunk keeps more warps resident
    for warps in range(1, min(32, -(-n // 32)) + 1):
        smem = lut16.adc_smem_bytes(p.bq, kc, kl, 32 * warps)
        if smem <= lut16.SMEM_PER_CTA:
            ctas = min(lut16.SMEM_PER_SM // (smem + 1024), 32 // warps)
            assert ctas * warps <= p.warps_per_sm


def test_stage_bytes():
    # word-aligned slots of code_stride words; else bytes rounded to 16
    # plus the 16 a funnel shift may read past the last row
    assert lut16.adc_stage_bytes(100, 896) == 896 * 25 * 4
    assert lut16.adc_stage_bytes(32, 64) == 64 * 9 * 4
    assert lut16.adc_stage_bytes(50, 512) == 512 * 50 + 16
    assert lut16.adc_stage_bytes(7, 32) == 224 + 16
    assert lut16.adc_stage_bytes(7, 96) == 672 + 16
    assert lut16.adc_stage_bytes(13, 32) == 416 + 16


def test_plan_refuses_what_cannot_fit():
    # a K whose whole LUT image fits no CTA is chunked, no longer refused
    # (tests/test_torch_lut16_wide_k.py); a LUT that does not match its
    # codes, and a query block without whole query groups, are refused
    assert lut16.plan_adc(1, 100, 4000, 4000, 132).chunk is not None
    with pytest.raises(ValueError, match="does not match"):
        lut16.plan_adc(1, 100, 4000, 3999, 132)
    with pytest.raises(ValueError, match="does not match"):
        lut16.plan_adc(1, 100, 50, 100, 132, packed=False)
    with pytest.raises(ValueError, match="no groups"):
        lut16.lut_image_index(2, 5, 4)
