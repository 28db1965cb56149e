"""Plain PyTorch versions of the kernels.

Each computes what its CUDA kernel computes, on any device.  The wrappers in
``kernels/ops.py`` run them for CPU tensors; on the card they serve only as
the reference the kernels are held against.  ``PLAIN_CALLS`` counts their
calls, so a run can show that its main path did not take them; ``bump``
adds to either count table under one lock, since the cluster tier's
servers search from one thread per connection.

``lut16_adc_plain`` adds the subspace terms in the kernels' order
(k = 0..K-1, starting from +0), so on the same inputs it matches K1 bit for
bit.  ``inverted_value_forward_plain`` takes each (query, row) sum in
stream order from +0, as the stream B4 does, so it matches that kernel (and
the port's ``score_inverted``) bit for bit; ``score_inverted_plain`` is
``score_inverted`` itself, B4's plain version.  ``tf32_split`` is K3's
operand split, done on the f32 bits as ``cvt.rna.tf32.f32`` does it.

``adc_lut_plain``, ``dense_residual_plain``, ``sparse_residual_plain`` and
``gathered_dot_plain`` (R0-R3, ``csrc/residual.cu``) replay those kernels'
fixed order with tensor ops (``fixed_order_sum``): a warp's lane j adds the
terms j, j + 32, ... in turn from +0, then a xor butterfly; R0 adds its p
terms in turn.  Each product and add is a tensor op of its own, so they
match the kernels bit for bit, and no reduction's order depends on Q or C.

``lut16_adc_ref``, ``block_sparse_ref`` and ``bcsr_to_dense_ref`` carry the
JAX package's oracle names and signatures (``repro/kernels/ref.py``), as
adapters over the same arithmetic; they count no plain-version call.
"""

from __future__ import annotations

import threading

import torch

from .lut16 import unpack_codes

__all__ = ["lut16_adc_plain", "lut16_adc_topk_plain", "block_sparse_plain",
           "inverted_value_forward_plain", "score_inverted_plain",
           "stable_topk", "tf32_split", "fixed_order_sum", "adc_lut_plain",
           "dense_residual_plain", "sparse_residual_plain",
           "gathered_dot_plain", "lut16_adc_ref", "block_sparse_ref",
           "bcsr_to_dense_ref", "PLAIN_CALLS", "bump"]

PLAIN_CALLS = dict.fromkeys(
    ("lut16_adc", "lut16_adc_topk", "block_sparse_matmul",
     "inverted_value_forward", "score_inverted_vf", "adc_lut",
     "dense_residual", "sparse_residual", "gathered_dot"), 0)

_COUNT_LOCK = threading.Lock()


def bump(counts: dict, key: str) -> None:
    """Add one to ``counts[key]`` (a ``+=`` on a dict item is not atomic
    across threads)."""
    with _COUNT_LOCK:
        counts[key] += 1


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along dim 1, ties toward the lowest index (``lax.top_k``'s
    order): a stable descending sort.  Returns (values, int32 indices)."""
    s, i = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32)


def _scan(codes: torch.Tensor, lut: torch.Tensor, packed: bool) -> torch.Tensor:
    if packed:
        codes = unpack_codes(codes, 2 * codes.shape[1])
    idx = codes.long()
    out = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for k in range(lut.shape[1]):
        out += lut[:, k, :][:, idx[:, k]]
    return out


def lut16_adc_plain(codes: torch.Tensor, lut: torch.Tensor, *,
                    packed: bool = False) -> torch.Tensor:
    """out[q, n] = sum_k lut[q, k, codes[n, k]]: codes (N, Kc) uint8, lut
    (Q, kl, l) f32 with kl == Kc, or kl == 2*Kc for packed codes (odd K
    carries its zero phantom column).  Returns (Q, N) f32."""
    bump(PLAIN_CALLS, "lut16_adc")
    return _scan(codes, lut, packed)


def lut16_adc_topk_plain(codes: torch.Tensor, lut: torch.Tensor,
                         base: torch.Tensor | None, k: int, *,
                         packed: bool = False):
    """Top-k of ``base + scan``: materialise the (Q, N) scores, then a
    stable descending sort.  Returns (Q, k) f32 scores and int32 ids."""
    bump(PLAIN_CALLS, "lut16_adc_topk")
    dense = _scan(codes, lut, packed)
    return stable_topk(dense if base is None else base + dense, k)


def block_sparse_plain(q: torch.Tensor, tiles: torch.Tensor, ptr: torch.Tensor,
                       col: torch.Tensor) -> torch.Tensor:
    """q (Q, D_pad) @ BCSR (tiles (T, br, bc), ptr (NB+1,), col (T,))^T ->
    (Q, NB * br).  A row block without tiles scores zero."""
    bump(PLAIN_CALLS, "block_sparse_matmul")
    nq = q.shape[0]
    _, br, bc = tiles.shape
    nb = ptr.shape[0] - 1
    ptr64 = ptr.long()
    out = torch.zeros((nq, nb, br), dtype=torch.float32, device=q.device)
    t_real = int(ptr64[-1])
    if t_real:
        row_block = torch.repeat_interleave(
            torch.arange(nb, device=q.device), ptr64[1:] - ptr64[:-1])
        cols = col[:t_real].long()
        qb = q.float().reshape(nq, -1, bc)
        # one column block at a time: its tiles sit in distinct row blocks,
        # so each update writes every output element at most once
        for j in torch.unique(cols).tolist():
            sel = torch.nonzero(cols == j)[:, 0]
            out[:, row_block[sel], :] += torch.einsum(
                "qc,trc->qtr", qb[:, j, :], tiles[sel].float())
    return out.reshape(nq, nb * br)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero: add half of the 13 dropped bits' weight to the magnitude and clear
    them.  The sign bit sits apart, so adding to the bit pattern rounds the
    magnitude whatever the sign."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's 3xTF32 operand split: ``hi = rna(x)``, ``lo = rna(x - hi)``,
    both TF32 values held in f32, with ``|x - hi - lo| <= 2^-22 |x|``."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def inverted_value_forward_plain(ptr: torch.Tensor, rows: torch.Tensor,
                                 qidx: torch.Tensor, contrib: torch.Tensor, *,
                                 bq: int, bn: int, chunk: int,
                                 num_row_blocks: int) -> torch.Tensor:
    """Accumulate a value-forward stream (``build_value_forward_stream``)
    into (QB * bq, num_row_blocks * bn) f32 scores.

    ptr (QB*(NB+1),) int32 chunk offsets; rows/qidx/contrib (QB, P_pad):
    block-local row ids (pad = bn), query index within the block, and the
    contributions.  Each (query, row) sum is taken in stream order from +0:
    the entries are scattered by their rank inside their (query, row)
    group, one rank per scatter, so no scatter meets a target twice and no
    atomic order can change a bit."""
    bump(PLAIN_CALLS, "inverted_value_forward")
    qb, p_pad = rows.shape
    nb = num_row_blocks
    dev = rows.device
    width = nb * bn
    out = torch.zeros(qb * bq * width, dtype=torch.float32, device=dev)
    seg = ptr.long().reshape(qb, nb + 1) * chunk                # entry offsets
    pos = torch.arange(p_pad, device=dev)
    # row block of each stream position; valid inside [seg[0], seg[nb])
    j = torch.searchsorted(seg.contiguous(),
                           pos.expand(qb, p_pad).contiguous(), right=True) - 1
    r = rows.long()
    valid = (pos[None] < seg[:, nb:]) & (r < bn) & (j >= 0)
    b = torch.arange(qb, device=dev)[:, None].expand(qb, p_pad)
    key = ((b * bq + qidx.long()) * width + j.clamp(0, nb - 1) * bn
           + r.clamp(0, bn - 1))[valid]
    val = contrib.float()[valid]
    if key.numel() == 0:
        return out.reshape(qb * bq, width)
    # rank of each entry among the entries of its key, in stream order
    sk, order = torch.sort(key, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(first, torch.arange(sk.numel(),
                                                         device=dev), 0),
                         dim=0).values
    rank = torch.empty_like(order)
    rank[order] = torch.arange(sk.numel(), device=dev) - start
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        out.scatter_add_(0, key[sel], val[sel])
    return out.reshape(qb * bq, width)


def score_inverted_plain(index, q_dims: torch.Tensor,
                         q_vals: torch.Tensor) -> torch.Tensor:
    """B4's plain version: ``core.sparse_index.score_inverted`` itself, one
    scatter-add per query slot into zeros, so each (query, row) sum is
    taken in (slot, list position) order from +0, the order B4 keeps."""
    from ..core.sparse_index import score_inverted
    bump(PLAIN_CALLS, "score_inverted_vf")
    return score_inverted(index, q_dims, q_vals)


def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in R1-R3's order: term i goes to lane
    i % 32, each lane adds its terms in turn from +0 (the tail padded with
    +0, which changes no bit of a sum that starts at +0), then the lanes
    meet pairwise, lane j with lane j + h for h = 16, 8, 4, 2, 1."""
    length = x.shape[-1]
    steps = -(-length // 32)
    if steps * 32 != length:
        x = torch.nn.functional.pad(x, (0, steps * 32 - length))
    x = x.reshape(*x.shape[:-1], steps, 32)
    acc = torch.zeros(x.shape[:-2] + (32,), dtype=x.dtype, device=x.device)
    for t in range(steps):
        acc = acc + x[..., t, :]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _clip(cand: torch.Tensor, n: int) -> torch.Tensor:
    return cand.long().clamp(0, n - 1)


def adc_lut_plain(q: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """R0's plain version: q (Q, K * p) f32, centers (K, l, p) f32 ->
    (Q, K, l), each entry's p products added in turn from +0."""
    bump(PLAIN_CALLS, "adc_lut")
    k, l, p = centers.shape
    qs = q.reshape(q.shape[0], k, p)
    acc = torch.zeros((q.shape[0], k, l), dtype=torch.float32,
                      device=q.device)
    for j in range(p):
        acc = acc + qs[:, :, None, j] * centers[None, :, :, j]
    return acc


def dense_residual_plain(rows: torch.Tensor, scale: torch.Tensor,
                         zero: torch.Tensor, cand: torch.Tensor,
                         q: torch.Tensor) -> torch.Tensor:
    """R1's plain version: (q * scale) . rows[cand] + 128 * sum(q * scale)
    + q . zero, the three sums in the fixed order; rows (N, d) int8, cand
    (Q, C) clipped into [0, N), q (Q, d) f32 -> (Q, C)."""
    bump(PLAIN_CALLS, "dense_residual")
    qs = q * scale[None, :]
    base = 128.0 * fixed_order_sum(qs) + fixed_order_sum(q * zero[None, :])
    r = rows[_clip(cand, rows.shape[0])].float()                  # (Q, C, d)
    return fixed_order_sum(qs[:, None, :] * r) + base[:, None]


def gathered_dot_plain(rows: torch.Tensor, cand: torch.Tensor,
                       q: torch.Tensor, bf16_rows: bool) -> torch.Tensor:
    """R3's plain version: q . rows[cand] in the fixed order; rows (N, d)
    f32 (each element rounded to bf16 first when ``bf16_rows``), cand
    (Q, C) clipped into [0, N), q (Q, d) f32 -> (Q, C)."""
    bump(PLAIN_CALLS, "gathered_dot")
    r = rows[_clip(cand, rows.shape[0])].float()                  # (Q, C, d)
    if bf16_rows:
        r = r.to(torch.bfloat16).float()
    return fixed_order_sum(q[:, None, :] * r)


def sparse_residual_plain(cols: torch.Tensor, vals: torch.Tensor,
                          cand: torch.Tensor,
                          q_cols: torch.Tensor) -> torch.Tensor:
    """R2's plain version: sum_r vals[cand, r] * q_cols[q, cols[cand, r]] in
    the fixed order; cand clipped into [0, N), column ids into
    [0, d_active], q_cols (Q, d_active + 1) -> (Q, C)."""
    bump(PLAIN_CALLS, "sparse_residual")
    c = _clip(cand, cols.shape[0])
    qn, nc = c.shape
    cc = cols[c].long().clamp(0, q_cols.shape[1] - 1)             # (Q, C, R)
    qv = torch.gather(q_cols, 1, cc.reshape(qn, -1)).reshape(cc.shape)
    return fixed_order_sum(vals[c] * qv)


def lut16_adc_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """out[q, n] = sum_k lut[q, k, codes[n, k]] (the JAX package's oracle
    name): codes (N, K) integer, lut (Q, K, l) -> (Q, N) f32, summed in
    subspace order as ``lut16_adc_plain``."""
    return _scan(codes, lut.float(), False)


def block_sparse_ref(q: torch.Tensor, x_head: torch.Tensor) -> torch.Tensor:
    """out = q @ x_head^T: (Q, D) x (N, D) -> (Q, N) f32 (the JAX package's
    oracle name)."""
    return q.float() @ x_head.float().T


def bcsr_to_dense_ref(tiles, tile_ptr, tile_col, d: int) -> torch.Tensor:
    """Reassemble the dense (N, D) head matrix from BCSR tiles (the JAX
    package's host helper): a tensor on the tiles' device."""
    tiles = torch.as_tensor(tiles)
    ptr = torch.as_tensor(tile_ptr).tolist()
    col = torch.as_tensor(tile_col).tolist()
    _, br, bc = tiles.shape
    out = torch.zeros(((len(ptr) - 1) * br, d), dtype=tiles.dtype,
                      device=tiles.device)
    for i in range(len(ptr) - 1):
        for t in range(ptr[i], ptr[i + 1]):
            j = col[t]
            out[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = tiles[t]
    return out
