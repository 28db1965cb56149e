"""Plain PyTorch versions of the four kernels.

Each computes what its CUDA kernel computes, on any device.  The wrappers in
``kernels/ops.py`` run them for CPU tensors; on the card they serve only as
the reference the kernels are held against.  ``PLAIN_CALLS`` counts their
calls, so a run can show that its main path did not take them.

``lut16_adc_plain`` adds the subspace terms in the kernels' order
(k = 0..K-1, starting from +0), so on the same inputs it matches K1 bit for
bit.  ``inverted_value_forward_plain`` takes each (query, row) sum in
stream order from +0, as B4 does, so it matches B4 (and the port's
``score_inverted``) bit for bit.  ``tf32_split`` is K3's operand split,
done on the f32 bits as ``cvt.rna.tf32.f32`` does it.
"""

from __future__ import annotations

import torch

from .lut16 import unpack_codes

__all__ = ["lut16_adc_plain", "lut16_adc_topk_plain", "block_sparse_plain",
           "inverted_value_forward_plain", "stable_topk", "tf32_split",
           "PLAIN_CALLS"]

PLAIN_CALLS = dict.fromkeys(
    ("lut16_adc", "lut16_adc_topk", "block_sparse_matmul",
     "inverted_value_forward"), 0)


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
    PLAIN_CALLS["lut16_adc"] += 1
    return _scan(codes, lut, packed)


def lut16_adc_topk_plain(codes: torch.Tensor, lut: torch.Tensor,
                         base: torch.Tensor | None, k: int, *,
                         packed: bool = False):
    """Top-k of ``base + scan``: materialise the (Q, N) scores, then a
    stable descending sort.  Returns (Q, k) f32 scores and int32 ids."""
    PLAIN_CALLS["lut16_adc_topk"] += 1
    dense = _scan(codes, lut, packed)
    return stable_topk(dense if base is None else base + dense, k)


def block_sparse_plain(q: torch.Tensor, tiles: torch.Tensor, ptr: torch.Tensor,
                       col: torch.Tensor) -> torch.Tensor:
    """q (Q, D_pad) @ BCSR (tiles (T, br, bc), ptr (NB+1,), col (T,))^T ->
    (Q, NB * br).  A row block without tiles scores zero."""
    PLAIN_CALLS["block_sparse_matmul"] += 1
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
    PLAIN_CALLS["inverted_value_forward"] += 1
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
