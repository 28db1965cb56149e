"""Plain PyTorch versions of the three kernels.

Each computes what its CUDA kernel computes, on any device.  The wrappers in
``kernels/ops.py`` run them for CPU tensors; on the card they serve only as
the reference the kernels are held against.  ``PLAIN_CALLS`` counts their
calls, so a run can show that its main path did not take them.

``lut16_adc_plain`` adds the subspace terms in the kernels' order
(k = 0..K-1, starting from +0), so on the same inputs it matches K1 bit for
bit.
"""

from __future__ import annotations

import torch

from .lut16 import unpack_codes

__all__ = ["lut16_adc_plain", "lut16_adc_topk_plain", "block_sparse_plain",
           "stable_topk", "PLAIN_CALLS"]

PLAIN_CALLS = dict.fromkeys(
    ("lut16_adc", "lut16_adc_topk", "block_sparse_matmul"), 0)


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
