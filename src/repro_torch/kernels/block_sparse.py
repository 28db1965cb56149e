"""Block-sparse scoring on Hopper: BCSR conversion and the launchers of K3
and B4.

K3 (``csrc/block_sparse.cu:block_sparse_kernel``) replaces
``repro/kernels/block_sparse.py:block_sparse_matmul_pallas``: ``q @ X^T``
over the nonzero 128 x 128 tiles of the cache-sorted head block, in BCSR
order, on the tensor cores as 3xTF32.  Zero tiles are never read.

B4 (``csrc/block_sparse.cu:inverted_value_forward_kernel``) replaces
``repro/kernels/block_sparse.py:inverted_value_forward_pallas``: it
accumulates a host-planned, row-sorted (row, query, contribution) stream
into (Q, N) sparse scores.

What bounds each and what its design does about it is noted in the CUDA
source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["dense_to_bcsr", "block_sparse_cuda",
           "inverted_value_forward_cuda", "TILE"]

TILE = 128          # tile rows and columns the CUDA kernel takes

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "block_sparse_matmul_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "inverted_value_forward_launch": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
    "block_sparse_matmul_smem_bytes": ([_I], _I),
    "block_sparse_error_string": ([_I], ctypes.c_char_p),
}


def dense_to_bcsr(x: np.ndarray, br: int, bc: int):
    """(N, D) -> (tiles (T,br,bc), tile_ptr (N/br+1,), tile_col (T,)).

    T == number of nonzero tiles == the object cache sorting minimizes.
    Numpy copy of the JAX package's converter."""
    n, d = x.shape
    assert n % br == 0 and d % bc == 0, (x.shape, br, bc)
    nb, db = n // br, d // bc
    view = x.reshape(nb, br, db, bc).transpose(0, 2, 1, 3)     # (nb, db, br, bc)
    nz = np.abs(view).max(axis=(2, 3)) > 0                     # (nb, db)
    tiles, cols, ptr = [], [], [0]
    for i in range(nb):
        for j in np.flatnonzero(nz[i]):
            tiles.append(view[i, j])
            cols.append(j)
        ptr.append(len(tiles))
    if not tiles:                                              # fully zero
        tiles = [np.zeros((br, bc), x.dtype)]
        cols = [0]
        ptr = [0] * (nb + 1)
    return (np.stack(tiles).astype(np.float32),
            np.asarray(ptr, np.int32), np.asarray(cols, np.int32))


def block_sparse_cuda(q: torch.Tensor, tiles: torch.Tensor, ptr: torch.Tensor,
                      col: torch.Tensor) -> torch.Tensor:
    """Launch K3: q (Q, D_pad) f32 -> (Q, N_pad) f32, N_pad = 128 * NB.
    The kernel copies q and the tiles 16 bytes at a time."""
    lib = _build.load("block_sparse", _SIGNATURES)
    nq, d_pad = q.shape
    nb = ptr.shape[0] - 1
    if q.data_ptr() % 16 or tiles.data_ptr() % 16:
        raise ValueError("K3 takes q and tiles at 16-byte aligned addresses")
    out = torch.empty((nq, nb * TILE), dtype=torch.float32, device=q.device)
    code = lib.block_sparse_matmul_launch(
        q.data_ptr(), tiles.data_ptr(), ptr.data_ptr(), col.data_ptr(),
        out.data_ptr(), nq, d_pad, nb,
        torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"block_sparse_matmul launch failed: CUDA error {code} "
            f"({lib.block_sparse_error_string(code).decode()})")
    return out


def _smem_bytes(nq: int) -> int:
    """Dynamic shared memory of one K3 CTA at ``nq`` queries, in bytes (a
    figure for ``chip_smoke.py``'s report)."""
    return _build.load("block_sparse",
                       _SIGNATURES).block_sparse_matmul_smem_bytes(nq)


def inverted_value_forward_cuda(ptr: torch.Tensor, rows: torch.Tensor,
                                qidx: torch.Tensor, contrib: torch.Tensor, *,
                                bq: int, bn: int, chunk: int,
                                num_row_blocks: int) -> torch.Tensor:
    """Launch B4: the stream (ptr, rows, qidx, contrib) ->
    (QB * bq, num_row_blocks * bn) f32."""
    lib = _build.load("block_sparse", _SIGNATURES)
    qb, p_pad = rows.shape
    out = torch.empty((qb * bq, num_row_blocks * bn), dtype=torch.float32,
                      device=rows.device)
    code = lib.inverted_value_forward_launch(
        ptr.data_ptr(), rows.data_ptr(), qidx.data_ptr(), contrib.data_ptr(),
        out.data_ptr(), qb, bq, bn, chunk, num_row_blocks, p_pad,
        torch.cuda.current_stream(rows.device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"inverted_value_forward launch failed: CUDA error {code} "
            f"({lib.block_sparse_error_string(code).decode()})")
    return out
