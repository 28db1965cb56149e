"""Launchers of the fixed-order kernels in ``csrc/residual.cu``: R0 (the ADC
lookup table), R1 (pass 2's int8 dense residual), R2 (pass 3's sparse
residual) and R3 (a dot with gathered f32 rows, the PQ LM head's exact
columns).

They replace no Pallas kernel: the JAX package computes these steps with
plain jnp.  Each output is summed in an order that depends only on the
length of its reduction, so a query's scores do not depend on the batch it
is searched in; the CUDA source states the order, and
``kernels/ref.py``'s plain versions replay it bit for bit.  The wrappers
that check their inputs and count launches are in ``kernels/ops.py``;
these functions take tensors that the wrappers have checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["adc_lut_cuda", "dense_residual_cuda", "gathered_dot_cuda",
           "sparse_residual_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "adc_lut_launch": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "dense_residual_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _P],
                              _I),
    "gathered_dot_launch": ([_P, _P, _P, _P, _I, _I, _L, _I, _I, _P], _I),
    "sparse_residual_launch": ([_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P],
                               _I),
    "residual_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    return _build.load("residual", _SIGNATURES)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {code} "
            f"({_lib().residual_error_string(code).decode()})")


def adc_lut_cuda(q: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """R0: q (Q, K * p) f32, centers (K, l, p) f32 -> (Q, K, l) f32."""
    k, l, p = centers.shape
    nq = q.shape[0]
    out = torch.empty((nq, k, l), dtype=torch.float32, device=q.device)
    _raise_on(_lib().adc_lut_launch(q.data_ptr(), centers.data_ptr(),
                                    out.data_ptr(), nq, k, l, p, _stream(q)),
              "adc_lut")
    return out


def dense_residual_cuda(rows: torch.Tensor, scale: torch.Tensor,
                        zero: torch.Tensor, cand: torch.Tensor,
                        q: torch.Tensor) -> torch.Tensor:
    """R1: rows (N, d) int8, scale / zero (d,) f32, cand (Q, C) int32, q
    (Q, d) f32 -> (Q, C) f32."""
    nq, c = cand.shape
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    _raise_on(_lib().dense_residual_launch(
        rows.data_ptr(), cand.data_ptr(), q.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), out.data_ptr(), nq, c, rows.shape[0], rows.shape[1],
        _stream(q)), "dense_residual")
    return out


def gathered_dot_cuda(rows: torch.Tensor, cand: torch.Tensor,
                      q: torch.Tensor, bf16_rows: bool) -> torch.Tensor:
    """R3: rows (N, d) f32, cand (Q, C) int32, q (Q, d) f32 -> (Q, C) f32;
    ``bf16_rows`` rounds each gathered element to bf16 first."""
    nq, c = cand.shape
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    _raise_on(_lib().gathered_dot_launch(
        rows.data_ptr(), cand.data_ptr(), q.data_ptr(), out.data_ptr(), nq, c,
        rows.shape[0], rows.shape[1], int(bf16_rows), _stream(q)),
        "gathered_dot")
    return out


def sparse_residual_cuda(cols: torch.Tensor, vals: torch.Tensor,
                         cand: torch.Tensor,
                         q_cols: torch.Tensor) -> torch.Tensor:
    """R2: cols (N, R) int32, vals (N, R) f32, cand (Q, C) int32, q_cols
    (Q, d_active + 1) f32 -> (Q, C) f32."""
    nq, c = cand.shape
    out = torch.empty((nq, c), dtype=torch.float32, device=q_cols.device)
    _raise_on(_lib().sparse_residual_launch(
        cols.data_ptr(), vals.data_ptr(), cand.data_ptr(), q_cols.data_ptr(),
        out.data_ptr(), nq, c, cols.shape[0], cols.shape[1], q_cols.shape[1],
        _stream(q_cols)), "sparse_residual")
    return out
