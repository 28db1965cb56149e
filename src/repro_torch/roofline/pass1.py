"""Pass-1 byte model for the LUT16 scan (counterpart of
``repro.roofline.pass1``; paper §4.1.2's single-stream bound).

The fused scan-and-select changes pass 1's byte equation: the materialize
path writes AND re-reads the (Q, N) f32 score matrix on its way to top-k,
while the fused path's memory traffic is just the code stream (halved again
by 4-bit packing), the per-query LUTs, and the (Q, cbuf) candidate buffers.
``predicted_pass1_bytes`` is that analytic model, integer arithmetic with no
dependence on the hardware.  ``measured_bytes`` is the counted side: the
eager call's op-by-op bytes (``roofline.analysis.cost_of``), where the
reference reads XLA's ``cost_analysis()`` of the jitted function.
"""

from __future__ import annotations

__all__ = ["predicted_pass1_bytes", "measured_bytes"]


def predicted_pass1_bytes(*, q: int, n: int, k_codes: int, l: int = 16,
                          packed: bool = False, fused: bool = True,
                          cbuf: int | None = None) -> int:
    """Analytic memory bytes for one pass-1 dispatch of the dense ADC scan.

    q queries, n rows, k_codes PQ subspaces (the STORED code width: pass
    ceil(K/2) when packed), l codewords; cbuf the candidate-buffer width
    (defaults to 128, the floor of the candidate buffer's width).

    materialize (fused=False) adds the (q, n) f32 score matrix twice, once
    written by the scan kernel and once re-read by top-k."""
    if cbuf is None:
        cbuf = 128
    codes = n * k_codes                       # uint8 stream (already halved
    lut = q * k_codes * l * 4                 # when packed: k_codes=ceil(K/2))
    lut *= 2 if packed else 1                 # packed LUT pairs nibble halves
    out = q * cbuf * (4 + 4)                  # f32 scores + i32 ids
    total = codes + lut + out
    if not fused:
        total += 2 * q * n * 4                # write + re-read (Q, N) scores
    return int(total)


def measured_bytes(fn, *args) -> float | None:
    """The bytes ``roofline.analysis.cost_of`` counts for ``fn(*args)``:
    every data-moving op's tensor inputs and outputs.  None when the call
    moves no tensor bytes (as the reference returns None when the cost
    model has no "bytes accessed" key).  A custom kernel's launch is not an
    aten op and is not counted: count its plain version, on CPU or ``meta``
    tensors."""
    from .analysis import cost_of

    nbytes = cost_of(fn, *args)[1]
    return nbytes if nbytes else None
