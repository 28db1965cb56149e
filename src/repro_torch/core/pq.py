"""Product quantization for the dense component (paper §2.3, §4.1, §6).

Counterpart of ``repro.core.pq``.  Two indices are built (paper §6):
  * data index   — K_U = d^D/2 subspaces, l = 16 codewords (4 bits / 2 dims),
                   scanned with the LUT16 kernels (kernels/lut16.py);
  * residual idx — K_V = d^D  subspaces, l = 256 ⇒ per-dimension scalar
                   quantization of the residual at 8 bits (§6.1.1).

k-means runs on the tensors' device.  Its random draws come from a
``torch.Generator`` seeded from ``seed``; they cannot reproduce the JAX
package's ``jax.random.choice`` draws, so the two packages train different
(equally valid) codebooks from the same data.  Given the same codebooks,
encoding, decoding and quantization match.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import to_numpy
from ..kernels import ops
from ..kernels.lut16 import pack_codes, unpack_codes

__all__ = [
    "PQCodebooks", "train_codebooks", "pq_encode", "pq_decode", "adc_lut",
    "adc_scores_ref", "ScalarQuant", "scalar_quantize", "scalar_dequantize",
    "scalar_quantize_rows", "encode_rows", "pack_codes", "unpack_codes",
    "whitening_transform",
]

# Largest (subspaces or rows, ..., l) f32 block that k-means and encoding
# build at once: 1 GiB.  A (K, N, 16) distance block at K = 4096 over
# 65536 sampled rows is 17 GB, so both walk K (or rows) in pieces.
BLOCK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class PQCodebooks:
    """K subspace codebooks, all subspaces the same width p = d^D / K.

    centers: (K, l, p) float32.
    """
    centers: torch.Tensor

    @property
    def num_subspaces(self) -> int:
        return self.centers.shape[0]

    @property
    def num_codes(self) -> int:
        return self.centers.shape[1]


def _split_subspaces(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, d) -> (N, K, p): contiguous subvector blocks (paper Eq. 2)."""
    n, d = x.shape
    if d % k:
        raise ValueError(f"d={d} not divisible by K={k}")
    return x.reshape(n, k, d // k)


def _lloyd(subs: torch.Tensor, centers: torch.Tensor,
           iters: int) -> torch.Tensor:
    """``iters`` Lloyd steps of independent k-means, one per subspace:
    subs (K, N, p), centers (K, l, p).  An empty cluster keeps its center."""
    k, n, _ = subs.shape
    l = centers.shape[1]
    for _ in range(iters):
        # (K, N, l) squared distances via ||c||^2 - 2 x.c; x-term constant
        d2 = ((centers * centers).sum(-1)[:, None, :]
              - 2.0 * torch.bmm(subs, centers.transpose(1, 2)))
        assign = d2.argmin(-1)                                    # (K, N)
        one_hot = torch.zeros((k, n, l), dtype=subs.dtype, device=subs.device)
        one_hot.scatter_(2, assign[:, :, None], 1.0)
        counts = one_hot.sum(1)                                   # (K, l)
        sums = torch.bmm(one_hot.transpose(1, 2), subs)           # (K, l, p)
        new = sums / counts.clamp_min(1.0)[:, :, None]
        centers = torch.where((counts > 0)[:, :, None], new, centers)
    return centers


def train_codebooks(x_dense: torch.Tensor, num_subspaces: int,
                    num_codes: int = 16, iters: int = 12, seed: int = 0,
                    sample: int | None = 65536) -> PQCodebooks:
    """Learn K codebooks by independent per-subspace Lloyd's k-means (paper
    §2.3), as many subspaces at once as keep the (subspaces, N, l) f32
    distance block within ``BLOCK_BYTES``.  Init: ``num_codes`` distinct
    random points per subspace (at most ``sample`` rows are used), all
    drawn first in subspace order, deterministic under ``seed``; an empty
    cluster keeps its old center.  The subspaces are independent, so the
    pieces change no draw."""
    x = x_dense.float()
    gen = torch.Generator().manual_seed(seed)
    if sample is not None and x.shape[0] > sample:
        sel = torch.randperm(x.shape[0], generator=gen)[:sample]
        x = x[sel.to(x.device)]
    subs = _split_subspaces(x, num_subspaces).transpose(0, 1).contiguous()
    k, n, p = subs.shape                                          # (K, N, p)
    l = num_codes
    init = torch.stack([torch.randperm(n, generator=gen)[:l]
                        for _ in range(k)]).to(x.device)          # (K, l)
    centers = torch.gather(subs, 1, init[:, :, None].expand(k, l, p))
    step = max(1, BLOCK_BYTES // (n * l * 4))
    centers = torch.cat([_lloyd(subs[s:s + step], centers[s:s + step], iters)
                         for s in range(0, k, step)])
    return PQCodebooks(centers=centers.contiguous())


def pq_encode(x_dense: torch.Tensor, codebooks: PQCodebooks,
              chunk: int = 65536) -> torch.Tensor:
    """phi_PQ: (N, d) -> (N, K) uint8 codes (argmin L2 per subspace),
    ``chunk`` rows at a time, fewer where the (rows, K, l) distance block
    would pass ``BLOCK_BYTES``."""
    c = codebooks.centers                                         # (K, l, p)
    cc = torch.sum(c * c, dim=2)[None]                            # (1, K, l)
    x = x_dense.float()
    chunk = max(1, min(chunk, BLOCK_BYTES // (c.shape[0] * c.shape[1] * 4)))
    out = torch.empty((x.shape[0], c.shape[0]), dtype=torch.uint8,
                      device=x.device)
    for s in range(0, x.shape[0], chunk):
        subs = _split_subspaces(x[s:s + chunk], c.shape[0])
        d2 = cc - 2.0 * torch.einsum("nkp,klp->nkl", subs, c)
        out[s:s + chunk] = torch.argmin(d2, dim=2).to(torch.uint8)
    return out


def pq_decode(codes: torch.Tensor, codebooks: PQCodebooks) -> torch.Tensor:
    """Reconstruct (N, d) from (N, K) codes."""
    c = codebooks.centers
    k, _, p = c.shape
    kidx = torch.arange(k, device=codes.device)[None, :]
    return c[kidx, codes.long()].reshape(codes.shape[0], k * p)


def adc_lut(q_dense: torch.Tensor, codebooks: PQCodebooks, *,
            fixed_order: bool = False) -> torch.Tensor:
    """Asymmetric LUT (paper §4.1.1): T[q][k][c] = q^(k) · U^(k)_c.

    q_dense: (Q, d) or (d,).  Returns (Q, K, l) (or (K, l)) float32.
    fixed_order=True (the kernel backends) takes ``ops.adc_lut`` (R0 on
    the card), whose entries do not depend on Q; otherwise the JAX
    package's einsum."""
    c = codebooks.centers
    single = q_dense.ndim == 1
    q = torch.atleast_2d(q_dense.float())
    if fixed_order:
        lut = ops.adc_lut(q, c)
    else:
        lut = torch.einsum("qkp,klp->qkl", _split_subspaces(q, c.shape[0]),
                           c)
    return lut[0] if single else lut


def adc_scores_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Reference ADC scan: (N, K) codes × (Q, K, l) LUT -> (Q, N) scores,
    as a gather of (Q, N, K) terms and a sum."""
    single = lut.ndim == 2
    lut3 = lut[None] if single else lut
    kidx = torch.arange(lut3.shape[1], device=codes.device)[None, :]
    out = lut3[:, kidx, codes.long()].sum(-1)                     # (Q, N)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Scalar quantization — the dense residual index (K_V = d^D, l = 256, §6.1.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScalarQuant:
    """Per-dimension affine int8 quantization: x ≈ scale * (q + 128) + zero."""
    q: torch.Tensor          # (N, d) int8
    scale: torch.Tensor      # (d,) float32
    zero: torch.Tensor       # (d,) float32


def scalar_quantize(x: torch.Tensor) -> ScalarQuant:
    """Round half to even, as ``jnp.round`` (``torch.round`` does too).

    The scale is the range times f32(1/255): XLA compiles the JAX
    package's division by the constant 255 into that multiplication, and
    the same bits keep the two packages' int8 residuals equal."""
    x = x.float()
    lo = x.min(dim=0).values
    hi = x.max(dim=0).values
    scale = torch.clamp_min(hi - lo, 1e-12) * torch.tensor(
        1.0 / 255.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round((x - lo) / scale), 0, 255) - 128
    return ScalarQuant(q=q.to(torch.int8), scale=scale, zero=lo)


def scalar_dequantize(sq: ScalarQuant) -> torch.Tensor:
    return (sq.q.float() + 128.0) * sq.scale + sq.zero


def scalar_quantize_rows(x: np.ndarray, scale, zero) -> np.ndarray:
    """Quantize NEW rows on a FROZEN grid (the delta shard's insert path):
    the main generation's ``scale``/``zero`` (tensors or arrays) stay, and
    the rows are clamped into them.  Host numpy, rounding half to even as
    ``np.round`` does — the JAX package's arithmetic.  (M, d) -> int8."""
    x = np.asarray(x, np.float32)
    scale = np.asarray(to_numpy(scale), np.float32)
    zero = np.asarray(to_numpy(zero), np.float32)
    q = np.clip(np.round((x - zero) / scale), 0, 255) - 128
    return q.astype(np.int8)


def encode_rows(x_dense: np.ndarray, codebooks: PQCodebooks, *,
                pack: bool = False) -> np.ndarray:
    """Encode-on-insert: PQ-encode NEW dense rows against the FROZEN
    codebooks, through ``pq_encode`` on the codebooks' device.  pack=True
    returns them two codes per byte (``pack_codes``, odd-K phantom nibble
    included).  (M, d) -> (M, K) uint8, or (M, ceil(K/2)) packed; numpy."""
    x = torch.from_numpy(np.asarray(x_dense, np.float32)).to(
        codebooks.centers.device)
    codes = pq_encode(x, codebooks).cpu().numpy()
    return pack_codes(codes) if pack else codes


def whitening_transform(x_dense, eps: float = 1e-4, *, device="cuda"):
    """P = Cov^{-1/2}(X^D) (paper §4.1.3), computed on the host in float64.
    Returns (P, P^{-T}) as float32 tensors on ``device``: data is
    multiplied by P and queries by (P^{-1})^T, preserving inner products."""
    x = np.asarray(to_numpy(x_dense), np.float64)
    cov = np.cov(x, rowvar=False) + eps * np.eye(x.shape[1])
    evals, evecs = np.linalg.eigh(cov)
    p = evecs @ np.diag(evals ** -0.5) @ evecs.T
    p_inv_t = evecs @ np.diag(evals ** 0.5) @ evecs.T            # symmetric
    return (torch.from_numpy(p.astype(np.float32)).to(device),
            torch.from_numpy(p_inv_t.astype(np.float32)).to(device))
