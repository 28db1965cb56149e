"""PQ-approximated LM head (counterpart of ``repro.serve.hybrid_head``).

Next-token scoring over a 100k-256k vocabulary is a MIPS problem over the
output embedding table, the paper's "extreme classification" use:

  dense data index     PQ over the columns of lm_head (K = d/2, l = 16),
                       scanned by the engine's ADC (K1 on ``cuda``, packed
                       codes on ``cuda-packed``);
  sparse component     per-sequence token counts, a penalty subtracted from
                       the pass-1 and pass-3 scores;
  residual reorder     the top alpha*k candidates re-scored with the int8
                       residual (pass 2), then exact lm_head columns for the
                       survivors (pass 3).

Full-vocab logits are never formed on the approximate path: the head reads
V * K code bytes (half of it packed) and alpha*k*d residual bytes a query,
not the V * d * 4 of the f32 head.

The exact head is kept as its (V, d) transpose, so pass 3 gathers a
token's column as one contiguous row; ``HybridHeadParams.head`` is the
(d, V) view of it, the reference's layout, and the head's bytes are held
once.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F

from ..core import engine as eng
from ..core import residual as res
from ..core.engine import Backend
from ..core.pq import (PQCodebooks, ScalarQuant, adc_lut, pack_codes,
                       pq_decode, pq_encode, scalar_quantize, train_codebooks)
from ..device import full_f32, resolve_device
from ..kernels.ref import stable_topk
from .query_service import bucket_for

__all__ = ["HybridHeadParams", "HybridLMHead"]


@dataclasses.dataclass(frozen=True)
class HybridHeadParams:
    """Device-resident PQ head: codebooks + codes + residual + exact head."""
    codebooks: PQCodebooks
    codes: torch.Tensor         # (V, K) uint8; (V, ceil(K/2)) when packed
    residual: ScalarQuant       # int8 residual of the token vectors
    head: torch.Tensor          # (d, V) exact head (pass-3 rerank)
    codes_packed: bool = False
    # wall seconds of each build stage (empty for params carried across)
    build_seconds: dict = dataclasses.field(default_factory=dict,
                                            compare=False)


def _as(x, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


class HybridLMHead:
    """Build once per checkpoint; serve per decode step."""

    def __init__(self, cfg, use_kernel: bool = False,
                 backend: Backend | str | None = None):
        """cfg: read only for ``cfg.dtype`` ("bfloat16" runs pass 3 in
        bf16).  backend: the engine backend of the pass-1 scan (``ref``,
        ``onehot``, ``cuda``, ``cuda-packed``; the JAX package's names are
        aliases).  None resolves to ``cuda`` whatever ``use_kernel`` says:
        the port's entry points run their kernels unless asked otherwise,
        where the reference resolves None to ``ref`` unless use_kernel (the
        difference ROADMAP C1 records for stores).  ``use_kernel`` is kept
        for the reference's signature."""
        self.cfg = cfg
        self.backend = Backend.from_name(backend)

    def build(self, lm_head, *, subspaces: int | None = None, iters: int = 8,
              seed: int = 0, device="cuda") -> HybridHeadParams:
        """lm_head: (d, V) tensor or array, token vectors as columns.  Built
        on ``device`` (the card unless the caller asks for the CPU).  With
        the ``cuda-packed`` backend the codes are stored two per byte, so
        the pass-1 scan streams V * K / 2 bytes."""
        dev = resolve_device(device)
        seconds = {}
        t = time.perf_counter()

        def stage(name):
            nonlocal t
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            seconds[name] = now - t
            t = now

        table = _as(lm_head, dev, torch.float32).T.contiguous()      # (V, d)
        stage("transpose")
        k = subspaces or max(table.shape[1] // 2, 1)
        cb = train_codebooks(table, k, 16, iters=iters, seed=seed)
        stage("train")
        codes = pq_encode(table, cb)
        stage("encode")
        residual = scalar_quantize(table - pq_decode(codes, cb))
        stage("residual")
        packed = self.backend is Backend.CUDA_PACKED
        if packed:
            codes = torch.from_numpy(pack_codes(codes.cpu().numpy())).to(dev)
            stage("pack")
        return HybridHeadParams(codebooks=cb, codes=codes, residual=residual,
                                head=table.T, codes_packed=packed,
                                build_seconds=seconds)

    def _exact_columns(self, hp: HybridHeadParams, h: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
        """h (B, d) · head[:, ids] (B, C) in the model's compute dtype: in
        bf16 the operands are rounded to bf16 and the f32 product to bf16,
        as ``jnp.einsum`` on bf16 operands returns it, then widened."""
        cols = hp.head.T[ids.long()]                                  # (B, C, d)
        with full_f32():
            if self.cfg.dtype == "bfloat16":
                exact = torch.einsum("bd,bcd->bc",
                                     h.to(torch.bfloat16).float(),
                                     cols.to(torch.bfloat16).float())
                return exact.to(torch.bfloat16).float()
            return torch.einsum("bd,bcd->bc", h, cols)

    def approx_topk(self, hp: HybridHeadParams, hidden, token_counts,
                    k: int = 50, alpha: int = 8, penalty: float = 0.0):
        """hidden: (B, d) final hidden states; token_counts: (B, V) sparse
        per-sequence counts (may be None).  Returns (values (B, k) f32,
        ids (B, k) int32).

        Pass 1: engine ADC over the PQ codes (one K1 launch on the kernel
        backends), minus the count penalty; top c1 = min(alpha * k, V).
        Pass 2: + the int8 residual; keep min(max(2k, 16), c1).
        Pass 3: exact head columns, ranked by (score desc, vocab id asc),
        the full-vocab argmax's tie-break."""
        dev = hp.codes.device
        h = _as(hidden, dev, torch.float32)
        lut = adc_lut(h, hp.codebooks)                               # (B, K, 16)
        scores = eng.adc_scores(hp.codes, lut, self.backend,
                                packed=hp.codes_packed)              # (B, V)
        counts = None
        if token_counts is not None and penalty != 0.0:
            counts = _as(token_counts, dev)
            scores = scores - penalty * counts
        c1 = min(alpha * k, scores.shape[1])
        s1, ids1 = res.topk_candidates(scores, c1)
        corr = res.dense_residual_scores(hp.residual, ids1, h)
        _, ids2 = res.reorder_pass(s1, ids1, corr, min(max(2 * k, 16), c1))
        exact = self._exact_columns(hp, h, ids2)
        if counts is not None:
            exact = exact - penalty * torch.gather(counts, 1, ids2.long())
        # candidates in id order, then a stable sort by score: ties go to
        # the lowest vocabulary id
        by_id = torch.argsort(ids2, dim=1)
        ids_sorted = torch.gather(ids2, 1, by_id)
        vals, pos = torch.sort(torch.gather(exact, 1, by_id), dim=1,
                               descending=True, stable=True)
        return (vals[:, :k].contiguous(),
                torch.gather(ids_sorted, 1, pos[:, :k]))

    def approx_topk_bucketed(self, hp: HybridHeadParams, hidden,
                             token_counts, k: int = 50, alpha: int = 8,
                             penalty: float = 0.0,
                             buckets: tuple[int, ...] = (1, 8, 32)):
        """``approx_topk`` behind decode-batch bucketing: the batch is
        padded with zero hidden states up to the smallest bucket that holds
        it (``query_service.bucket_for``), on the device, and sliced back;
        batches above the largest bucket go in chunks of it.  So a serving
        loop whose sessions join and leave meets at most ``len(buckets)``
        shapes a (k, alpha, penalty), as the QueryService does."""
        dev = hp.codes.device
        bks = tuple(sorted(set(buckets)))
        hidden = _as(hidden, dev)
        tc = None if token_counts is None else _as(token_counts, dev)
        b = hidden.shape[0]
        if b > bks[-1]:
            cap = bks[-1]
            outs = [self.approx_topk_bucketed(
                hp, hidden[lo:lo + cap], None if tc is None else
                tc[lo:lo + cap], k, alpha, penalty, bks)
                for lo in range(0, b, cap)]
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))
        pad = bucket_for(b, bks) - b
        hid = F.pad(hidden, (0, 0, 0, pad))
        if tc is not None:
            tc = F.pad(tc, (0, 0, 0, pad))
        vals, ids = self.approx_topk(hp, hid, tc, k, alpha, penalty)
        return vals[:b], ids[:b]

    def exact_topk(self, hp: HybridHeadParams, hidden, token_counts,
                   k: int = 50, penalty: float = 0.0):
        """Oracle: the full-vocab f32 product (B, d) @ (d, V), TF32 off,
        then the top k, ties to the lowest id (``lax.top_k``'s order)."""
        dev = hp.head.device
        with full_f32():
            logits = _as(hidden, dev, torch.float32) @ hp.head
        if token_counts is not None and penalty != 0.0:
            logits = logits - penalty * _as(token_counts, dev)
        return stable_topk(logits, k)
