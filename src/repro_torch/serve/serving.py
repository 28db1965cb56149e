"""Batched serving session (counterpart of ``repro.serve.serving``): prefill
-> decode loop with either the exact full-vocab head or the PQ hybrid head
(the paper's technique).

Tracks per-sequence token counts so the hybrid head's sparse penalty term
(repetition penalty) exercises the paper's sparse + dense decomposition on a
real serving signal.

The reference casts each layer matrix to the compute dtype at its point of
use; casting once gives the same bits, so a session holds those leaves and
the exact head in ``cfg.dtype`` from ``create`` on (``F32_LEAVES`` names the
leaves it reads in f32, which stay f32).  The PQ head is built from the
caller's f32 ``lm_head`` before the cast.  A caller that hands its f32 tree
over (``donate=True``) has it cast in place, each f32 leaf released as its
copy takes its place, so that a session never holds two trees at once:
qwen2-moe-a2.7b's 57.3 GB f32 tree and its 28.7 GB of bf16 layers do not
fit one 80 GB card together.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import Model
from ..models.common import compute_dtype
from .hybrid_head import HybridLMHead

__all__ = ["ServeSession", "greedy_generate"]


# A layer's sub-dicts whose leaves the reference casts to the compute dtype
# where it uses them, each with the leaves it reads in f32 instead, which
# stay f32 here.  The norms (ln1, ln2, lnx, final_norm: ``rms_norm`` /
# ``layer_norm`` read the scale in f32) and the embedding table (gathered in
# f32, then cast) stay f32 whole; the exact head is cast.
F32_LEAVES = {
    "attn": (), "xattn": (), "mlp": (), "moe": (),
    # ssm.py: softplus(dt.astype(f32) + dt_bias); -exp(a_log) in f32, then
    # the cast; rms_norm(y, norm) reads norm in f32
    "ssd": ("dt_bias", "a_log", "norm"),
    # rglru.py: softplus(lam.astype(f32))
    "rec": ("lam",),
}


def _serving_params(params: dict, cfg, *, donate: bool = False) -> dict:
    """``params`` with every layer's leaves of ``F32_LEAVES``' sub-dicts,
    bar the leaves listed there, and the exact head in the compute dtype
    (bf16 for ``"bfloat16"``), over every pattern position and the tail.
    f32 configs get ``params`` back unchanged.  The casts go into a new
    tree of dicts and lists that shares the other leaves; with ``donate``,
    into ``params`` itself, a leaf at a time: each f32 leaf goes as its
    copy replaces it (unless the caller holds it elsewhere), so the peak
    is the f32 tree and one leaf's copy."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        return params
    tree = params if donate else _tree_copy(params)

    def cast(sub, keep=()):
        for k in list(sub):
            if k in keep:
                continue
            if isinstance(sub[k], dict):
                cast(sub[k])
            else:
                sub[k] = sub[k].to(dtype)

    for p in [*(p for block in tree["blocks"] for p in block),
              *tree["tail"]]:
        for k, sub in p.items():
            if k in F32_LEAVES:
                cast(sub, F32_LEAVES[k])
    tree["lm_head"] = tree["lm_head"].to(dtype)
    return tree


def _tree_copy(tree):
    """A params tree's dicts and lists, new; its leaves, shared."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v) for v in tree]
    return tree


@dataclasses.dataclass
class ServeSession:
    """One serving deployment: model + params + optional PQ hybrid head.

    ``head_buckets`` (DESIGN.md §5): when set, decode-time head calls pad
    the batch up to these static sizes, so sessions joining and leaving the
    batch meet at most ``len(head_buckets)`` head shapes."""
    model: Model
    params: dict
    max_len: int
    pq_head: HybridLMHead | None = None
    pq_params: object = None
    head_buckets: tuple[int, ...] | None = None

    @classmethod
    def create(cls, model: Model, params: dict, max_len: int,
               use_pq_head: bool | None = None, use_kernel: bool = False,
               head_backend: str | None = None,
               head_buckets: tuple[int, ...] | None = None,
               donate: bool = False):
        """head_backend: the engine backend of the PQ head's pass-1 scan
        (``ref``, ``onehot``, ``cuda``, ``cuda-packed``, or the reference's
        names); None resolves to ``cuda`` (``HybridLMHead``).  The head is
        built on the params' device.  head_buckets: static decode-batch
        buckets for the PQ head (None keeps the exact batch size).
        donate: the caller hands ``params`` over; it becomes the session's
        tree, cast in place after the PQ head is built from its f32
        ``lm_head`` (``_serving_params``), with the bits of a copy."""
        cfg = model.cfg
        use_pq = cfg.pq_head if use_pq_head is None else use_pq_head
        head = hp = None
        if use_pq:
            head = HybridLMHead(cfg, use_kernel=use_kernel,
                                backend=head_backend)
            hp = head.build(params["lm_head"],
                            device=params["lm_head"].device)
        return cls(model=model,
                   params=_serving_params(params, cfg, donate=donate),
                   max_len=max_len, pq_head=head, pq_params=hp,
                   head_buckets=head_buckets)

    def prefill(self, batch):
        """Prefill of a prompt batch into a decode state of ``max_len``."""
        return self.model.prefill(self.params, batch, self.max_len)

    def next_token(self, logits_or_hidden, counts, *, penalty: float = 0.0):
        """Greedy next token, (B,) int64, from logits (exact head) or hidden
        states (PQ head), with the sparse repetition-penalty term."""
        if self.pq_head is not None:
            # h = 1 needs a deep overfetch (paper Prop. 4: recall tracks the
            # (h, alpha*h) gap; top-1 margins are the tightest)
            if self.head_buckets is not None:
                _, ids = self.pq_head.approx_topk_bucketed(
                    self.pq_params, logits_or_hidden, counts, 1, 128,
                    penalty, buckets=self.head_buckets)
            else:
                _, ids = self.pq_head.approx_topk(
                    self.pq_params, logits_or_hidden, counts, 1, 128, penalty)
            return ids[:, 0].long()
        logits = logits_or_hidden
        if penalty != 0.0 and counts is not None:
            logits = logits - penalty * counts
        return torch.argmax(logits, dim=-1)


def greedy_generate(model: Model, params: dict, prompt_tokens, num_steps: int,
                    max_len: int, *, use_pq_head: bool = False,
                    penalty: float = 0.0, cond=None, donate: bool = False):
    """Greedy decode ``num_steps`` tokens after a prompt.  Returns (B, T)
    int32 ids on the params' device.  ``donate``: the caller hands
    ``params`` over, and its session is cast from it in place
    (``ServeSession.create``); the tokens are the same.

    With use_pq_head, the final hidden state feeds the paper's PQ + residual
    head instead of the full-vocab product; outputs agree except where the
    top-1 margin is below the PQ error.  ``cond`` (B, Tc, D): the
    conditioning embeddings of the vlm and audio families' cross-attention
    layers."""
    sess = ServeSession.create(model, params, max_len, use_pq_head,
                               donate=donate)
    dev = sess.params["lm_head"].device
    prompt = torch.as_tensor(prompt_tokens, device=dev).long()
    b = prompt.shape[0]
    batch = {"tokens": prompt}
    if cond is not None:
        batch["cond"] = cond
    logits, state = sess.prefill(batch)
    counts = torch.zeros((b, model.cfg.vocab_size), device=dev)
    _bump(counts, prompt)

    out = []
    if use_pq_head:
        # re-derive the hidden state of the prompt's last position
        tok = sess.next_token(_last_hidden(model, sess.params, batch), counts,
                              penalty=penalty)
    else:
        tok = sess.next_token(logits, counts, penalty=penalty)
    out.append(tok)
    _bump(counts, tok[:, None])
    for _ in range(num_steps - 1):
        y, state = model.decode_step(sess.params, state, tok, use_pq_head)
        tok = sess.next_token(y, counts, penalty=penalty)
        out.append(tok)
        _bump(counts, tok[:, None])
    return torch.stack(out, dim=1).to(torch.int32)


def _bump(counts: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """counts[b, tokens[b, j]] += 1 for every j, in place; duplicates add,
    as the reference's ``.at[].add`` does."""
    bidx = torch.arange(counts.shape[0], device=counts.device)[:, None]
    return counts.index_put_((bidx.expand_as(tokens), tokens.long()),
                             torch.ones(tokens.shape, device=counts.device),
                             accumulate=True)


def _last_hidden(model: Model, params: dict, batch) -> torch.Tensor:
    hidden, _ = model.forward(params, batch, return_hidden=True)
    return hidden[:, -1].float()
