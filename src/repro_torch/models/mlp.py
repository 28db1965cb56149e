"""Feed-forward layers (counterpart of ``repro.models.mlp``): the gated MLP
(SwiGLU / GeGLU per ``cfg.act``) and the GShard capacity MoE.

MoE (qwen3-moe / qwen2-moe): top-k routing with per-sequence groups and a
fixed expert capacity C = ceil4(int(k * S / E * capacity_factor)), at least
4.  Dispatch is the reference's sort-free scatter / gather:

  router -> top-k expert ids (ties to the lowest expert, as ``lax.top_k``)
  -> each assignment's position within its expert by a stable sort -> the
  token indices scattered into (B, E, C + 1) slots (slot C is the sentinel
  every dropped assignment lands on, sliced away) -> one gather of the
  (B, E, C, D) buffer -> the batched expert products -> gather back,
  gate-weighted combine, sum over k.

Shared experts (qwen2-moe) run as a dense gated MLP on every token.  The
reference's ``moe_seq_combine`` / ``moe_shardmap_combine`` options and
``_shardmap_combine`` only place the combine's shards on a TPU mesh; on one
card they change no number and are not ported.
"""

from __future__ import annotations

import torch

from .common import activation, dense_init

__all__ = ["init_mlp", "mlp", "init_moe", "moe", "moe_route"]


def init_mlp(generator, cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(generator, (d, f)),
        "w_up": dense_init(generator, (d, f)),
        "w_down": dense_init(generator, (f, d)).div_(
            (2.0 * cfg.num_layers) ** 0.5),
    }


def mlp(x, p, cfg):
    dtype = x.dtype
    h = x @ p["w_gate"].to(dtype)
    u = x @ p["w_up"].to(dtype)
    return (activation(h, cfg.act) * u) @ p["w_down"].to(dtype)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def init_moe(generator, cfg) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(generator, (d, e)),
        "w_gate": dense_init(generator, (e, d, f)),
        "w_up": dense_init(generator, (e, d, f)),
        "w_down": dense_init(generator, (e, f, d)).div_(
            (2.0 * cfg.num_layers) ** 0.5),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = init_mlp(
            generator, cfg,
            d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts)
    return p


def _capacity(cfg, seq: int) -> int:
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    c = int(k * seq / e * cfg.capacity_factor)
    return max(-(-c // 4) * 4, 4)                 # round up to a lane multiple


def moe_route(x, p, cfg):
    """The router and each assignment's place: x (B, S, D) -> (probs
    (B, S, E) f32, gate values (B, S, k) f32 renormalised over the top k,
    expert ids (B, S * k), position within the expert (B, S * k), in_cap
    (B, S * k) bool, capacity C).  Assignment a is token a // k's (a % k)-th
    choice; its position counts the assignments to the same expert before it
    in that order (a stable sort, as ``jnp.argsort``)."""
    b, s, _ = x.shape
    k = cfg.num_experts_per_tok
    c = _capacity(cfg, s)
    logits = x @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    # lax.top_k: descending, ties toward the lowest expert
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :k], expert_ids[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = expert_ids.reshape(b, s * k)
    a = s * k
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    idx = torch.arange(a, device=x.device).expand(b, a)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    pos = torch.empty_like(idx).scatter_(1, order, idx - run_start)
    return probs, gate_vals, flat_e, pos, pos < c, c


def moe(x, p, cfg):
    """x (B, S, D) -> ((B, S, D), the router's f32 aux loss).

    Groups are sequences (GShard): capacity is per sequence, the dispatch
    buffer is (B, E, C, D)."""
    dtype = x.dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    a = s * k
    probs, gate_vals, flat_e, pos, in_cap, c = moe_route(x, p, cfg)

    # dispatch: scatter token indices (only the sentinel slot c collides),
    # then one batched gather
    tok = (torch.arange(a, device=x.device) // k).expand(b, a)
    slot = flat_e * (c + 1) + torch.where(in_cap, pos, c)     # (B, A)
    buf_idx = torch.full((b, e * (c + 1)), s, dtype=torch.long,
                         device=x.device)
    buf_idx.scatter_(1, slot, tok)
    buf_idx = buf_idx.reshape(b, e, c + 1)[:, :, :c].reshape(b, e * c)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    bidx = torch.arange(b, device=x.device)[:, None]
    buf = x_pad[bidx, buf_idx].reshape(b, e, c, d)

    # the experts: (B, E, C, D) batched products over E
    h = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(dtype))
    u = torch.einsum("becd,edf->becf", buf, p["w_up"].to(dtype))
    y = torch.einsum("becf,efd->becd", activation(h, cfg.act) * u,
                     p["w_down"].to(dtype))

    # combine: gather back, gate-weight, sum over k
    y_pad = torch.cat([y, y.new_zeros((b, e, 1, d))], dim=2).reshape(
        b, e * (c + 1), d)
    gates = gate_vals.reshape(b, a).to(dtype) * in_cap.to(dtype)
    y_assign = y_pad[bidx, slot]                              # (B, A, D)
    out = (y_assign * gates[..., None]).reshape(b, s, k, d).sum(dim=2)
    if "shared" in p:
        out = out + mlp(x, p["shared"], cfg)

    # the router's load-balancing loss (Switch)
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = torch.zeros((e,), device=x.device).index_add_(
        0, flat_e.reshape(-1),
        torch.full((b * a,), 1.0 / (b * a), device=x.device))
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return out, aux
