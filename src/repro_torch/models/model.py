"""Model orchestration for the dense family (counterpart of
``repro.models.model``): embeddings, the layer stack, the head, teacher-forced
prefill and one-token decode against per-layer KV caches.

The reference stacks each pattern position's params over its repeats and
walks them with ``lax.scan``; here ``params["blocks"][0]`` is a Python list
of per-layer dicts with the reference's keys and per-layer shapes
(``interchange.model_params_from_numpy`` unstacks the reference's tree), and
the stack is a loop.  The reference's ``remat`` and ``unroll`` settings
change no number and are ignored.  A decode state's ``index`` is a host int,
so a step reads nothing back from the device, and ``decode_step`` writes the
new K/V into the state's caches in place.

Only ``family="dense"`` (the ``("self",)`` pattern: GQA self-attention + a
gated MLP a layer) is ported; other families raise ``NotImplementedError``
(ROADMAP A9b), and ``Model.loss`` waits for the training stack (A10).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import attention as attn
from . import mlp as mlp_mod
from .common import (apply_norm, compute_dtype, dense_init, init_norm,
                     rope_angles)

__all__ = ["Model", "pattern_for"]


def pattern_for(cfg) -> tuple[str, ...]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it waits "
            f"for ROADMAP A9b (the port runs the dense family)")
    return ("self",)


# ---------------------------------------------------------------------------
# per-layer init / apply / decode ("self": attention + gated MLP)
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg, device) -> dict:
    d = cfg.d_model
    return {"ln1": init_norm(d, cfg.norm, device),
            "attn": attn.init_attention(generator, cfg),
            "ln2": init_norm(d, cfg.norm, device),
            "mlp": mlp_mod.init_mlp(generator, cfg)}


def _angles(cfg, positions):
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.rope_fraction)


def _apply_layer(x, p, cfg, angles):
    a_out, kv = attn.self_attention(apply_norm(x, p["ln1"], cfg.norm),
                                    p["attn"], cfg, angles,
                                    chunk=cfg.attn_chunk)
    x = x + a_out
    x = x + mlp_mod.mlp(apply_norm(x, p["ln2"], cfg.norm), p["mlp"], cfg)
    return x, kv


def _apply_layer_prefill(x, p, cfg, angles, max_len: int):
    """Forward one layer AND produce its decode state (teacher-forced
    prefill), shaped as ``_state_init_layer``'s."""
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"a {s}-token prompt does not fit max_len "
                         f"{max_len}")
    x, (k, v) = _apply_layer(x, p, cfg, angles)

    def pad_cache(t):
        out = torch.zeros((b, max_len) + t.shape[2:], dtype=x.dtype,
                          device=x.device)
        out[:, :s] = t.to(x.dtype)
        return out

    return x, {"k": pad_cache(k), "v": pad_cache(v)}


def _state_init_layer(cfg, batch: int, max_len: int, dtype, device) -> dict:
    shape = (batch, max_len, cfg.effective_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_layer(x, p, cfg, state, cur_index: int, angles):
    out, k, v = attn.decode_self_attention(
        apply_norm(x, p["ln1"], cfg.norm), p["attn"], cfg, state["k"],
        state["v"], cur_index, angles)
    x = x + out
    x = x + mlp_mod.mlp(apply_norm(x, p["ln2"], cfg.norm), p["mlp"], cfg)
    return x, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------------

class Model:
    """Functional model wrapper: init / forward / prefill / decode.

    The dense pattern has one layer type, so the stack is the one list
    ``params["blocks"][0]`` (``cfg.num_layers`` layers) and ``tail`` stays
    empty; both keep the reference's tree."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.pattern = pattern_for(cfg)
        self.repeats = cfg.num_layers

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int | torch.Generator = 0,
             device="cuda") -> dict:
        """f32 params drawn from ``seed``: an int, drawn on ``device`` (the
        card unless the caller asks for the CPU), or a ``torch.Generator``,
        whose device must be ``device``'s.  The reference's keys, and its
        shapes per layer."""
        cfg = self.cfg
        dev = resolve_device(device)
        g = seed
        if not isinstance(g, torch.Generator):
            g = torch.Generator(device=dev).manual_seed(int(seed))
        elif g.device.type != dev.type:
            raise ValueError(f"a generator on {g.device} cannot draw "
                             f"params on {dev}")
        dev = g.device
        return {
            "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
            "embed": dense_init(g, (cfg.vocab_size, cfg.d_model)),
            "lm_head": dense_init(g, (cfg.d_model, cfg.vocab_size)),
            "blocks": [[_init_layer(g, cfg, dev)
                        for _ in range(self.repeats)]],
            "tail": []}

    # -- embedding / head ------------------------------------------------------
    def _embed(self, params, tokens):
        """Token ids -> embeddings in the compute dtype (gathered in f32,
        then cast, as the reference does)."""
        table = params["embed"]
        tokens = torch.as_tensor(tokens, device=table.device).long()
        return table[tokens].to(compute_dtype(self.cfg))

    def _head(self, params, x):
        return x @ params["lm_head"].to(x.dtype)

    # -- forward (teacher-forced) ----------------------------------------------
    def forward(self, params, batch, return_hidden: bool = False):
        """Returns (logits (B, S, V), aux) in the compute dtype; with
        return_hidden, (hidden (B, S, D) after the final norm, aux).  aux is
        the reference's MoE loss term, zero for the dense family."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        angles = _angles(cfg, torch.arange(x.shape[1],
                                           device=x.device)[None, :])
        for p in params["blocks"][0]:
            x, _ = _apply_layer(x, p, cfg, angles)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        aux = torch.zeros((), device=x.device)
        if return_hidden:
            return x, aux
        return self._head(params, x), aux

    # -- prefill ---------------------------------------------------------------
    def prefill(self, params, batch, max_len: int):
        """Teacher-forced forward that also builds the decode state.

        Returns (last_position_logits (B, V), decode_state): the state is
        shaped as ``init_decode_state``'s, with index = S."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        s = x.shape[1]
        angles = _angles(cfg, torch.arange(s, device=x.device)[None, :])
        states = []
        for p in params["blocks"][0]:
            x, st = _apply_layer_prefill(x, p, cfg, angles, max_len)
            states.append(st)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        logits = self._head(params, x[:, -1:, :])[:, 0]
        return logits, {"blocks": [states], "tail": [], "index": s}

    # -- decode ----------------------------------------------------------------
    def init_decode_state(self, params, batch_size: int, max_len: int):
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        dev = params["lm_head"].device
        return {"blocks": [[_state_init_layer(cfg, batch_size, max_len,
                                              dtype, dev)
                            for _ in range(self.repeats)]],
                "tail": [], "index": 0}

    def decode_step(self, params, state, token_or_embed,
                    return_hidden: bool = False):
        """One token for the whole batch.  token_or_embed: (B,) int tokens
        (the dense family's frontend).  Returns (logits (B, V) in the compute
        dtype, state); with return_hidden, (hidden (B, D) f32, state): the
        PQ head (``serve/hybrid_head.py``) consumes the hidden state and the
        full-vocab product never runs.  The caches are written in place."""
        cfg = self.cfg
        cur = int(state["index"])
        x = self._embed(params, torch.as_tensor(token_or_embed)[:, None])
        angles = _angles(cfg, torch.full((x.shape[0], 1), cur,
                                         dtype=torch.int32, device=x.device))
        new_states = []
        for p, st in zip(params["blocks"][0], state["blocks"][0]):
            x, st = _decode_layer(x, p, cfg, st, cur, angles)
            new_states.append(st)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        new_state = {"blocks": [new_states], "tail": [], "index": cur + 1}
        if return_hidden:
            return x[:, 0].float(), new_state
        return self._head(params, x)[:, 0], new_state
