"""Model orchestration (counterpart of ``repro.models.model``): layer
patterns, embeddings, the layer stack, the head, teacher-forced prefill and
one-token decode for every architecture family.

A config's layer stack is a repeating *pattern* of layer types (Griffin:
(rglru, rglru, lattn)); the remainder layers (when num_layers % len(pattern)
!= 0) run after the repeats.  The reference stacks each pattern position's
params over its repeats and walks them with ``lax.scan``; here
``params["blocks"][pos]`` is a Python list of per-layer dicts (one a
repeat) with the reference's keys and per-layer shapes, ``params["tail"]``
the remainder layers' dicts (``interchange.model_params_from_numpy``
unstacks the reference's tree), and the stack is a loop: the layer at
(repeat r, position p) runs at depth r * len(pattern) + p, then the tail.
Decode states keep the same layout.

Layer types:
  self       GQA self-attention + gated MLP        (dense / vlm backbone)
  lattn      local-window GQA (+MLP)               (griffin attention layers)
  self_cross self-attn + cross-attn + MLP          (vlm image layers, musicgen)
  moe        self-attn + mixture-of-experts        (qwen-moe family)
  ssd        Mamba2 SSD block (no MLP)             (mamba2)
  rglru      RG-LRU recurrent block + MLP          (griffin recurrent layers)

``cfg.remat`` checkpoints the stack as the reference's ``jax.checkpoint``
of its scan body does: with autograd recording, each repeat of the pattern
(``torch.utils.checkpoint``; the tail layers are not) keeps only its input
and recomputes its activations in the backward pass, which changes no
number.  ``unroll`` changes no number and is ignored.  ``loss`` is the mean
token cross-entropy in sequence chunks, the (B, S, V) f32 logits never
whole.  A decode state's ``index`` is a host int, so a step reads nothing
back from the device; ``decode_step`` writes the new K/V (and a local
layer's slot position) into the state's caches in place.  On the card the
sums of bf16 products stay f32 in ``forward``, ``loss``, ``prefill`` and
``decode_step`` (``device.f32_reductions``), as XLA keeps them: with
PyTorch's default reduced-precision split-K sums, decode and forward sent
qwen2-moe-a2.7b's last token to other experts from layer 7 on.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import f32_reductions, resolve_device
from . import attention as attn
from . import mlp as mlp_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import (META_DRAWS, apply_norm, compute_dtype, dense_init,
                     init_norm, rope_angles)

__all__ = ["Model", "pattern_for"]

_ATTENTION_FREE = ("ssd", "rglru")


def pattern_for(cfg) -> tuple[str, ...]:
    if cfg.family == "ssm":
        return ("ssd",)
    if cfg.family == "hybrid":
        return ("rglru", "rglru", "lattn")[: max(cfg.rglru_pattern, 1)]
    if cfg.family == "moe":
        return ("moe",)
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        return ("self",) * (k - 1) + ("self_cross",) if k > 1 else ("self_cross",)
    if cfg.family == "audio":
        return ("self_cross",)
    return ("self",)


# ---------------------------------------------------------------------------
# per-type init / apply / decode
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg, typ: str, device) -> dict:
    d = cfg.d_model
    if typ == "ssd":
        return {"ln1": init_norm(d, cfg.norm, device),
                "ssd": ssm_mod.init_ssd(generator, cfg)}
    if typ == "rglru":
        return {"ln1": init_norm(d, cfg.norm, device),
                "rec": rglru_mod.init_rglru(generator, cfg),
                "ln2": init_norm(d, cfg.norm, device),
                "mlp": mlp_mod.init_mlp(generator, cfg)}
    p = {"ln1": init_norm(d, cfg.norm, device),
         "attn": attn.init_attention(generator, cfg),
         "ln2": init_norm(d, cfg.norm, device)}
    if typ == "moe":
        p["moe"] = mlp_mod.init_moe(generator, cfg)
    else:
        p["mlp"] = mlp_mod.init_mlp(generator, cfg)
    if typ == "self_cross":
        p["lnx"] = init_norm(d, cfg.norm, device)
        p["xattn"] = attn.init_attention(generator, cfg, cross=True)
    return p


def _angles(cfg, positions):
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.rope_fraction)


def _ffn(x, p, cfg, typ: str):
    """The second half of an attention layer: the MoE or the gated MLP.
    Returns (x, aux)."""
    if typ == "moe":
        out, aux = mlp_mod.moe(apply_norm(x, p["ln2"], cfg.norm), p["moe"],
                               cfg)
        return x + out, aux
    return x + mlp_mod.mlp(apply_norm(x, p["ln2"], cfg.norm), p["mlp"],
                           cfg), None


def _need_cond(cond, cfg):
    if cond is None:
        raise ValueError(f"{cfg.name}: its self_cross layers attend over "
                         f"conditioning embeddings; pass batch['cond'] "
                         f"(B, {cfg.num_cond_tokens}, {cfg.d_model})")
    return cond


def _apply_layer(x, p, cfg, typ: str, cond, angles, max_len=None):
    """One layer over the whole sequence.  Returns (x, aux or None, the
    layer's decode state after the sequence, shaped as
    ``_state_init_layer``'s; an attention layer's only when ``max_len``, the
    caches' length, is given)."""
    if typ == "ssd":
        out, st = ssm_mod.ssd_block(apply_norm(x, p["ln1"], cfg.norm),
                                    p["ssd"], cfg, return_state=True)
        return x + out, None, st
    if typ == "rglru":
        out, st = rglru_mod.rglru_block(apply_norm(x, p["ln1"], cfg.norm),
                                        p["rec"], cfg, return_state=True)
        x = x + out
        x = x + mlp_mod.mlp(apply_norm(x, p["ln2"], cfg.norm), p["mlp"], cfg)
        return x, None, st
    window = cfg.local_window if typ == "lattn" else 0
    a_out, (k, v) = attn.self_attention(apply_norm(x, p["ln1"], cfg.norm),
                                        p["attn"], cfg, angles,
                                        window=window, chunk=cfg.attn_chunk)
    x = x + a_out
    st = None
    if max_len is not None:
        st = (_ring_state(k, v, cfg, max_len) if typ == "lattn"
              else {"k": _pad_cache(k, max_len), "v": _pad_cache(v, max_len)})
    if typ == "self_cross":
        ck, cv = attn.cond_kv(_need_cond(cond, cfg), p["xattn"], cfg)
        if st is not None:
            st["ck"], st["cv"] = ck, cv
        x = x + attn.cross_attention(apply_norm(x, p["lnx"], cfg.norm),
                                     (ck, cv), p["xattn"], cfg)
    x, aux = _ffn(x, p, cfg, typ)
    return x, aux, st


def _pad_cache(t, max_len: int):
    b, s = t.shape[:2]
    if s > max_len:
        raise ValueError(f"a {s}-token prompt does not fit max_len "
                         f"{max_len}")
    out = t.new_zeros((b, max_len) + t.shape[2:])
    out[:, :s] = t
    return out


def _ring_state(k, v, cfg, max_len: int) -> dict:
    """A local layer's ring cache after the prompt: position p lives in slot
    p % W, W = min(local_window, max_len); empty slots hold position -1."""
    b, s = k.shape[:2]
    dtype, dev = k.dtype, k.device
    w = min(cfg.local_window, max_len)
    if s >= w:
        shift = (s - w) % w
        return {"k": torch.roll(k[:, -w:], shift, dims=1),
                "v": torch.roll(v[:, -w:], shift, dims=1),
                "pos": torch.roll(torch.arange(s - w, s, dtype=torch.int32,
                                               device=dev), shift)}
    st = _state_init_layer(cfg, "lattn", b, max_len, dtype, dev)
    st["k"][:, :s] = k
    st["v"][:, :s] = v
    st["pos"][:s] = torch.arange(s, dtype=torch.int32, device=dev)
    return st


def _state_init_layer(cfg, typ: str, batch: int, max_len: int, dtype,
                      device) -> dict:
    hkv, hd = cfg.effective_kv_heads, cfg.resolved_head_dim
    if typ == "ssd":
        return ssm_mod.ssd_decode_init(cfg, batch, dtype, device)
    if typ == "rglru":
        return rglru_mod.rglru_decode_init(cfg, batch, dtype, device)

    def zeros(n):
        return torch.zeros((batch, n, hkv, hd), dtype=dtype, device=device)

    if typ == "lattn":
        w = min(cfg.local_window, max_len)
        return {"k": zeros(w), "v": zeros(w),
                "pos": torch.full((w,), -1, dtype=torch.int32,
                                  device=device)}
    st = {"k": zeros(max_len), "v": zeros(max_len)}
    if typ == "self_cross":
        st["ck"] = zeros(cfg.num_cond_tokens)
        st["cv"] = zeros(cfg.num_cond_tokens)
    return st


def _decode_layer(x, p, cfg, typ: str, state, cur_index: int, angles):
    if typ == "ssd":
        out, st = ssm_mod.ssd_decode_step(apply_norm(x, p["ln1"], cfg.norm),
                                          p["ssd"], cfg, state)
        return x + out, st
    if typ == "rglru":
        out, st = rglru_mod.rglru_decode_step(
            apply_norm(x, p["ln1"], cfg.norm), p["rec"], cfg, state)
        x = x + out
        x = x + mlp_mod.mlp(apply_norm(x, p["ln2"], cfg.norm), p["mlp"], cfg)
        return x, st
    if typ == "lattn":
        out, k, v, pos = attn.decode_local_attention(
            apply_norm(x, p["ln1"], cfg.norm), p["attn"], cfg, state["k"],
            state["v"], state["pos"], cur_index, angles,
            window=cfg.local_window)
        st = {"k": k, "v": v, "pos": pos}
    else:
        out, k, v = attn.decode_self_attention(
            apply_norm(x, p["ln1"], cfg.norm), p["attn"], cfg, state["k"],
            state["v"], cur_index, angles)
        st = {"k": k, "v": v}
    x = x + out
    if typ == "self_cross":
        st["ck"], st["cv"] = state["ck"], state["cv"]
        x = x + attn.cross_attention(apply_norm(x, p["lnx"], cfg.norm),
                                     (state["ck"], state["cv"]), p["xattn"],
                                     cfg)
    x, _ = _ffn(x, p, cfg, typ)
    return x, st


def _recording(x, params) -> bool:
    """Autograd records this forward: grads are enabled and the input or
    the params (their head) require them."""
    return torch.is_grad_enabled() and (x.requires_grad or
                                        params["lm_head"].requires_grad)


def _apply_layers(x, aux, layers, cfg, cond, angles):
    """One repeat of the pattern (a list of (type, params)) over the whole
    sequence, no decode state: (x, aux)."""
    for typ, p in layers:
        x, a, _ = _apply_layer(x, p, cfg, typ, cond, angles)
        if a is not None:
            aux = aux + a
    return x, aux


def _chunk_sums(h_c, head, l_c):
    """(sum of logsumexp - gold logit, sum of logsumexp**2) over one
    sequence chunk, f32."""
    lf = (h_c @ head.to(h_c.dtype)).float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, l_c[..., None])[..., 0]
    return torch.stack([(logz - gold).sum(), (logz ** 2).sum()])


# ---------------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------------

class Model:
    """Functional model wrapper: init / forward / loss / prefill / decode."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.pattern = pattern_for(cfg)
        self.repeats = cfg.num_layers // len(self.pattern)
        self.remainder = self.pattern[: cfg.num_layers % len(self.pattern)]

    def layers(self, tree):
        """(type, entry) of each layer of a params or state tree in depth
        order: repeat by repeat through the pattern, then the tail."""
        for r in range(self.repeats):
            for pos, typ in enumerate(self.pattern):
                yield typ, tree["blocks"][pos][r]
        yield from zip(self.remainder, tree["tail"])

    def _restack(self, entries: list) -> dict:
        """Per-layer entries in depth order -> {"blocks", "tail"}."""
        n = len(self.pattern)
        body = self.repeats * n
        return {"blocks": [entries[pos:body:n] for pos in range(n)],
                "tail": entries[body:]}

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int | torch.Generator = 0,
             device="cuda") -> dict:
        """f32 params drawn from ``seed``: an int, drawn on ``device`` (the
        card unless the caller asks for the CPU), or a ``torch.Generator``,
        whose device must be ``device``'s.  The reference's keys, and its
        shapes per layer; drawn position by position over the repeats, then
        the tail.  On ``meta`` nothing is drawn and ``seed`` is unused: the
        tree's shapes and dtypes, as ``jax.eval_shape(model.init, key)``
        gives them to the reference."""
        cfg = self.cfg
        dev = resolve_device(device)
        g = seed
        if dev.type == "meta":
            g = META_DRAWS
        elif not isinstance(g, torch.Generator):
            g = torch.Generator(device=dev).manual_seed(int(seed))
        elif g.device.type != dev.type:
            raise ValueError(f"a generator on {g.device} cannot draw "
                             f"params on {dev}")
        dev = g.device
        params = {"final_norm": init_norm(cfg.d_model, cfg.norm, dev)}
        if cfg.frontend == "tokens":
            params["embed"] = dense_init(g, (cfg.vocab_size, cfg.d_model))
        params["lm_head"] = dense_init(g, (cfg.d_model, cfg.vocab_size))
        params["blocks"] = [[_init_layer(g, cfg, typ, dev)
                             for _ in range(self.repeats)]
                            for typ in self.pattern]
        params["tail"] = [_init_layer(g, cfg, typ, dev)
                          for typ in self.remainder]
        return params

    # -- embedding / head ------------------------------------------------------
    def _embed(self, params, batch):
        """The batch's inputs in the compute dtype: token ids gathered from
        the f32 table, then cast (as the reference does), or the stub
        frontend's ``embeds``; and ``cond`` (None when absent)."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        if cfg.frontend == "tokens":
            table = params["embed"]
            tokens = torch.as_tensor(batch["tokens"],
                                     device=table.device).long()
            x = table[tokens].to(dtype)
        else:
            if "embeds" not in batch:
                raise ValueError(
                    f"{cfg.name}: the {cfg.frontend!r} frontend takes "
                    f"batch['embeds'] (B, S, {cfg.d_model}), not token ids")
            x = torch.as_tensor(batch["embeds"]).to(
                device=params["lm_head"].device, dtype=dtype)
        cond = batch.get("cond")
        if cond is not None:
            cond = torch.as_tensor(cond).to(device=x.device, dtype=dtype)
        return x, cond

    def _head(self, params, x):
        return x @ params["lm_head"].to(x.dtype)

    def _stack_angles(self, positions):
        """RoPE's angles at ``positions``, shared by every attention layer;
        None for an attention-free stack."""
        if all(t in _ATTENTION_FREE for t in self.pattern):
            return None
        return _angles(self.cfg, positions)

    def _run(self, params, batch, max_len=None):
        """The stack over a whole sequence: (x after the final norm, aux,
        per-layer states in depth order when ``max_len`` is given)."""
        cfg = self.cfg
        x, cond = self._embed(params, batch)
        angles = self._stack_angles(torch.arange(x.shape[1],
                                                 device=x.device)[None, :])
        aux = torch.zeros((), device=x.device)
        states = []
        if max_len is None and cfg.remat and _recording(x, params):
            for r in range(self.repeats):
                layers = [(typ, params["blocks"][pos][r])
                          for pos, typ in enumerate(self.pattern)]
                x, aux = checkpoint(_apply_layers, x, aux, layers, cfg, cond,
                                    angles, use_reentrant=False,
                                    preserve_rng_state=False)
            rest = zip(self.remainder, params["tail"])
        else:
            rest = self.layers(params)
        for typ, p in rest:
            x, a, st = _apply_layer(x, p, cfg, typ, cond, angles, max_len)
            if a is not None:
                aux = aux + a
            states.append(st)
        return apply_norm(x, params["final_norm"], cfg.norm), aux, states

    # -- forward (teacher-forced) ----------------------------------------------
    @f32_reductions()
    def forward(self, params, batch, return_hidden: bool = False):
        """Returns (logits (B, S, V), aux) in the compute dtype; with
        return_hidden, (hidden (B, S, D) after the final norm, aux).  aux is
        the sum of the MoE layers' router losses (f32; zero without MoE)."""
        x, aux, _ = self._run(params, batch)
        if return_hidden:
            return x, aux
        return self._head(params, x), aux

    @f32_reductions()
    def loss(self, params, batch):
        """Mean token cross-entropy (+ MoE aux): (nll + zloss + aux, {"nll",
        "aux", "zloss"}), 0-d f32 tensors.  ``batch["labels"]`` (B, S) holds
        the next tokens.  Computed in sequence chunks of ``cfg.loss_chunk``
        (one chunk when it does not divide S), so the (B, S, V) f32 logits
        never exist whole: each chunk's logits are ``h @ lm_head`` in the
        compute dtype, then f32, and give their sums of logsumexp - gold
        and of logsumexp**2.  With more than one chunk and autograd
        recording, each chunk is checkpointed (its logits recomputed in the
        backward pass), as the reference's ``jax.checkpoint`` of its scan
        body.  zloss = 1e-4 * sum(logz**2) / (B * S)."""
        hidden, aux = self.forward(params, batch, return_hidden=True)
        labels = torch.as_tensor(batch["labels"],
                                 device=hidden.device).long()
        b, s, _ = hidden.shape
        cs = min(self.cfg.loss_chunk, s)
        if s % cs:
            cs = s                        # fallback: single chunk
        nch = s // cs
        head = params["lm_head"]
        remat = nch > 1 and _recording(hidden, params)
        sums = torch.zeros((2,), device=hidden.device)
        for i in range(nch):
            h_c = hidden[:, i * cs:(i + 1) * cs]
            l_c = labels[:, i * cs:(i + 1) * cs]
            if remat:
                sums = sums + checkpoint(_chunk_sums, h_c, head, l_c,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
            else:
                sums = sums + _chunk_sums(h_c, head, l_c)
        denom = float(b * s)
        nll = sums[0] / denom
        zloss = 1e-4 * sums[1] / denom
        return nll + zloss + aux, {"nll": nll, "aux": aux, "zloss": zloss}

    # -- prefill ---------------------------------------------------------------
    @f32_reductions()
    def prefill(self, params, batch, max_len: int):
        """Teacher-forced forward that also builds the decode state.

        Returns (last_position_logits (B, V), decode_state): the state is
        shaped as ``init_decode_state``'s, with index = S."""
        x, _, states = self._run(params, batch, max_len)
        logits = self._head(params, x[:, -1:, :])[:, 0]
        return logits, {**self._restack(states), "index": x.shape[1]}

    # -- decode ----------------------------------------------------------------
    def init_decode_state(self, params, batch_size: int, max_len: int,
                          cond=None):
        """Empty caches and recurrent states for ``batch_size`` sequences of
        up to ``max_len`` positions; with ``cond`` (B, Tc, D), the
        cross-attention layers' K/V precomputed from it."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        dev = params["lm_head"].device
        entries = [_state_init_layer(cfg, typ, batch_size, max_len, dtype,
                                     dev)
                   for typ, _ in self.layers(params)]
        if cond is not None:
            cond = torch.as_tensor(cond).to(device=dev, dtype=dtype)
            for (typ, p), st in zip(self.layers(params), entries):
                if typ == "self_cross":
                    st["ck"], st["cv"] = attn.cond_kv(cond, p["xattn"], cfg)
        return {**self._restack(entries), "index": 0}

    @f32_reductions()
    def decode_step(self, params, state, token_or_embed,
                    return_hidden: bool = False):
        """One token for the whole batch.  token_or_embed: (B,) int tokens,
        or (B, 1, D) embeddings for the ``embeddings`` frontend.  Returns
        (logits (B, V) in the compute dtype, state); with return_hidden,
        (hidden (B, D) f32, state): the PQ head (``serve/hybrid_head.py``)
        consumes the hidden state and the full-vocab product never runs.
        Caches are written in place."""
        cfg = self.cfg
        cur = int(state["index"])
        if cfg.frontend == "tokens":
            x, _ = self._embed(params, {
                "tokens": torch.as_tensor(token_or_embed)[:, None]})
        else:
            x, _ = self._embed(params, {"embeds": token_or_embed})
        angles = self._stack_angles(torch.full(
            (x.shape[0], 1), cur, dtype=torch.int32, device=x.device))
        entries = []
        for (typ, p), (_, st) in zip(self.layers(params),
                                     self.layers(state)):
            x, st = _decode_layer(x, p, cfg, typ, st, cur, angles)
            entries.append(st)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        new_state = {**self._restack(entries), "index": cur + 1}
        if return_hidden:
            return x[:, 0].float(), new_state
        return self._head(params, x)[:, 0], new_state
