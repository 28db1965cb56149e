"""Roofline terms of the port's eager steps (counterpart of
``repro.roofline.analysis``).

  compute term = flops / (chips x peak FLOP/s)
  memory term  = bytes / (chips x memory bandwidth)

The reference reads flops and "bytes accessed" from XLA's
``cost_analysis()`` of the compiled per-device SPMD program and parses the
collectives' bytes from its optimized HLO.  The port runs no SPMD program
and has no compiled module: ``cost_of`` counts one eager call op by op (on
``meta`` tensors, so a production-size cell allocates nothing), and
``roofline_from_cost`` splits the whole job's count evenly over the mesh's
chips.  No collective is reckoned (``collective_s`` is None and the row
says why); ``collective_bytes_from_hlo`` and ``_shape_bytes``, which parse
XLA HLO text, are not ported.

``count_params`` and ``model_flops`` are the reference's analytic counts of
a config, line for line.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models.model import pattern_for

__all__ = ["H100", "RooflineTerms", "cost_of", "roofline_from_cost",
           "count_params", "model_flops"]

# NVIDIA H100 SXM per-card constants (data sheet, dense rates, 700 W)
H100 = {
    "peak_flops": 989e12,       # bf16 FLOP/s on the tensor cores
    "hbm_bw": 3.35e12,          # B/s
    "hbm_bytes": 80e9,          # B of HBM3
}

_aten = torch.ops.aten
# ops that move no data: allocation, aliasing and metadata
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
    _aten._unsafe_view, _aten.set_, _aten.resize_, _aten.resize_as_,
    _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.is_same_size,
}
# ops that overwrite their first argument without reading it
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    return 0


class _CostMode(TorchDispatchMode):
    """Sums flops (``torch.utils.flop_counter``'s formulas) and bytes
    (tensor inputs + outputs of every op that moves data) of the aten ops
    dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and packet not in _NO_TRAFFIC:
            # a destination that is only written counts once, as the output
            reads = args[1:] if packet in _OVERWRITES else args
            self.bytes += (_tensor_bytes(reads) + _tensor_bytes(
                {k: v for k, v in kwargs.items() if k != "out"})
                + _tensor_bytes(out))
        return out


def cost_of(fn, *args) -> tuple[float, float]:
    """(flops, bytes) of one eager call ``fn(*args)``, autograd's backward
    included when ``fn`` runs one, counted at the aten level:

      * flops: ``torch.utils.flop_counter``'s registered formulas (mm,
        addmm, bmm, baddbmm, convolution, scaled-dot-product attention and
        their backwards): 2 a multiply-add.  Elementwise ops, reductions
        and softmax count none, where XLA's ``cost_analysis`` counts an op
        an element; so this is XLA's figure less the elementwise work.
      * bytes: over every op that is not a view, an allocation or a
        metadata query, the bytes of its tensor inputs and outputs (a
        destination the op only writes, as ``copy_``'s, ``fill_``'s,
        ``zero_``'s or an ``out=``, counted once, as an output).  That
        is the eager program's op-by-op traffic with no cache reuse: XLA's
        "bytes accessed" is that of fused kernels, whose intermediates stay
        on chip, so it is smaller for the same step.

    Run it on ``meta`` tensors (``Model.init(device="meta")``,
    ``data.pipeline.input_specs_for_shape``) and nothing is allocated; an
    op that needs the data (a host read) fails there, loudly."""
    mode = _CostMode()
    with mode:
        fn(*args)
    return float(mode.flops), float(mode.bytes)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # whole-job FLOPs (the eager step's count)
    hlo_bytes: float            # whole-job memory bytes
    collective_bytes: float | None
    compute_s: float
    memory_s: float
    collective_s: float | None
    model_flops: float
    bytes_per_device: float
    collective: str = "not reckoned: the port runs no SPMD program"

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "bytes_per_device": self.bytes_per_device,
            "collective": self.collective,
        }


def roofline_from_cost(flops: float, bytes_: float, *, arch: str,
                       shape: str, mesh_name: str, chips: int,
                       model_flops_val: float, bytes_per_device: float,
                       hw: dict = H100) -> RooflineTerms:
    """Terms of a step whose whole-job count is (``flops``, ``bytes_``):
    each device takes 1 / ``chips`` of both (an even split)."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=bytes_, collective_bytes=None,
        compute_s=flops / chips / hw["peak_flops"],
        memory_s=bytes_ / chips / hw["hbm_bw"],
        collective_s=None, model_flops=model_flops_val,
        bytes_per_device=bytes_per_device)


def count_params(cfg) -> tuple[float, float]:
    """(total params, active-per-token params) from the config — analytic,
    no instantiation."""
    d, l, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    pattern = pattern_for(cfg)

    def attn_params():
        return d * hd * (hq + 2 * hkv) + hq * hd * d

    def mlp_params(f):
        return 3 * d * f

    per_type_total, per_type_active = {}, {}
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    f_moe = cfg.moe_d_ff or cfg.d_ff
    for t in set(pattern):
        if t == "ssd":
            d_in = cfg.ssm_expand * d
            n = cfg.ssm_state
            tot = d * (2 * d_in + 2 * n + d_in // cfg.ssm_headdim) + d_in * d
            per_type_total[t] = per_type_active[t] = tot
        elif t == "rglru":
            w = cfg.lru_width or d
            tot = 2 * d * w + 2 * w * w + w * d + mlp_params(cfg.d_ff)
            per_type_total[t] = per_type_active[t] = tot
        elif t == "moe":
            tot = attn_params() + d * e + e * 3 * d * f_moe \
                + (3 * d * f_moe * cfg.num_shared_experts)
            act = attn_params() + d * e + k * 3 * d * f_moe \
                + (3 * d * f_moe * cfg.num_shared_experts)
            per_type_total[t], per_type_active[t] = tot, act
        elif t == "self_cross":
            tot = 2 * attn_params() + mlp_params(cfg.d_ff)
            per_type_total[t] = per_type_active[t] = tot
        else:
            tot = attn_params() + mlp_params(cfg.d_ff)
            per_type_total[t] = per_type_active[t] = tot

    repeats = l // len(pattern)
    layers = list(pattern) * repeats + list(pattern[: l % len(pattern)])
    total = sum(per_type_total[t] for t in layers)
    active = sum(per_type_active[t] for t in layers)
    emb = v * d * (1 if cfg.frontend == "tokens" else 0) + d * v
    return float(total + emb), float(active + emb)


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for the cell: 6·N_active·tokens for training,
    2·N_active·tokens forward-only (prefill / decode), plus the causal
    attention term 2·(q·kv)·d_head·heads per layer pair."""
    total, active = count_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    pattern = pattern_for(cfg)
    l = cfg.num_layers
    layers = (list(pattern) * (l // len(pattern)
                               + 1))[: l]
    hd = cfg.resolved_head_dim
    hq = cfg.num_heads

    def attn_flops(q_tokens, kv_tokens, causal):
        per_pair = 4 * hq * hd        # scores + values, fwd
        pairs = q_tokens * kv_tokens * (0.5 if causal else 1.0)
        return per_pair * pairs

    if shape.kind == "train":
        tokens = b * s
        f = 6.0 * active * tokens
        for t in layers:
            if t in ("self", "moe", "self_cross"):
                f += 3 * b * attn_flops(s, s, True)         # fwd+bwd = 3x fwd
            if t == "lattn":
                f += 3 * b * attn_flops(s, min(cfg.local_window, s), False)
            if t == "self_cross":
                f += 3 * b * attn_flops(s, cfg.num_cond_tokens, False)
        return f
    if shape.kind == "prefill":
        tokens = b * s
        f = 2.0 * active * tokens
        for t in layers:
            if t in ("self", "moe", "self_cross"):
                f += b * attn_flops(s, s, True)
            if t == "lattn":
                f += b * attn_flops(s, min(cfg.local_window, s), False)
            if t == "self_cross":
                f += b * attn_flops(s, cfg.num_cond_tokens, False)
        return f
    # decode: one token against a seq_len cache
    f = 2.0 * active * b
    for t in layers:
        if t in ("self", "moe", "self_cross"):
            f += b * attn_flops(1, s, False)
        if t == "lattn":
            f += b * attn_flops(1, min(cfg.local_window, s), False)
        if t == "self_cross":
            f += b * attn_flops(1, cfg.num_cond_tokens, False)
    return f
