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
import gc
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models.model import pattern_for

__all__ = ["H100", "RooflineTerms", "MemCount", "ALLOC_BLOCK", "block_bytes",
           "mem_of", "cost_of", "roofline_from_cost", "count_params",
           "model_flops"]

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


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


ALLOC_BLOCK = 512


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the CUDA caching allocator books it: rounded up to its
    512 B block (0 stays 0), the unit of ``max_memory_allocated``."""
    return -(-int(nbytes) // ALLOC_BLOCK) * ALLOC_BLOCK


def _contiguous_copies(*ts, **_) -> int:
    return sum(block_bytes(t.numel() * t.element_size()) for t in ts
               if isinstance(t, torch.Tensor) and not t.is_contiguous())


def _logsumexp_inner(x, dim, keepdim=False) -> int:
    kept = x.numel() // max(math.prod(x.shape[d] for d in (
        dim if isinstance(dim, (list, tuple)) else [dim])), 1)
    return (block_bytes(x.numel() * x.element_size())
            + block_bytes(kept * x.element_size()))


# ops whose CUDA kernel holds buffers of its own that no meta kernel shows,
# by the op's arguments (found on the H100 by ``tools/memory_probe.py``):
# ``logsumexp`` is a composite below the dispatch modes, whose amax and
# ``(self - amax).exp_()`` live whole until the sum; the softmax kernels
# first copy a non-contiguous input (the masked scores, their grad and
# output) to a contiguous one
_INNER_BYTES = {
    _aten.logsumexp.default: _logsumexp_inner,
    _aten._softmax.default: lambda x, *a, **k: _contiguous_copies(x),
    _aten._softmax_backward_data.default:
        lambda g, y, *a, **k: _contiguous_copies(g, y),
}
# ops that run out of place only because a dispatch mode is on: autograd's
# index backward calls ``_index_put_impl_`` into its zeros in place, and
# ``index_put`` instead where a mode makes every tensor "subclass-like"
# (ATen's ``isTensorSubclassLike``); its ``self`` is not counted beside its
# result at that op
_OUT_OF_PLACE_UNDER_MODES = {_aten.index_put.default}


# the ops through which a new storage takes the share of the parameter it
# comes from (``mem_of``'s ``shares``).  Each way: a cast or a copy (a
# weight's bf16 copy, a grad's f32 one) and each position of a
# ``_foreach_*`` op's lists (the optimizer's grads, moments and updates; the
# microbatches' grads summed).  From the result back to the arguments at
# the given positions only (``_BACK``), where the result is itself a
# weight's: a grad summed from partial grads, put into zeros, or a slice's
# grad scattered back.  So a tensor derived from a weight through any other
# op, an activation, keeps its whole size, whatever its shape.
_EACH_WAY = {_aten._to_copy.default, _aten.clone.default}
_BACK = {
    _aten.add.Tensor: (0, 1), _aten.add_.Tensor: (1,),
    _aten.copy_.default: (1,), _aten.index_put.default: (0,),
    _aten.index_add.default: (0,), _aten.select_backward.default: (0,),
    _aten.slice_backward.default: (0,),
}


@dataclasses.dataclass
class MemCount:
    """A step's device memory, as XLA's ``memory_analysis`` splits it: the
    peak of the live set is ``temp + argument + output - alias`` (the
    arguments and outputs in exact bytes, the rest in the allocator's
    blocks); ``result`` is the call's return value; ``storages`` holds, for
    each storage in order (the arguments' first), the op that made it (None
    for an argument), its shape, the storages its op took, and the share it
    was counted at (None: whole)."""
    temp: int
    output: int
    alias: int
    argument: int
    result: object = dataclasses.field(default=None, repr=False,
                                       compare=False)
    storages: list = dataclasses.field(default_factory=list, repr=False,
                                       compare=False)


class _LiveMode(TorchDispatchMode):
    """The live set of the storages that the ops dispatched inside it
    return: a storage joins it when an op first returns it without having
    taken it as an input, and leaves it when its last tensor dies (a weak
    reference's callback; a storage's Python object lives as long as the
    storage).  So a view or an in-place op adds nothing, and autograd's
    saved tensors and a checkpoint's recomputed ones count while they are
    held.  Each storage gets a serial number (the arguments' first); the
    births, deaths and ends of ops are recorded as ``events`` and the links
    of ``_EACH_WAY``, ``_BACK`` and the foreach ops as ``links``, so that
    ``peak`` can count each storage at a share settled once the call has
    ended."""

    def __init__(self):
        super().__init__()
        self.serial: dict[int, int] = {}   # id of a live storage -> serial
        self.held: list = []               # the arguments' storages
        self.refs: dict[int, weakref.ref] = {}
        self.storages: list = []           # serial -> [op, shape, ins]
        self.sizes: list[int] = []         # serial -> bytes
        self.events: list = []             # (+1 | -1, serial), (0, extra, less)
        self.links: list = []              # (serials each way, serials back)
        self.n_args = 0

    def _add(self, s, op, shape, ins) -> int:
        k = len(self.sizes)
        self.sizes.append(s.nbytes())
        self.storages.append((op, shape, ins))
        self.serial[id(s)] = k
        return k

    def enter_args(self, args):
        for t in _tensors(args):
            s = t.untyped_storage()
            if id(s) not in self.serial:
                self._add(s, None, tuple(t.shape), ())
                self.held.append(s)
        self.n_args = len(self.sizes)

    def _died(self, key):
        del self.refs[key]
        self.events.append((-1, self.serial.pop(key)))

    def _sid(self, t):
        return (self.serial.get(id(t.untyped_storage()))
                if isinstance(t, torch.Tensor) else None)

    def _link(self, func, args, out):
        if func.overloadpacket.__name__.startswith("_foreach_"):
            cols = [a for a in args if isinstance(a, (list, tuple))
                    and a and isinstance(a[0], torch.Tensor)]
            if isinstance(out, (list, tuple)) and out:
                cols.append(out)
            for group in zip(*cols):
                self.links.append(([self._sid(t) for t in group], ()))
        elif func in _EACH_WAY:
            self.links.append(([self._sid(args[0]), self._sid(out)], ()))
        elif func in _BACK:
            o = self._sid(out)
            self.links.append(([o], [(o, self._sid(args[i]))
                                     for i in _BACK[func]
                                     if isinstance(args[i], torch.Tensor)
                                     and args[i].numel() == out.numel()]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inner = _INNER_BYTES.get(func)
        extra = inner(*args, **kwargs) if inner else 0
        less = None
        if func in _OUT_OF_PLACE_UNDER_MODES:
            less = self._sid(args[0])
        out = func(*args, **kwargs)
        ins = {id(t.untyped_storage()): t for t in _tensors((args, kwargs))}
        in_serials = tuple(self.serial[i] for i in ins if i in self.serial)
        for t in _tensors(out):
            s = t.untyped_storage()
            key = id(s)
            if key in ins or key in self.serial:
                continue
            k = self._add(s, str(func), tuple(t.shape), in_serials)
            self.refs[key] = weakref.ref(s, lambda _, k=key: self._died(k))
            self.events.append((1, k))
        self._link(func, args, out)
        self.events.append((0, extra, less))
        return out

    def shares(self, roots: dict[int, float]) -> dict[int, float]:
        """Each storage's share, from the arguments' (``roots``) along the
        links: every storage of a group each way, from a result to its
        arguments back."""
        adj: dict[int, list] = {}
        for group, back in self.links:
            group = [k for k in group if k is not None]
            for a in group:
                adj.setdefault(a, []).extend(b for b in group if b != a)
            for o, i in back:
                if o is not None and i is not None:
                    adj.setdefault(o, []).append(i)
        share = dict(roots)
        todo = list(roots)
        while todo:
            a = todo.pop()
            for b in adj.get(a, ()):
                if b not in share:
                    share[b] = share[a]
                    todo.append(b)
        return share

    def booked(self, k: int, share: dict) -> int:
        f = share.get(k)
        n = self.sizes[k]
        return block_bytes(n if f is None else math.ceil(n * f))

    def peak(self, share: dict) -> int:
        """The live set's peak over the new storages, each at its share,
        with the ops' own buffers (``_INNER_BYTES``) at their op."""
        live = top = 0
        for ev in self.events:
            if ev[0]:
                live += ev[0] * self.booked(ev[1], share)
            else:
                _, extra, less = ev
                held = (self.booked(less, share)
                        if less is not None and less >= self.n_args else 0)
                top = max(top, live + extra - held)
        return top


def mem_of(fn, *args, shares=None) -> MemCount:
    """The device memory of one eager call ``fn(*args)``, counted by the
    live set of its storages (``_LiveMode``), each rounded up to the
    caching allocator's 512 B block, with the hidden buffers of
    ``_INNER_BYTES`` at the op that holds them and the ops of
    ``_OUT_OF_PLACE_UNDER_MODES`` counted as they run without a mode:

      * ``argument``: the bytes of the arguments' storages;
      * ``output``: the bytes of the result's storages, an argument's among
        them (XLA's ``output_size_in_bytes`` counts a donated buffer the
        output reuses too);
      * ``alias``: the bytes of the result's storages that are argument
        storages: params, moments and caches written in place;
      * ``temp``: the peak of the live set less the arguments' storages
        (live at entry, held by the caller throughout) and the result's new
        storages, as XLA's temporaries leave out both; so
        ``temp + output - alias`` is what the call adds at its peak to the
        memory its arguments hold.

    ``shares``, where given, is a list of (argument tensor, share): a new
    storage that comes from that argument's storage through the links of
    ``_LiveMode`` (its casts, its grads and their partial sums, the
    optimizer's temporaries for it) is counted at that share of its bytes
    in ``temp``; every other storage whole.  Run on ``meta`` tensors
    nothing is allocated.  Python's cycle collector is run before the call
    and held off during it: a storage that only a reference cycle holds
    counts until the call ends.  The port's steps leave none that matters:
    a smoke decode step's count is the same with a collection every 20 ops
    (``tests/test_torch_dryrun_memory.py``), and the card's peak over a
    train step matches the count without one (``chip_smoke.py``'s ``train``
    line)."""
    mode = _LiveMode()
    mode.enter_args(args)
    roots = {mode.serial[id(t.untyped_storage())]: f
             for t, f in (shares or ())}
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        with mode:
            result = fn(*args)
        share = mode.shares(roots)
        res = {}
        for t in _tensors(result):
            s = t.untyped_storage()
            res.setdefault(id(s), (s.nbytes(), mode.serial[id(s)]))
        new = sum(mode.booked(k, share) for _, k in res.values()
                  if k >= mode.n_args)
        output = sum(n for n, _ in res.values())
        alias = sum(n for n, k in res.values() if k < mode.n_args)
        argument = sum(mode.sizes[:mode.n_args])
        storages = [(op, shape, ins, share.get(k)) for k, (op, shape, ins)
                    in enumerate(mode.storages)]
        return MemCount(temp=mode.peak(share) - new, output=output,
                        alias=alias, argument=argument, result=result,
                        storages=storages)
    finally:
        if was:
            gc.enable()


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
