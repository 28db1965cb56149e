"""Dry run of every (architecture x input shape) cell on the production
meshes, and one shard of the paper's billion-vector index searched on the
card (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --retrieval          # on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --retrieval --device cpu --num-points 32768

The reference lowers and compiles each cell's SPMD program for 256 or 512
TPU chips and reads XLA's memory and cost analyses.  The port runs no SPMD
program, so an LM cell is reckoned instead (``lower_cell``):

  * the step (``TrainStep``: grads + ``adamw_update`` for train cells,
    ``Model.prefill`` for prefill, ``Model.decode_step`` on the decode
    state for decode) is counted by ``roofline.cost_of`` on ``meta``
    tensors at 1x and 2x the layer pattern's depth and extrapolated to the
    full depth as the reference does (a tail of remainder layers counted as
    a fraction of a repeat, as there);
  * its memory is the reference's proof, ``temp + argument + output -
    alias`` a device (``reckon_memory``): the arguments, the result and
    its aliases at each leaf's share under the reference's specs on the
    mesh (``models.shardings``), and the temporaries from the live set of
    the port's own step at full depth (``roofline.mem_of``) on the model
    of one device that ``MEM_TEMP_MODEL`` states;
  * a train cell's microbatches and moments come from the reference's fit
    search against ``HBM_FIT`` (doubling, the two-sample jump, the cap at
    ``global_batch // data shards``, bf16 moments at the cap, and an
    honest row where nothing fits); ``--fit-from`` seeds it.

A cell that ``meta`` cannot count is a ``fail`` row with its error, as a
cell the reference cannot compile is.

``lower_retrieval`` is the paper's own configuration: 2^30 hybrid vectors
on the 16-way ``data`` axis, so 2^26 rows a shard.  The reference compiles
its two sharded searches over unfilled ``ShapeDtypeStruct``s; here one
shard (the last, with its row offset) is allocated at its full size from a
seed and searched by the port's per-shard steps (``core.distributed``'s
``_pass1_topk_local`` and ``_search3_local``: K2 with B4's tail bias on
the card), in both code forms, the 128 queries split into the fewest equal
blocks whose (Q, N) f32 bias fits beside the shard.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

from ..configs import SHAPES, get_config
from ..data.pipeline import input_specs_for_shape
from ..device import resolve_device
from ..models import Model
from ..models.common import DEFAULT_RULES, resolve_spec
from ..models.layout import flatten, tree_map
from ..models.shardings import (batch_pspecs, bytes_per_device, logits_pspec,
                                param_pspecs, same_layout, shard_shape,
                                state_out_pspecs, state_pspecs, tree_pspecs)
from ..optim import AdamWConfig, adamw_init
from ..roofline.analysis import (H100, cost_of, mem_of, model_flops,
                                 roofline_from_cost)
from ..train import make_train_step
from .mesh import make_production_mesh

__all__ = ["OPT_CFG", "HBM_BYTES", "HBM_FIT", "MEM_TEMP_MODEL", "skip_reason",
           "input_specs", "build_cell", "probe_costs", "local_config",
           "local_shape", "reckon_memory", "lower_cell", "retrieval_shard",
           "shard_calls", "lower_retrieval", "main"]

OPT_CFG = AdamWConfig()

HBM_BYTES = H100["hbm_bytes"]
HBM_FIT = int(HBM_BYTES * 15.5 / 16)   # the reference's headroom share

MEM_TEMP_MODEL = (
    "the live set of the port's eager step at full depth on meta, each "
    "storage rounded to the caching allocator's 512 B block: activations at "
    "the per-device batch (global_batch over pod x data); heads, kv heads, "
    "the MLP and MoE widths or the experts, the RG-LRU and SSD widths and "
    "the vocabulary divided by 'model' where the reference's rules shard "
    "them (local_config); the storages that come from a parameter (its "
    "casts, its grad and the partial grads summed into it, the optimizer's "
    "temporaries for it; roofline.mem_of's links, not shapes) at the "
    "parameter's per-device share, every other storage whole; plus "
    "one repeat's weights gathered along fsdp; a step of n > 2 microbatches "
    "reckoned at its first two")


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skipped: pure full-attention arch — 524288-token dense KV "
                "cache requires sub-quadratic attention (DESIGN.md "
                "§Arch-applicability)")
    return None


def input_specs(arch: str, shape_name: str = "train_4k") -> dict:
    """``meta`` stand-ins for every model input of the cell."""
    return input_specs_for_shape(get_config(arch), SHAPES[shape_name])


@dataclasses.dataclass
class Cell:
    """A cell's step, its ``meta`` arguments and their specs on a mesh."""
    fn: object
    args: tuple
    specs: object          # mesh -> a spec tree a argument

    def bytes_per_device(self, mesh) -> int:
        return sum(bytes_per_device(a, s, mesh)
                   for a, s in zip(self.args, self.specs(mesh)))


def build_cell(cfg, shape, *, microbatches: int = 1,
               opt_cfg: AdamWConfig | None = None) -> Cell:
    """The cell's step (train step / prefill / decode step) over ``meta``
    arguments, as the reference's ``build_lowered`` lays them out."""
    opt_cfg = opt_cfg or OPT_CFG
    model = Model(cfg)
    params = model.init(device="meta")
    if shape.kind == "train":
        batch = input_specs_for_shape(cfg, shape)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(model, opt_cfg, microbatches=microbatches,
                               cast_params_bf16=cfg.params_bf16_cast)
        return Cell(step, (params, opt, batch), lambda mesh: (
            param_pspecs(params, mesh), tree_pspecs(opt, mesh, params),
            batch_pspecs(batch, mesh)))
    if shape.kind == "prefill":
        batch = input_specs_for_shape(cfg, shape)

        def prefill_step(params, batch):
            return model.prefill(params, batch, shape.seq_len)

        return Cell(prefill_step, (params, batch), lambda mesh: (
            param_pspecs(params, mesh), batch_pspecs(batch, mesh)))
    b = shape.global_batch
    cond = None
    if cfg.num_cond_tokens:
        cond = torch.empty((b, cfg.num_cond_tokens, cfg.d_model),
                           dtype=torch.bfloat16, device="meta")
    state = model.init_decode_state(params, b, shape.seq_len, cond=cond)
    token = input_specs_for_shape(cfg, shape)["token"]

    def serve_step(params, state, token):
        return model.decode_step(params, state, token)

    return Cell(serve_step, (params, state, token), lambda mesh: (
        param_pspecs(params, mesh), state_pspecs(state, mesh),
        batch_pspecs({"token": token}, mesh)["token"]))


def probe_costs(cfg, shape, opt_cfg: AdamWConfig | None = None):
    """(flops, bytes) of the whole job's step at the full depth: counted at
    1x and 2x the pattern's depth (microbatches 1) and extrapolated as the
    reference extrapolates its unrolled compiles."""
    plen = len(Model(cfg).pattern)
    counts = []
    for depth in (plen, 2 * plen):
        cell = build_cell(dataclasses.replace(cfg, num_layers=depth,
                                              unroll=True), shape,
                          opt_cfg=opt_cfg)
        counts.append(cost_of(cell.fn, *cell.args))
    reps_total = cfg.num_layers / plen          # fractional incl. remainder
    return tuple(base + (reps_total - 1.0) * max(two - base, 0.0)
                 for base, two in zip(*counts))


def local_config(cfg, mesh):
    """``cfg`` at one device's share of each width that the reference's
    rules shard over ``model`` (a width is cut where the first logical axis
    of its weight that takes ``model`` carries it, and ``model`` divides it,
    as ``resolve_spec`` decides): the kv heads, or else the query heads of
    a group; the MLP width; the experts, or else the MoE width (the shared
    experts' width is cut with the MoE width only); the RG-LRU width; the
    SSD inner width and its heads (the SSD's B and C stay whole); the
    vocabulary.  The model width and the head dim stay whole."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return cfg

    def cut(n: int) -> int:
        return n // m if n >= m and n % m == 0 else n

    ch = {"head_dim": cfg.resolved_head_dim, "d_ff": cut(cfg.d_ff),
          "vocab_size": cut(cfg.vocab_size)}
    kv, r = cfg.num_kv_heads, cfg.kv_repeat
    if cut(kv * r) != kv * r:       # wq (d, kv heads, group, hd): kv heads
        if cut(kv) != kv:
            ch.update(num_kv_heads=kv // m, num_heads=cfg.num_heads // m)
        elif cut(r) != r:
            ch.update(kv_repeat=r // m, num_heads=cfg.num_heads // m)
    elif cut(cfg.num_heads // (kv * r)) != cfg.num_heads // (kv * r):
        ch["num_heads"] = cfg.num_heads // m          # else the group
    if cfg.num_experts:
        if cut(cfg.num_experts) != cfg.num_experts:
            e = cut(cfg.num_experts)
            ch.update(num_experts=e,
                      num_experts_per_tok=min(cfg.num_experts_per_tok, e))
        else:
            ch["moe_d_ff"] = cut(cfg.moe_d_ff)
    if "rglru" in Model(cfg).pattern:
        ch["lru_width"] = cut(cfg.lru_width or cfg.d_model)
    if "ssd" in Model(cfg).pattern:
        d_in = cfg.ssm_expand * cfg.d_model
        if cut(d_in) != d_in and (d_in // m) % cfg.ssm_headdim == 0:
            expand = (d_in // m) / cfg.d_model
            if expand * cfg.d_model != d_in // m:
                raise ValueError(f"{cfg.name}: the SSD width {d_in // m} a "
                                 f"device is no exact ssm_expand")
            ch["ssm_expand"] = expand
    return dataclasses.replace(cfg, **ch)


def local_shape(shape, mesh):
    """``shape`` at one device's batch: ``global_batch`` over the axes its
    ``batch`` rule takes on ``mesh`` (``pod`` x ``data`` where they divide
    it, as ``batch_pspecs``)."""
    b = shape.global_batch
    spec = resolve_spec(mesh, DEFAULT_RULES, ("batch",), (b,))
    return dataclasses.replace(shape,
                               global_batch=shard_shape((b,), spec, mesh)[0])


def _zip_specs(tree, specs, like):
    """(leaf of ``tree``, its spec, ``like``'s leaf at its place), walking
    ``tree``'s containers; a spec that stands for a whole container (an
    int8 moment block's) covers each leaf below it."""
    if isinstance(tree, (dict, list, tuple)):
        keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
        for k in keys:
            sub = specs if isinstance(specs, tuple) else specs[k]
            yield from _zip_specs(tree[k], sub, like[k])
    else:
        yield tree, specs, like


def _param_shares(cell, local, mesh) -> list | None:
    """``shares`` for ``mem_of``: each of the local step's parameters with
    the share of its local bytes that one device holds under its spec on
    the whole job's tree; None where every share is whole."""
    params, lparams = cell.args[0], local.args[0]
    shares = [(loc, math.prod(shard_shape(g.shape, spec, mesh))
               / max(loc.numel(), 1))
              for g, spec, loc in _zip_specs(
                  params, param_pspecs(params, mesh), lparams)]
    return None if all(f == 1.0 for _, f in shares) else shares


def _gathered_repeat(cfg, shape, local, mesh) -> int:
    """The bytes of one repeat's weights at their ``model`` share, as the
    scan body of the reference's SPMD program gathers them along ``fsdp``
    (bf16 where the train step casts them); 0 without an ``fsdp`` axis."""
    fsdp = DEFAULT_RULES["fsdp"]
    if mesh.shape.get(fsdp, 1) == 1:
        return 0
    params = local.args[0]
    layers = ([p for pos in params["blocks"] for p in pos[:1]]
              if params["blocks"] and params["blocks"][0] else
              params["tail"][:1])
    size = 2 if shape.kind == "train" and cfg.params_bf16_cast else None
    return sum(t.numel() * (size or t.element_size())
               for t in flatten(layers))


def _leaf_out_bytes(leaf, like, spec, mesh) -> int:
    if isinstance(leaf, torch.Tensor):
        return (math.prod(shard_shape(like.shape, spec, mesh))
                * leaf.element_size())
    return 4              # a host int stands for the reference's int32 ()


def _result_bytes(cfg, cell, local, result, shape,
                  mesh) -> tuple[int, int]:
    """(output, alias) bytes a device of the step's result: each leaf at
    its share under the spec the reference's compiled step gives it
    (params and moments their own, metrics replicated, logits by batch and
    vocab, the new decode state ``state_out_pspecs``); a leaf aliases its
    donated argument (the params, the moments, the decode state) where the
    two agree in layout, shape and dtype, as XLA reuses a donated buffer
    for such an output (a host int: the reference's int32 index).  So a
    recurrent state that the port's step returns in a new buffer aliases,
    and an SSD state that turns f32 from its bf16 init does not."""
    params = cell.args[0]
    if shape.kind == "train":
        pspecs = param_pspecs(params, mesh)
        ospecs = tree_pspecs(cell.args[1], mesh, params)
        parts = [(result[0], params, pspecs, pspecs, local.args[0]),
                 (result[1], cell.args[1], ospecs, ospecs, local.args[1]),
                 (result[2], result[2], tree_map(lambda _: (), result[2]),
                  None, None)]
    else:
        b, v = shape.global_batch, params["lm_head"].shape[-1]
        logits = torch.empty((b, v), device="meta")
        if shape.kind == "prefill":
            state, in_specs = Model(cfg).init_decode_state(
                params, b, shape.seq_len), None
        else:
            state = cell.args[1]
            in_specs = state_pspecs(state, mesh)
        parts = [(result[0], logits, logits_pspec((b, v), mesh), None, None),
                 (result[1], state, state_out_pspecs(state, mesh), in_specs,
                  local.args[1] if in_specs is not None else None)]
    output = alias = 0
    for res, like, out_specs, in_specs, donated in parts:
        outs = list(_zip_specs(res, out_specs, like))
        ins = (list(_zip_specs(res, in_specs, donated))
               if in_specs is not None else [None] * len(outs))
        for (leaf, spec, g), inp in zip(outs, ins):
            n = _leaf_out_bytes(leaf, g, spec, mesh)
            output += n
            if inp is None or not same_layout(spec, inp[1], mesh):
                continue
            old = inp[2]
            if not isinstance(leaf, torch.Tensor) or (
                    isinstance(old, torch.Tensor) and leaf.shape == old.shape
                    and leaf.dtype == old.dtype):
                alias += n
    return output, alias


def reckon_memory(cfg, shape, mesh, *, microbatches: int = 1,
                  opt_cfg: AdamWConfig | None = None) -> dict:
    """One device's memory for the cell's step on ``mesh``, as the
    reference reads it from XLA's ``memory_analysis``: ``mem_argument``,
    ``mem_output`` and ``mem_alias`` from each leaf's spec on the whole
    job's trees (``Cell.bytes_per_device``, ``_result_bytes``), and
    ``mem_temp`` from ``mem_of`` on the step built from ``local_config``
    at ``local_shape`` (``MEM_TEMP_MODEL``); ``bytes_per_device`` is
    ``temp + argument + output - alias``.  On a one-device mesh the step
    reckoned is the cell's own."""
    opt_cfg = opt_cfg or OPT_CFG
    cell = build_cell(cfg, shape, microbatches=microbatches, opt_cfg=opt_cfg)
    lcfg, lshape, mb = local_config(cfg, mesh), local_shape(shape, mesh), \
        microbatches
    if shape.kind == "train" and mb > 2:
        # microbatches 3..n hold the second's live set again: the step's
        # first two, over the rows they take
        if lshape.global_batch % mb:
            raise ValueError(f"batch {lshape.global_batch} does not split "
                             f"into {mb} microbatches")
        lshape = dataclasses.replace(
            lshape, global_batch=2 * lshape.global_batch // mb)
        mb = 2
    local = build_cell(lcfg, lshape, microbatches=mb, opt_cfg=opt_cfg)
    mem = mem_of(local.fn, *local.args,
                 shares=_param_shares(cell, local, mesh))
    temp = mem.temp + _gathered_repeat(cfg, shape, local, mesh)
    output, alias = _result_bytes(cfg, cell, local, mem.result, shape, mesh)
    argument = cell.bytes_per_device(mesh)
    return {"mem_temp": int(temp), "mem_argument": int(argument),
            "mem_output": int(output), "mem_alias": int(alias),
            "bytes_per_device": int(temp + argument + output - alias)}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               verbose: bool = True, probes: bool = True,
               fit_hint: dict | None = None) -> dict:
    """One LM cell's row: the memory proof (``reckon_memory``) with, for a
    train cell, the reference's fit of microbatches and moments, and, with
    ``probes``, the roofline terms from the counted step.  ``fit_hint``
    seeds (microbatches, opt_moments) from a previous sweep."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}

    mesh = make_production_mesh(multi_pod=multi_pod)

    # ---- the memory proof, with the reference's auto-fit: escalate
    # microbatches (keeping the per-microbatch batch >= data shards); if
    # the f32 optimizer alone exceeds the card, bf16 moments
    data_shards = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    max_mb = max(shape.global_batch // data_shards, 1)
    t0 = time.time()
    microbatches, opt_cfg = 1, OPT_CFG
    if fit_hint:
        microbatches = min(int(fit_hint.get("microbatches", 1)), max_mb)
        if fit_hint.get("opt_moments") == "bfloat16":
            opt_cfg = AdamWConfig(moment_dtype="bfloat16")
    seen = {}
    while True:
        mem = reckon_memory(cfg, shape, mesh, microbatches=microbatches,
                            opt_cfg=opt_cfg)
        mem_dev = mem["bytes_per_device"]
        seen[microbatches] = mem_dev
        if shape.kind != "train" or mem_dev <= HBM_FIT:
            break
        if microbatches < max_mb:
            if len(seen) >= 2:
                # temp(mb) ~ fixed + act/mb: solve from two samples and jump
                mbs = sorted(seen)[-2:]
                m1, m2 = seen[mbs[0]], seen[mbs[1]]
                act = (m1 - m2) / (1.0 / mbs[0] - 1.0 / mbs[1]) \
                    if mbs[0] != mbs[1] else 0.0
                fixed = m1 - act / mbs[0]
                target = microbatches * 2
                while (fixed + act / target > HBM_FIT
                       and target < max_mb):
                    target *= 2
                microbatches = min(target, max_mb)
            else:
                microbatches = min(microbatches * 2, max_mb)
            if verbose:
                print(f"  {mem_dev/2**30:.1f} GiB > fit; retry "
                      f"microbatches={microbatches}")
            continue
        if opt_cfg.moment_dtype == "float32":
            opt_cfg = AdamWConfig(moment_dtype="bfloat16")
            if verbose:
                print(f"  {mem_dev/2**30:.1f} GiB > fit at max microbatches; "
                      f"retry with bf16 optimizer moments")
            continue
        break                           # report honestly as not fitting
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok", "microbatches": microbatches,
           "opt_moments": opt_cfg.moment_dtype,
           "bytes_per_device": float(mem_dev),
           "fits_hbm": bool(mem_dev <= HBM_BYTES),
           **{k: mem[k] for k in ("mem_temp", "mem_argument", "mem_output",
                                  "mem_alias")},
           "mem_temp_model": MEM_TEMP_MODEL}
    if not probes:
        row["count_s"] = time.time() - t0
        if verbose:
            print(f"--- {arch} × {shape_name} × {mesh_name} ---")
            print(f"microbatches={microbatches} "
                  f"bytes/dev={mem_dev / 2 ** 30:.2f}GiB "
                  f"fits={row['fits_hbm']}")
        return row

    flops, bytes_ = probe_costs(cfg, shape, opt_cfg)
    terms = roofline_from_cost(
        flops, bytes_, arch=arch, shape=shape_name, mesh_name=mesh_name,
        chips=mesh.size, model_flops_val=model_flops(cfg, shape),
        bytes_per_device=float(mem_dev))
    row = {**terms.row(), **row, "collective_bytes": None,
           "hlo_bytes": terms.hlo_bytes, "count_s": time.time() - t0}
    if verbose:
        print(f"--- {arch} × {shape_name} × {mesh_name} ---")
        print(f"microbatches={microbatches} temp={mem['mem_temp']} "
              f"argument={mem['mem_argument']} output={mem['mem_output']} "
              f"alias={mem['mem_alias']}")
        print(f"roofline: compute {terms.compute_s * 1e3:.2f}ms "
              f"memory {terms.memory_s * 1e3:.2f}ms collective - "
              f"dominant={terms.dominant} useful={terms.useful_ratio:.3f} "
              f"bytes/dev={mem_dev / 2 ** 30:.2f}GiB fits={row['fits_hbm']}")
    return row


# ---------------------------------------------------------------------------
# the paper's system: one shard of the 2^30-row index
# ---------------------------------------------------------------------------

K_PQ, L_PQ = 100, 16              # 200 dense dims -> K=100 subspaces
D_DENSE = 200
D_ACTIVE, L_MAX = 65536, 256      # per-shard compact columns
R_MAX = 64                        # sparse residual entries per row
NUM_QUERIES, NQ = 128, 256
H, ALPHA, BETA = 100, 5, 2
# what a query block needs beside its (Q, N) f32 bias: candidates, the
# passes' gathers and the allocator's rounding
BLOCK_SLACK = 1 << 30


def _shard_rows(num_points: int, shards: int) -> int:
    n = num_points - num_points % (shards * 128)
    return n // shards


def retrieval_shard(n_local: int, *, seed: int = 0, device="cuda") -> dict:
    """One shard's arrays and the replicated queries at the reference's
    shapes, drawn from ``seed`` on ``device``: codes (n, K) uint8 in [0,
    16), the padded inverted index (d_active, l_max) int32 rows (each list
    full, rows local) + f32 values, the int8 dense residual (n, 200) with
    its scale and zero, the padded sparse residual (n, r_max) int32
    columns in [0, d_active] + f32 values, and the queries: LUT (Q, K, 16),
    q_dims (Q, nq) distinct dims, q_vals, q_dense (Q, 200) and q_cols (Q,
    d_active + 1), the queries scattered into the compact space."""
    from ..core.engine import scatter_queries_compact

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))

    def ints(lo, hi, size, dtype):
        return torch.randint(lo, hi, size, generator=g, dtype=dtype,
                             device=dev)

    def unif(size):
        return torch.rand(size, generator=g, device=dev)

    out = {"codes": ints(0, 16, (n_local, K_PQ), torch.uint8),
           "inv_rows": ints(0, n_local, (D_ACTIVE, L_MAX), torch.int32),
           "inv_vals": unif((D_ACTIVE, L_MAX)),
           "res_q": ints(-128, 128, (n_local, D_DENSE), torch.int8),
           "res_scale": unif((D_DENSE,)) * 0.01,
           "res_zero": unif((D_DENSE,)) * 0.01,
           "sres_cols": ints(0, D_ACTIVE + 1, (n_local, R_MAX), torch.int32),
           "sres_vals": unif((n_local, R_MAX)),
           "lut": torch.randn((NUM_QUERIES, K_PQ, L_PQ), generator=g,
                              device=dev),
           "q_dims": torch.argsort(unif((NUM_QUERIES, D_ACTIVE)), dim=1)[
               :, :NQ].to(torch.int32).contiguous(),
           "q_vals": unif((NUM_QUERIES, NQ)),
           "q_dense": torch.randn((NUM_QUERIES, D_DENSE), generator=g,
                                  device=dev)}
    out["q_cols"] = scatter_queries_compact(out["q_dims"], out["q_vals"],
                                            D_ACTIVE)
    return out


def _pack(codes: torch.Tensor) -> torch.Tensor:
    """(n, K) codes, K even -> (n, K / 2), subspace 2j in byte j's low
    nibble (``kernels.lut16.pack_codes``'s layout, on the device)."""
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous()


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _query_blocks(n_local: int, q: int, dev: torch.device,
                  blocks: int | None) -> int:
    """The fewest equal blocks of the ``q`` queries whose (Q_b, N) f32 bias
    and ``BLOCK_SLACK`` fit the card's free memory; 1 on the CPU, unless
    ``blocks`` is given.  Raises where no block size fits."""
    if blocks is not None:
        if q % blocks:
            raise ValueError(f"{q} queries do not split into {blocks} "
                             "equal blocks")
        return blocks
    if dev.type != "cuda":
        return 1
    free = torch.cuda.mem_get_info(dev)[0]
    for nb in (d for d in range(1, q + 1) if q % d == 0):
        if (q // nb) * n_local * 4 + BLOCK_SLACK <= free:
            return nb
    raise RuntimeError(f"no query block's bias fits: a one-query bias of "
                       f"{n_local * 4} B + {BLOCK_SLACK} B against {free} "
                       "B free")


def _timed(fn, dev: torch.device, runs: int = 3) -> tuple[float, list]:
    """(median ms, the runs' ms) of ``fn()`` after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _blocked(fn, q: int, blocks: int):
    """``fn(lo, hi)`` over ``blocks`` equal query ranges, its (scores, ids)
    concatenated along the queries."""
    per = q // blocks
    parts = [fn(i * per, (i + 1) * per) for i in range(blocks)]
    return (torch.cat([s for s, _ in parts]),
            torch.cat([i for _, i in parts]))


def shard_calls(arrs: dict, backend, row_offset: int):
    """The reference's two calls on the shard ``arrs`` (its current
    ``codes``), each over queries [lo, hi): the pass-1 fan-out at k (100
    by default) and the three-pass search, through the port's per-shard
    steps.  Returns (pass1, search3)."""
    from ..core.distributed import _pass1_topk_local, _search3_local

    def pass1(lo, hi, k=H):
        return _pass1_topk_local(
            arrs["codes"], arrs["lut"][lo:hi], arrs["inv_rows"],
            arrs["inv_vals"], arrs["q_dims"][lo:hi], arrs["q_vals"][lo:hi],
            k=k, backend=backend)

    def search3(lo, hi):
        return _search3_local(
            arrs["codes"], arrs["lut"][lo:hi], arrs["inv_rows"],
            arrs["inv_vals"], arrs["res_q"], arrs["res_scale"],
            arrs["res_zero"], arrs["sres_cols"], arrs["sres_vals"],
            arrs["q_dims"][lo:hi], arrs["q_vals"][lo:hi],
            arrs["q_dense"][lo:hi], arrs["q_cols"][lo:hi], row_offset, h=H,
            alpha=ALPHA, beta=BETA, backend=backend)

    return pass1, search3


def _search_form(arrs: dict, backend, row_offset: int, blocks: int,
                 dev: torch.device, runs: int) -> dict:
    """Both calls of one code form over the query blocks: ms (median of
    ``runs`` after a warm-up), rows/s, launches of the first call and of
    all ``runs + 2`` calls, peak memory, and whether the three-pass ids lie
    in the shard's global rows.  The calls' results are under
    ``results``."""
    from ..kernels import ops

    q = arrs["lut"].shape[0]
    n_local = arrs["codes"].shape[0]
    out = {}
    results = {}
    for name, fn in zip(("pass1", "three_pass"),
                        shard_calls(arrs, backend, row_offset)):
        def call(fn=fn):
            return _blocked(fn, q, blocks)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = dict(ops.LAUNCHES)
        results[name] = call()
        first = dict(ops.LAUNCHES)
        ms, times = _timed(call, dev, runs)
        out[name] = {"ms": ms, "ms_runs": times,
                     "rows_per_s": n_local / (ms / 1e3),
                     "launches": {k: v - before[k] for k, v in first.items()
                                  if v != before[k]},
                     "launches_all_calls": {
                         k: v - before[k] for k, v in ops.LAUNCHES.items()
                         if v != before[k]}}
        if dev.type == "cuda":
            out[name]["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated(dev)
    s3, ids3 = results["three_pass"]
    live = ids3[torch.isfinite(s3)].long()
    out["ids_in_shard"] = bool(
        live.numel() == ids3.numel() and int(live.min()) >= row_offset
        and int(live.max()) < row_offset + n_local)
    out["id_range"] = [int(ids3.min()), int(ids3.max())]
    out["results"] = results
    return out


def lower_retrieval(*, multi_pod: bool, num_points: int = 2 ** 30,
                    device="cuda", seed: int = 0,
                    query_blocks: int | None = None, runs: int = 3,
                    keep_results: bool = False, inspect=None,
                    verbose: bool = True) -> dict:
    """One shard of the paper's production index searched on ``device``:
    2^30 hybrid vectors over the mesh's 16-way ``data`` axis, so the last
    shard holds 2^26 rows from row offset 15 * 2^26 (global ids near the
    top of the int32 range the reference's ids take).  Its arrays (``retrieval_shard``) are allocated at full size;
    then the pass-1 fan-out (k = 100) and the three-pass search (h = 100,
    alpha = 5, beta = 2, so c1 = 500 and K2 runs fused with B4's tail bias)
    run through the port's per-shard steps, ``cuda`` then ``cuda-packed``
    (the unpacked codes freed before the packed form runs).  The 128
    queries go in the fewest equal blocks whose bias fits (``query_blocks``
    overrides); every call is timed (median of ``runs`` after a warm-up)
    and its launches counted, and the three-pass ids are held to the
    shard's row range.  ``inspect(arrs, backend, row_offset, blocks,
    results, dev, runs)``, where given, runs after each form's calls while
    its codes live, and its dict joins the form's entry
    (``launch.retrieval_check.inspect_form``: the checks against the plain
    versions and the kernels' own times).  On the CPU the wrappers run
    their plain versions.  Returns the row (with each form's results under
    ``results`` if ``keep_results``)."""
    from ..core.engine import Backend

    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    shards = mesh.shape["data"]
    n_local = _shard_rows(num_points, shards)
    shard = shards - 1
    row_offset = shard * n_local
    if row_offset + n_local >= 2 ** 31:
        raise ValueError("global ids must stay int32")
    if dev.type == "cuda":
        # cuBLAS takes its workspace (32 MiB, kept for the process's life)
        # at its first product; taken here, it cannot land in a freed bias
        # block's segment and pin it, which would leave no room for the next
        # block's bias beside the shard
        w = torch.ones((8, 8), device=dev)
        torch.mm(w, w), torch.mv(w, w[0])
    allocated = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.time()
    arrs = retrieval_shard(n_local, seed=seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.time() - t0
    reckoned = {
        "codes": _nbytes(arrs["codes"]),
        "codes_packed": n_local * (K_PQ // 2),
        "inverted_index": _nbytes(arrs["inv_rows"], arrs["inv_vals"]),
        "dense_residual": _nbytes(arrs["res_q"], arrs["res_scale"],
                                  arrs["res_zero"]),
        "sparse_residual": _nbytes(arrs["sres_cols"], arrs["sres_vals"]),
        "queries": _nbytes(*(arrs[k] for k in ("lut", "q_dims", "q_vals",
                                                "q_dense", "q_cols")))}
    reckoned["shard"] = (reckoned["codes"] + reckoned["inverted_index"]
                         + _nbytes(arrs["res_q"])
                         + reckoned["sparse_residual"])
    arrays_bytes = sum(v for k, v in reckoned.items()
                       if k not in ("codes_packed", "shard"))
    if any(t.data_ptr() % 16 for t in arrs.values()):
        raise RuntimeError("a shard array is not 16-byte aligned")
    row = {"arch": "hybrid-retrieval-1b", "shape": "search_q128",
           "mesh": mesh_name, "status": "ok", "device": str(dev),
           "num_points": num_points, "shards": shards, "shard": shard,
           "rows": n_local, "row_offset": row_offset, "seed": seed,
           "shapes": {"K": K_PQ, "l": L_PQ, "d_dense": D_DENSE,
                      "d_active": D_ACTIVE, "l_max": L_MAX, "r_max": R_MAX,
                      "Q": NUM_QUERIES, "nq": NQ, "h": H, "alpha": ALPHA,
                      "beta": BETA},
           "build_s": build_s, "reckoned_bytes": reckoned,
           "bytes_per_device": float(arrays_bytes),
           "fits_hbm": bool(arrays_bytes <= HBM_BYTES),
           "timer": "cuda events" if dev.type == "cuda" else "host clock"}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        row["memory_allocated_by_build"] = (torch.cuda.memory_allocated(dev)
                                            - allocated)
        row["total_memory"] = torch.cuda.get_device_properties(
            dev).total_memory
        row["nvidia_smi"] = _smi_line()
        row["device_name"] = torch.cuda.get_device_name(dev)
    blocks = _query_blocks(n_local, NUM_QUERIES, dev, query_blocks)
    per = NUM_QUERIES // blocks
    row["query_blocks"] = {"blocks": blocks, "queries_a_block": per,
                           "bias_bytes_a_block": per * n_local * 4,
                           "slack_bytes": BLOCK_SLACK}
    if dev.type == "cuda":
        row["query_blocks"]["free_before"] = torch.cuda.mem_get_info(dev)[0]
    forms = {}
    for form in ("cuda", "cuda-packed"):
        if form == "cuda-packed":
            arrs["codes"] = _pack(arrs["codes"])
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        backend = Backend.from_name(form)
        forms[form] = _search_form(arrs, backend, row_offset, blocks, dev,
                                   runs)
        if inspect is not None:
            forms[form].update(inspect(arrs, backend, row_offset, blocks,
                                       forms[form]["results"], dev, runs))
        if dev.type == "cuda":
            arrays_now = (arrays_bytes - reckoned["codes"]
                          + _nbytes(arrs["codes"]))
            forms[form]["peak_over_arrays"] = max(
                forms[form][c]["max_memory_allocated"]
                for c in ("pass1", "three_pass")) - arrays_now
        if not keep_results:
            forms[form].pop("results")
        if verbose:
            print(f"  {form}: pass-1 {forms[form]['pass1']['ms']:.2f} ms, "
                  f"three-pass {forms[form]['three_pass']['ms']:.2f} ms "
                  f"({row['timer']})", flush=True)
    row["forms"] = forms
    del arrs
    if verbose:
        print(f"--- retrieval 1B × {mesh_name}: shard {shard} of {shards}, "
              f"{n_local} rows on {dev}, {blocks} query blocks ---")
    return row


# cheap-to-count archs first so partial sweeps cover the most cells
_SWEEP_ORDER = [
    "stablelm-1.6b", "mamba2-780m", "qwen2-moe-a2.7b", "musicgen-medium",
    "qwen2-7b", "recurrentgemma-9b", "qwen2.5-14b", "deepseek-67b",
    "qwen3-moe-235b-a22b", "llama-3.2-vision-90b",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"),
                    default="off")
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out (JSONL resume)")
    ap.add_argument("--no-probes", action="store_true",
                    help="argument bytes only (no roofline counts)")
    ap.add_argument("--fit-from", default=None,
                    help="JSONL from a prior sweep: reuse fit decisions")
    ap.add_argument("--device", default="cuda",
                    help="where --retrieval searches (default cuda)")
    ap.add_argument("--num-points", type=int, default=2 ** 30,
                    help="--retrieval's index rows over all shards")
    ap.add_argument("--seed", type=int, default=0,
                    help="--retrieval's data seed")
    ap.add_argument("--query-blocks", type=int, default=None,
                    help="--retrieval's query blocks (default: the fewest "
                         "whose bias fits)")
    args = ap.parse_args(argv)

    hints = {}
    if args.fit_from and os.path.exists(args.fit_from):
        with open(args.fit_from) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    hints[(r["arch"], r["shape"])] = r

    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    cells = []
    if args.all:
        for arch in _SWEEP_ORDER:
            for shape in SHAPES:
                cells.append((arch, shape))
    elif args.arch:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(args.arch, s) for s in shapes]

    done = set()
    rows = []
    if args.out and os.path.exists(args.out) and args.skip_done:
        with open(args.out) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    rows.append(r)
                    done.add((r["arch"], r["shape"], r["mesh"]))

    def record(row):
        rows.append(row)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")

    for multi_pod in pods:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        if args.retrieval and ("hybrid-retrieval-1b", "search_q128",
                               mesh_name) not in done:
            record(lower_retrieval(multi_pod=multi_pod,
                                   num_points=args.num_points,
                                   device=args.device, seed=args.seed,
                                   query_blocks=args.query_blocks))
        for arch, shape in cells:
            if (arch, shape, mesh_name) in done:
                continue
            try:
                record(lower_cell(arch, shape, multi_pod=multi_pod,
                                  probes=not args.no_probes,
                                  fit_hint=hints.get((arch, shape))))
            except Exception as e:  # a failure is a bug; record and continue
                traceback.print_exc()
                record({"arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "fail", "error": repr(e)})
            sys.stdout.flush()
    fails = [r for r in rows if r.get("status") == "fail"]
    print(f"\n{len(rows)} cells: "
          f"{sum(r.get('status') == 'ok' for r in rows)} ok, "
          f"{sum(r.get('status') == 'skip' for r in rows)} skip, "
          f"{len(fails)} fail")
    if fails:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
