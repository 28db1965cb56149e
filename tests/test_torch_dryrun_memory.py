"""The dry run's memory proof: ``roofline.mem_of``'s live-set count on
analytic calls and on smoke steps (``meta`` against real CPU tensors),
``launch.dryrun.reckon_memory``'s per-device step against the step itself,
and the fit search of microbatches and moments against the JAX package's
``lower_cell`` on the same synthetic memory."""

import math
import types

import numpy as np
import pytest
import torch
from _torch_port_helpers import environ_kept
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import Model
from repro_torch.models.layout import flatten
from repro_torch.optim import adamw_init
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import ALLOC_BLOCK, MemCount, mem_of

with environ_kept():                    # it sets XLA_FLAGS to 512 devices
    from repro.launch import dryrun as ref_dryrun

N = 1000                                # f32: 4000 B, one 4096 B block
BLOCK = 4096
ONE = make_test_mesh((1, 1))


def _vec(device="cpu", grad=False):
    return torch.ones(N, device=device).requires_grad_(grad)


def test_mem_of_chain_view_in_place_alias():
    """Known peaks: ``((x * 2) + 1) * 3`` holds two new blocks at each op
    after the first; a view and an in-place op add nothing; an output that
    is an argument's storage is an alias."""
    assert mem_of(lambda x: ((x * 2) + 1) * 3, _vec()) == MemCount(
        temp=BLOCK, output=4 * N, alias=0, argument=4 * N)
    assert mem_of(lambda x: x.view(10, 100).t()[2:], _vec()) == MemCount(
        temp=0, output=4 * N, alias=4 * N, argument=4 * N)
    assert mem_of(lambda x: x.mul_(2), _vec()) == MemCount(
        temp=0, output=4 * N, alias=4 * N, argument=4 * N)
    assert mem_of(lambda x, y: (x.add_(y), x + y), _vec(), _vec()) == \
        MemCount(temp=0, output=8 * N, alias=4 * N, argument=8 * N)
    # a 4-byte result books one 512 B block of the live set
    assert mem_of(lambda x: (x * 2).sum(), _vec()) == MemCount(
        temp=BLOCK, output=4, alias=0, argument=4 * N)
    assert ALLOC_BLOCK == 512


LAYERS = 4


def _chain(x):
    h = x
    for _ in range(LAYERS):
        h = (h * 2).sin()
    return h


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_mem_of_saved_tensors_and_checkpoint(device):
    """``sin`` saves its input: recorded, the chain's L inputs stay live
    until the loss, (L + 2) blocks at the last op; unrecorded, three (the
    product, the old and the new value); under the non-reentrant
    checkpoint the forward saves nothing again."""
    def recorded(x):
        with torch.enable_grad():
            return _chain(x).sum()

    def unrecorded(x):
        with torch.no_grad():
            return _chain(x).sum()

    def checkpointed(x):
        with torch.enable_grad():
            return checkpoint(_chain, x, use_reentrant=False).sum()

    x = _vec(device, grad=True)
    want = {recorded: (LAYERS + 2) * BLOCK, unrecorded: 3 * BLOCK,
            checkpointed: 3 * BLOCK}
    for fn, peak in want.items():
        got = mem_of(fn, x)
        assert got == MemCount(temp=peak - ALLOC_BLOCK, output=4, alias=0,
                               argument=4 * N), fn.__name__


def _cpu_args(cfg, kind, b=4, s=64):
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)

    def ints(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32))
    if kind == "train":
        return params, adamw_init(params, dryrun.OPT_CFG), {
            "tokens": ints(b, s), "labels": ints(b, s)}
    return params, model.init_decode_state(params, b, s), ints(b)


@pytest.mark.parametrize("name,kind", [
    ("stablelm-1.6b-smoke", "train"), ("qwen2-moe-a2.7b-smoke", "train"),
    ("recurrentgemma-9b-smoke", "decode"), ("mamba2-780m-smoke", "decode")])
def test_smoke_step_meta_equals_cpu(name, kind):
    """A smoke step reckoned on ``meta`` is the same step's reckoning on
    real CPU tensors, to the byte."""
    cfg = get_config(name)
    cell = dryrun.build_cell(cfg, ShapeConfig("t", 64, 4, kind))
    meta = mem_of(cell.fn, *cell.args)
    cpu = mem_of(cell.fn, *_cpu_args(cfg, kind))
    assert meta == cpu
    assert meta.temp > 0 and (meta.alias > 0 or kind != "train")


def test_cycle_collection_changes_nothing(monkeypatch):
    """``mem_of`` holds the cycle collector off; a collection every 20 ops
    gives the same count on a smoke decode step: no storage of the step
    waits for one."""
    import gc

    from repro_torch.roofline import analysis

    cell = dryrun.build_cell(get_config("recurrentgemma-9b-smoke"),
                             ShapeConfig("t", 32, 4, "decode"))
    quiet = mem_of(cell.fn, *cell.args)
    plain = analysis._LiveMode.__torch_dispatch__
    ops = [0]

    def collecting(self, func, types_, args=(), kwargs=None):
        out = plain(self, func, types_, args, kwargs)
        ops[0] += 1
        if ops[0] % 20 == 0:
            gc.collect()
        return out

    monkeypatch.setattr(analysis._LiveMode, "__torch_dispatch__",
                        collecting)
    assert mem_of(cell.fn, *cell.args) == quiet and ops[0] > 100


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@pytest.mark.parametrize("name,kind", [
    ("stablelm-1.6b-smoke", "train"), ("qwen2-moe-a2.7b-smoke", "prefill"),
    ("recurrentgemma-9b-smoke", "decode")])
def test_one_device_step_is_the_step(name, kind):
    """On a one-device mesh the per-device step is the cell's own step:
    ``reckon_memory``'s temporaries and arguments are ``mem_of``'s of it,
    its output the result's leaves, and its alias each leaf that agrees in
    shape and dtype with the argument it replaces (params and moments
    written in place; a decode step's caches in place and its recurrent
    states in new buffers, as XLA reuses a donated buffer); the decode
    state's host index stands for the reference's 4-byte int32, an
    argument and, in a decode step, an alias.  On (2, 2) a device holds no
    more."""
    cfg = get_config(name)
    shape = ShapeConfig("t", 32, 4, kind)
    cell = dryrun.build_cell(cfg, shape)
    step = mem_of(cell.fn, *cell.args)
    one = dryrun.reckon_memory(cfg, shape, ONE)
    index = 0 if kind == "train" else 4
    result = flatten(step.result)
    alias = {"train": step.alias, "prefill": 0,
             "decode": 4 + sum(_nbytes(new) for new, old in zip(
                 flatten(step.result[1]), flatten(cell.args[1]))
                 if isinstance(new, torch.Tensor) and new.shape == old.shape
                 and new.dtype == old.dtype)}[kind]
    assert (one["mem_temp"], one["mem_argument"], one["mem_output"],
            one["mem_alias"]) == (
        step.temp, step.argument + (4 if kind == "decode" else 0),
        sum(_nbytes(t) for t in result if isinstance(t, torch.Tensor))
        + index, alias)
    if kind == "decode":                # the RG-LRU states: new buffers
        assert step.alias < alias - 4
    assert one["bytes_per_device"] == (one["mem_temp"] + one["mem_argument"]
                                       + one["mem_output"]
                                       - one["mem_alias"])
    four = dryrun.reckon_memory(cfg, shape, make_test_mesh((2, 2)))
    assert four["bytes_per_device"] <= one["bytes_per_device"]
    assert four["mem_argument"] < one["mem_argument"]


def test_shares_follow_the_weight():
    """A grad takes its weight's share, an activation of the weight's very
    shape does not: ``x @ w`` with x and w both (32, 32), its grad by
    autograd, two activations made beside the grad and an in-place foreach
    update of w; the grad counts a quarter of its 4096 B at the peak."""
    def step(w, x):
        with torch.enable_grad():
            a = w.detach().requires_grad_()
            g, = torch.autograd.grad((x @ a).sum(), a)
        h = (x * 2) + 1                 # the peak: two activations and g
        torch._foreach_add_([w], [g], alpha=-0.1)
        return w

    w, x = torch.ones(32, 32), torch.ones(32, 32)
    whole = mem_of(step, w.clone(), x)
    m = mem_of(step, w, x, shares=[(w, 0.25)])
    made = [(op, shape, f) for op, shape, _, f in m.storages if op]
    assert [(op, f) for op, shape, f in made if f is not None] == [
        ("aten.mm.default", 0.25)]
    assert sum(1 for op, shape, f in made
               if op == "aten.mm.default" and shape == (32, 32)) == 2
    assert whole.temp == 3 * 4096
    assert m.temp == whole.temp - (4096 - 1024)


def test_activations_keep_their_size():
    """A smoke train step at B x S = d, so that the hidden states, the q
    projections and the attention outputs have the numel of ``wq`` and
    ``wo`` and the logits that of the embedding: every storage that takes
    a parameter's share is a cast or copy, a foreach op's, an accumulation
    into a grad, or made of storages that hold no weight (a grad of
    activations); every product of an op that took a weight or its cast,
    other than those, keeps its whole size."""
    cfg = get_config("stablelm-1.6b-smoke")
    b, s = 4, cfg.d_model // 4
    cell = dryrun.build_cell(cfg, ShapeConfig("t", s, b, "train"))
    params = flatten(cell.args[0])
    numels = {p.numel() for p in params}
    assert b * s * cfg.d_model in numels
    m = mem_of(cell.fn, *cell.args, shares=[(p, 0.5) for p in params])
    copies = {"aten._to_copy.default", "aten.clone.default"}
    back = {str(op) for op in analysis._BACK}
    weight = {k for k, (op, _, ins, f) in enumerate(m.storages)
              if f is not None and (op is None or op in copies)}
    collide = 0
    for op, shape, ins, f in m.storages:
        if op is None or op in copies or op.startswith("aten._foreach_"):
            continue
        took_weight = any(i in weight for i in ins)
        if f is not None:
            assert op in back or not took_weight, (op, shape)
        elif took_weight and op not in back:
            collide += math.prod(shape) in numels
    assert collide >= 3 * cfg.num_layers
    scaled = [op for op, _, _, f in m.storages if op and f is not None]
    assert scaled.count("aten.mm.default") >= 4 * cfg.num_layers


def test_local_config_and_shape():
    """One device's widths and batch on the production mesh: qwen2-7b's 28
    heads in 4 kv groups take no cut (neither 4 nor 7 splits 16 ways),
    its MLP and vocabulary do; qwen3-moe's 128 experts split, its 4 of 64
    kv heads do not; the batch goes over data (x pod)."""
    mesh = dryrun.make_production_mesh()
    q = dryrun.local_config(get_config("qwen2-7b"), mesh)
    assert (q.num_heads, q.num_kv_heads, q.d_ff, q.vocab_size) == (
        28, 4, 18944 // 16, 152064 // 16)
    moe = get_config("qwen3-moe-235b-a22b")
    m = dryrun.local_config(moe, mesh)
    assert m.num_experts == moe.num_experts // 16
    assert m.resolved_head_dim == moe.resolved_head_dim
    ssm = dryrun.local_config(get_config("mamba2-780m"), mesh)
    assert ssm.ssm_expand * ssm.d_model == 3072 // 16
    assert dryrun.local_shape(dryrun.SHAPES["train_4k"], mesh
                              ).global_batch == 16
    assert dryrun.local_shape(
        dryrun.SHAPES["train_4k"],
        dryrun.make_production_mesh(multi_pod=True)).global_batch == 8
    assert dryrun.local_config(q, ONE) is q


def test_microbatches_cut_the_temporaries():
    """A train cell's temporaries at 2 microbatches are below those at 1,
    and a step of 4 is reckoned at its first two: the count of the whole
    4-microbatch step."""
    cfg = get_config("stablelm-1.6b-smoke")
    shape = ShapeConfig("t", 64, 4, "train")
    mb = {n: dryrun.reckon_memory(cfg, shape, ONE, microbatches=n)
          for n in (1, 2, 4)}
    assert mb[2]["mem_temp"] < mb[1]["mem_temp"]
    whole = dryrun.build_cell(cfg, shape, microbatches=4)
    assert mb[4]["mem_temp"] == mem_of(whole.fn, *whole.args).temp


# ---------------------------------------------------------------------------
# the fit search against the reference's, on one synthetic memory function
# ---------------------------------------------------------------------------

GIB = 2 ** 30
FIT = ref_dryrun.HBM_FIT


def _synthetic(fixed_f32, fixed_bf16, act):
    """bytes a device at (microbatches, moments): fixed + act / mb."""
    def mem(mb, moments):
        fixed = fixed_f32 if moments == "float32" else fixed_bf16
        return int((fixed + act / mb) * FIT)
    return mem


CASES = {
    "fits_at_1": (_synthetic(0.5, 0.4, 0.3), 1, "float32", True),
    "two_sample_jump": (_synthetic(0.5, 0.4, 4.0), 8, "float32", True),
    "bf16_at_the_cap": (_synthetic(1.2, 0.8, 1.0), 16, "bfloat16", True),
    "never_fits": (_synthetic(3.0, 2.0, 1.0), 16, "bfloat16", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_search_equals_reference(case, monkeypatch):
    """Both packages' ``lower_cell`` over the same synthetic memory: the
    reference's compile, memory analysis and mesh stubbed, the port's
    ``reckon_memory``; the port's limits set to the reference's.  Equal
    microbatches, moments, fit and bytes."""
    mem, want_mb, want_moments, want_fits = CASES[case]
    calls = {"ref": [], "port": []}

    def lowered(cfg, shape, mesh, *, microbatches=1, opt_cfg=None):
        moments = (opt_cfg or ref_dryrun.OPT_CFG).moment_dtype
        calls["ref"].append((microbatches, moments))
        total = mem(microbatches, moments)
        analysis = types.SimpleNamespace(
            temp_size_in_bytes=total - GIB, argument_size_in_bytes=GIB,
            output_size_in_bytes=0, alias_size_in_bytes=0)
        compiled = types.SimpleNamespace(
            total=total, memory_analysis=lambda: analysis)
        return types.SimpleNamespace(compile=lambda: compiled)

    monkeypatch.setattr(ref_dryrun, "build_lowered", lowered)
    monkeypatch.setattr(ref_dryrun, "_mem_per_device", lambda c: c.total)
    monkeypatch.setattr(ref_dryrun, "make_production_mesh",
                        lambda multi_pod=False: types.SimpleNamespace(
                            shape={"data": 16, "model": 16}, size=256))

    def reckon(cfg, shape, mesh, *, microbatches=1, opt_cfg=None):
        moments = (opt_cfg or dryrun.OPT_CFG).moment_dtype
        calls["port"].append((microbatches, moments))
        total = mem(microbatches, moments)
        return {"mem_temp": total - GIB, "mem_argument": GIB,
                "mem_output": 0, "mem_alias": 0, "bytes_per_device": total}

    monkeypatch.setattr(dryrun, "reckon_memory", reckon)
    monkeypatch.setattr(dryrun, "HBM_FIT", ref_dryrun.HBM_FIT)
    monkeypatch.setattr(dryrun, "HBM_BYTES", ref_dryrun.HBM_BYTES)
    ref = ref_dryrun.lower_cell("stablelm-1.6b", "train_4k",
                                multi_pod=False, verbose=False, probes=False)
    port = dryrun.lower_cell("stablelm-1.6b", "train_4k", multi_pod=False,
                             verbose=False, probes=False)
    keys = ("microbatches", "opt_moments", "fits_hbm", "bytes_per_device")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert (port["microbatches"], port["opt_moments"], port["fits_hbm"]) \
        == (want_mb, want_moments, want_fits)
    assert calls["port"] == calls["ref"]
    assert port["mem_temp"] == ref["mem_temp"]
