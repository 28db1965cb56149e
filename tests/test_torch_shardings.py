"""The port's specs (``repro_torch.models.shardings``, ``models.common``'s
``resolve_spec``) against the JAX package's, leaf by leaf, for all ten
archs on stand-in production meshes of (16, 16) and (2, 16, 16): the
reference over ``jax.eval_shape`` trees, the port over ``meta`` tensors.
And the arguments', outputs' and aliases' bytes a device against XLA's own
``memory_analysis`` of the reference's compiled steps on a (2, 2) mesh of
host devices."""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, SHAPES, get_config as ref_config
from repro.data.pipeline import input_specs_for_shape as ref_inputs
from repro.models import Model as RefModel
from repro.models import common as ref_common
from repro.models import shardings as ref_sh
from repro.optim import AdamWConfig as RefAdamW, adamw_init as ref_adamw_init
from repro_torch.configs import get_config
from repro_torch.data.pipeline import input_specs_for_shape
from repro_torch.launch.mesh import (LogicalMesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import Model, common, shardings
from repro_torch.optim import AdamWConfig, adamw_init

REPO = Path(__file__).resolve().parent.parent
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
MOMENTS = ("float32", "bfloat16", "int8")


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(the reference's params under eval_shape, the port's on meta)."""
    ref = jax.eval_shape(RefModel(ref_config(arch)).init,
                         jax.random.PRNGKey(0))
    return ref, Model(get_config(arch)).init(device="meta")


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(spec) for path, spec in flat}


def _port_flat(specs, like, path=()) -> dict:
    """The port's spec tree by reference leaf: a per-layer blocks position's
    specs, equal across its layers, gain the stacked axis's None."""
    if isinstance(specs, tuple):
        return {path: specs}
    if isinstance(specs, dict):
        out = {}
        for k in specs:
            out.update(_port_flat(specs[k], like[k], path + (k,)))
        return out
    out = {}
    for i, (s, x) in enumerate(zip(specs, like)):
        if path and path[-1] == "blocks" and isinstance(x, list):
            layers = [_port_flat(sl, xl, path + (i,))
                      for sl, xl in zip(s, x)]
            for key, spec in layers[0].items():
                assert all(lay[key] == spec for lay in layers), key
                out[key] = (None,) + spec
        else:
            out.update(_port_flat(s, x, path + (i,)))
    return out


def _moment_cfgs(moments):
    kw = {"quantize_moments": moments == "int8",
          "moment_dtype": "float32" if moments == "int8" else moments}
    return RefAdamW(**kw), AdamWConfig(**kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    ref, port = _trees(arch)
    for name, mesh in MESHES.items():
        want = _ref_flat(ref_sh.param_pspecs(ref, mesh))
        got = _port_flat(shardings.param_pspecs(port, mesh), port)
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_specs_equal_reference(arch):
    """tree_pspecs over AdamW state with f32, bf16 and int8 moments (the
    int8 blocks replicate as one spec for the {q, scale} pair)."""
    ref, port = _trees(arch)
    for moments in MOMENTS:
        rcfg, pcfg = _moment_cfgs(moments)
        ropt = jax.eval_shape(functools.partial(ref_adamw_init, cfg=rcfg),
                              ref)
        popt = adamw_init(port, pcfg)
        for name, mesh in MESHES.items():
            want = _ref_flat(ref_sh.tree_pspecs(ropt, mesh, ref))
            got = _port_flat(shardings.tree_pspecs(popt, mesh, port), popt)
            assert got == want, (arch, moments, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_batch_specs_equal_reference(arch):
    """state_pspecs of the decode state at decode_32k (``cond``'s K/V
    precomputed where the arch attends over one) and batch_pspecs of every
    shape's inputs."""
    ref, port = _trees(arch)
    rcfg, pcfg = ref_config(arch), get_config(arch)
    shape = SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    rcond = pcond = None
    if rcfg.num_cond_tokens:
        rcond = jax.ShapeDtypeStruct((b, rcfg.num_cond_tokens, rcfg.d_model),
                                     jax.numpy.bfloat16)
        pcond = torch.empty((b, pcfg.num_cond_tokens, pcfg.d_model),
                            dtype=torch.bfloat16, device="meta")
    rstate = jax.eval_shape(functools.partial(
        RefModel(rcfg).init_decode_state, batch_size=b, max_len=s), ref,
        cond=rcond)
    pstate = Model(pcfg).init_decode_state(port, b, s, cond=pcond)
    for name, mesh in MESHES.items():
        want = _ref_flat(ref_sh.state_pspecs(rstate, mesh))
        got = _port_flat(shardings.state_pspecs(pstate, mesh), pstate)
        assert got == want, (arch, name)
        for sname, sh in SHAPES.items():
            want = _ref_flat(ref_sh.batch_pspecs(ref_inputs(rcfg, sh), mesh))
            batch = input_specs_for_shape(pcfg, sh)
            got = _port_flat(shardings.batch_pspecs(batch, mesh), batch)
            assert got == want, (arch, sname, name)


RESOLVE_CASES = [
    # 28 heads on a 16-way model axis: demoted to replication
    (("heads", None), (28, 128)),
    # the tuple rule ("pod", "data") on a batch of 256, 8 and 2
    (("batch", "seq"), (256, 4096)),
    (("batch", "seq"), (8, 4096)),
    (("batch",), (2,)),
    # a freed axis claimed later: 28 heads give "model" up to mlp
    (("heads", "mlp"), (28, 4096)),
    (("kv_heads", "heads", None), (4, 7, 128)),
    (("vocab", "fsdp"), (152064, 3584)),
    (("expert", "fsdp", "mlp"), (60, 2048, 1408)),
    ((None, "kv_seq", "kv_heads", None), (128, 32768, 8, 128)),
    ((), ()),
]


@pytest.mark.parametrize("names,shape", RESOLVE_CASES)
def test_resolve_spec_cases(names, shape):
    for mesh in list(MESHES.values()) + [make_test_mesh((2, 2))]:
        want = tuple(ref_common.resolve_spec(
            mesh, ref_common.DEFAULT_RULES, names, shape))
        assert common.resolve_spec(mesh, common.DEFAULT_RULES, names,
                                   shape) == want
        assert common.logical_spec(mesh, shape, *names) == tuple(
            ref_common.logical_spec(mesh, shape, *names))
    mesh = MESHES["16x16"]
    assert common.resolve_spec(mesh, common.DEFAULT_RULES, ("heads",),
                               (28,)) == (None,)


def test_rules_context_and_mesh():
    mesh = make_production_mesh(multi_pod=True)
    assert (mesh.axis_names, mesh.shape, mesh.size) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    assert common.current_mesh() is None
    with common.sharding_rules(mesh, {"heads": None}):
        assert common.current_mesh() is mesh
        with common.sharding_rules(make_test_mesh()):
            assert common.current_mesh().shape == {"data": 2, "model": 2}
        assert common.current_mesh() is mesh
    assert common.current_mesh() is None
    with pytest.raises(ValueError):
        LogicalMesh(("data",), (2, 2))


def test_shard_shape_and_bytes():
    mesh = make_production_mesh(multi_pod=True)
    assert shardings.shard_shape((256, 4096, 32), (("pod", "data"), None,
                                                   "model"), mesh) == (
        8, 4096, 2)
    with pytest.raises(ValueError):
        shardings.shard_shape((30,), ("model",), mesh)
    tree = {"a": torch.empty((64, 32), device="meta"),
            "b": [torch.empty((16,), dtype=torch.bfloat16, device="meta")],
            "index": 3}
    specs = {"a": ("data", "model"), "b": [("model",)], "index": ()}
    assert shardings.bytes_per_device(tree, specs, mesh) == (
        4 * 4 * 2 + 2 * 1 + 4)


_XLA_CHILD = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    assert len(jax.devices()) == 4       # before the dryrun's 512 takes hold
    from repro.configs import ShapeConfig as RS, get_config as rget
    from repro.launch import dryrun as rdry
    from repro.launch.mesh import make_test_mesh as rmesh
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import build_cell, reckon_memory
    from repro_torch.launch.mesh import make_test_mesh

    def out_bytes(fn):
        c = jax.jit(fn).lower(jnp.ones(4)).compile()
        return int(c.memory_analysis().output_size_in_bytes)

    # XLA's output buffer of a tuple result holds an 8-byte entry a leaf
    table = [out_bytes(lambda x: x + 1), out_bytes(lambda x: (x + 1, x * 2))]
    out = []
    for arch, kind, s in json.loads(sys.argv[1]):
        compiled = rdry.build_lowered(rget(arch), RS("t", s, 4, kind),
                                      rmesh((2, 2))).compile()
        rmem = compiled.memory_analysis()
        shape = ShapeConfig("t", s, 4, kind)
        port = build_cell(get_config(arch), shape)
        mem = reckon_memory(get_config(arch), shape, make_test_mesh((2, 2)))
        out.append({"arch": arch, "kind": kind,
                    "argument": int(rmem.argument_size_in_bytes),
                    "output": int(rmem.output_size_in_bytes),
                    "alias": int(rmem.alias_size_in_bytes),
                    "temp": int(rmem.temp_size_in_bytes),
                    "leaves": len(jax.tree.leaves(compiled.out_info)),
                    "port_argument": port.bytes_per_device(
                        make_test_mesh((2, 2))), "port": mem})
    print(json.dumps({"table": table, "cells": out}))
""")

XLA_CELLS = [("stablelm-1.6b-smoke", "train", 32),
             ("qwen2-moe-a2.7b-smoke", "prefill", 64),
             ("recurrentgemma-9b-smoke", "decode", 64)]


@pytest.fixture(scope="module", autouse=True)
def xla_child():
    """The XLA child, started with the module so that its compiles run
    beside the spec tests."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _XLA_CHILD, json.dumps(XLA_CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "JAX_PLATFORMS": "cpu"})
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def xla_rows(xla_child):
    """The child's rows: XLA's memory analysis of the reference's compiled
    step and the port's reckoning of each cell on the (2, 2) mesh."""
    stdout, stderr = xla_child.communicate(timeout=300)
    assert xla_child.returncode == 0, stderr[-3000:]
    rows = json.loads(stdout.strip().splitlines()[-1])
    assert len(rows["cells"]) == len(XLA_CELLS)
    return rows


def test_argument_bytes_equal_xla(xla_rows):
    """A dense train, a MoE prefill and a hybrid decode cell (smoke
    configs, B = 4): the port's arguments' bytes a device on a (2, 2) mesh
    equal ``argument_size_in_bytes`` of the reference's compiled step."""
    for row in xla_rows["cells"]:
        assert row["port_argument"] == row["argument"] == \
            row["port"]["mem_argument"], row


def test_output_and_alias_bytes_equal_xla(xla_rows):
    """The same cells: the port's ``mem_output`` and ``mem_alias`` equal
    XLA's ``output_size_in_bytes`` and ``alias_size_in_bytes`` (the train
    step's params and moments written in place; the prefill's logits and
    new state; the decode step's caches and recurrent states in place, the
    local ring's slot positions a new buffer of another layout).  XLA's
    output adds the tuple's index table, 8 bytes a leaf (a two-leaf result
    of two f32[4] is 48 bytes, one f32[4] 16).  The temporaries are
    printed, not held: XLA fuses and reuses buffers that the eager step
    materialises."""
    one, two = xla_rows["table"]
    assert (one, two) == (16, 2 * 16 + 2 * 8)
    for row in xla_rows["cells"]:
        port = row["port"]
        assert port["mem_output"] + 8 * row["leaves"] == row["output"], row
        assert port["mem_alias"] == row["alias"], row
        print(f"{row['arch']} {row['kind']}: XLA temp {row['temp']}, "
              f"port mem_temp {port['mem_temp']}")
