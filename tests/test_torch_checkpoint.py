"""The port's training checkpoints (``repro_torch.checkpoint``) against the
JAX package's: the same on-disk layout, so each package restores the
other's.

A checkpoint of ``{"params", "opt"}`` after one optimizer update (f32,
int8 and bf16 moments) written by the port is restored by the reference,
and the reverse, leaf for leaf bit for bit; the names are the reference's
``_flatten_with_names`` and ``treedef.txt`` its ``str(treedef)``.  The
reference cannot read its own bf16 leaves back (``np.savez`` stores them as
raw ``|V2`` records, which ``jnp.asarray`` refuses), so bf16 is held in the
port only: it reads the reference's ``|V2`` bytes and writes the same.
Then the manifest, ``keep_last``, ``save_async`` / ``wait`` and a
``Trainer`` resumed at ``latest_step``, from its own checkpoint and from
one the reference's ``Trainer`` wrote."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_helpers import perturbed
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.checkpoint.checkpoint import _flatten_with_names
from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import _treedef
from repro_torch.checkpoint.checkpoint import \
    _flatten_with_names as port_names
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.interchange import model_params_from_numpy
from repro_torch.models import Model
from repro_torch.models.layout import flatten
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import Trainer, TrainerConfig

MOMENTS = {"f32": dict(), "int8": dict(quantize_moments=True),
           "bf16": dict(moment_dtype="bfloat16")}
OPT = dict(warmup_steps=2, decay_steps=10, lr_peak=1e-2)


def _is_bf16(a) -> bool:
    return a.dtype.kind == "V" or str(a.dtype) == "bfloat16"


def _bits(a) -> np.ndarray:
    """An array's raw bits (bf16 and ``|V2`` alike as int16)."""
    a = np.asarray(a)
    return a.view(np.int16) if _is_bf16(a) else a


def _disk_dtype(a) -> str:
    """The dtype ``np.savez`` records: bf16 as ``|V2``."""
    return "|V2" if _is_bf16(a) else a.dtype.str


@functools.lru_cache(maxsize=None)
def _trees(arch, moments):
    """The reference's and the port's {"params", "opt"} after one update on
    the same params and grads: (reference tree, port tree)."""
    m = RefModel(ref_config(arch))
    params = perturbed(jax.jit(m.init)(jax.random.PRNGKey(0)), 2)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda x: (0.01 * rng.standard_normal(
        np.shape(x))).astype(np.float32), params)
    ocfg = RefAdamWConfig(**OPT, **MOMENTS[moments])
    jp = jax.tree.map(jnp.asarray, params)
    jp, st, _ = ref_update(jp, jax.tree.map(jnp.asarray, grads),
                           ref_init(jp, ocfg), ocfg)
    cfg = get_config(arch)
    pcfg = AdamWConfig(**OPT, **MOMENTS[moments])
    tp = model_params_from_numpy(params, cfg, device="cpu")
    tp, ts, _ = adamw_update(tp, model_params_from_numpy(grads, cfg,
                                                         device="cpu"),
                             adamw_init(tp, pcfg), pcfg)
    return {"params": jp, "opt": st}, {"params": tp, "opt": ts}


@functools.lru_cache(maxsize=None)
def _like(arch, moments):
    """Fresh like-trees of both packages (init params, zero moments)."""
    m = RefModel(ref_config(arch))
    jp = m.init(jax.random.PRNGKey(9))
    tp = Model(get_config(arch)).init(9, device="cpu")
    return ({"params": jp, "opt": ref_init(jp, RefAdamWConfig(
        **OPT, **MOMENTS[moments]))},
            {"params": tp, "opt": adamw_init(tp, AdamWConfig(
                **OPT, **MOMENTS[moments]))})


CASES = [("stablelm-1.6b-smoke", m) for m in MOMENTS] + [
    ("recurrentgemma-9b-smoke", "f32")]


@pytest.mark.parametrize("arch,moments", CASES)
def test_names_and_treedef_are_the_reference(arch, moments):
    ref_tree, port_tree = _trees(arch, moments)
    want = _flatten_with_names(ref_tree)
    got = port_names(port_tree)
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert _disk_dtype(got[name]) == _disk_dtype(want[name]), name
    assert "opt/step" in got and got["opt/step"].dtype == np.int32
    if moments == "int8":
        assert "opt/m/blocks/0/attn/wq/q" in got
        assert "opt/m/blocks/0/attn/wq/scale" in got
    assert _treedef(port_tree) == str(jax.tree_util.tree_structure(
        ref_tree))


@pytest.mark.parametrize("arch,moments",
                         [c for c in CASES if c[1] != "bf16"])
def test_port_checkpoint_restores_in_reference(tmp_path, arch, moments):
    _, port_tree = _trees(arch, moments)
    save_checkpoint(str(tmp_path), 3, port_tree)
    ref_like, _ = _like(arch, moments)
    got = ref_restore(str(tmp_path), 3, ref_like)
    want = port_names(port_tree)
    for name, arr in _flatten_with_names(got).items():
        np.testing.assert_array_equal(arr, want[name], err_msg=name)


@pytest.mark.parametrize("arch,moments", CASES)
def test_reference_checkpoint_restores_in_port(tmp_path, arch, moments):
    ref_tree, _ = _trees(arch, moments)
    ref_save(str(tmp_path), 4, ref_tree)
    _, port_like = _like(arch, moments)
    got = restore_checkpoint(str(tmp_path), 4, port_like)
    assert [t.dtype for t in flatten(got)] == [
        t.dtype for t in flatten(port_like)]
    want = _flatten_with_names(ref_tree)
    for name, arr in port_names(got).items():
        np.testing.assert_array_equal(_bits(arr), _bits(want[name]),
                                      err_msg=name)
    # the per-layer params come back unstacked, repeat by repeat
    wq = np.asarray(ref_tree["params"]["blocks"][0][
        "attn" if "stablelm" in arch else "rec"][
        "wq" if "stablelm" in arch else "wa"])
    layers = got["params"]["blocks"][0]
    key = ("attn", "wq") if "stablelm" in arch else ("rec", "wa")
    for r, layer in enumerate(layers):
        np.testing.assert_array_equal(layer[key[0]][key[1]].numpy(), wq[r])


def test_bf16_moments_round_trip_as_v2(tmp_path):
    """The port writes bf16 as the reference does, as raw ``|V2`` records,
    and reads its own back bit for bit."""
    ref_tree, port_tree = _trees("stablelm-1.6b-smoke", "bf16")
    save_checkpoint(str(tmp_path / "port"), 1, port_tree)
    ref_save(str(tmp_path / "ref"), 1, ref_tree)
    got = np.load(str(tmp_path / "port" / "step_1" / "arrays.npz"))
    want = np.load(str(tmp_path / "ref" / "step_1" / "arrays.npz"))
    name = "opt/m/blocks/0/attn/wq"
    assert got[name].dtype.str == want[name].dtype.str == "|V2"
    _, port_like = _like("stablelm-1.6b-smoke", "bf16")
    back = restore_checkpoint(str(tmp_path / "port"), 1, port_like)
    want = port_names(port_tree)
    for name, arr in port_names(back).items():
        assert arr.dtype.str == want[name].dtype.str, name
        np.testing.assert_array_equal(_bits(arr), _bits(want[name]))
    assert back["opt"]["m"]["blocks"][0]["attn"]["wq"].dtype == \
        torch.bfloat16


def test_restore_places_leaves_on_device(tmp_path):
    _, port_tree = _trees("stablelm-1.6b-smoke", "f32")
    save_checkpoint(str(tmp_path), 2, port_tree)
    got = restore_checkpoint(str(tmp_path), 2, port_tree, device="cpu")
    assert all(t.device.type == "cpu" for t in flatten(got))
    with pytest.raises(KeyError, match="only one"):
        restore_checkpoint(str(tmp_path), 2, {"params": port_tree["params"]})


# ---------------------------------------------------------------------------
# manifest, garbage collection, async writes, resume
# ---------------------------------------------------------------------------

def test_manifest_and_keep_last(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    assert latest_step(str(tmp_path)) is None
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, tree, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "step_3",
                                            "step_4"]
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f) == {"latest_step": 4}
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path / "step_4")) == ["arrays.npz",
                                                       "treedef.txt"]
    got = restore_checkpoint(str(tmp_path), 4, tree)
    assert torch.equal(got["a"], tree["a"]) and got["a"].dtype == torch.int64
    assert ref_restore(str(tmp_path), 4, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tree))["b"]["c"].shape == (4,)


def test_save_async_snapshots_before_the_thread(tmp_path):
    tree = {"w": torch.zeros(1000)}
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    mgr.save_async(7, tree)
    tree["w"].add_(1.0)                # after the snapshot
    mgr.save_async(8, tree)
    mgr.wait()
    assert mgr._thread is None
    assert latest_step(str(tmp_path)) == 8
    assert float(restore_checkpoint(str(tmp_path), 7, tree)["w"].sum()) == 0
    assert float(restore_checkpoint(str(tmp_path), 8, tree)["w"].sum()) == 1000


def test_failed_async_write_raises_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, {"w": torch.zeros(3)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                          # the error is reported once


ARCH = "stablelm-1.6b-smoke"
TRAIN_OPT = dict(warmup_steps=2, decay_steps=20, lr_peak=3e-3)
DATA = dict(seq_len=16, global_batch=4)


def _port_trainer(ckpt_dir, steps, ckpt_every, model=None):
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    return Trainer(model or Model(cfg), AdamWConfig(**TRAIN_OPT),
                   DataConfig(vocab_size=cfg.vocab_size, **DATA),
                   TrainerConfig(num_steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=str(ckpt_dir), log_every=1000),
                   device="cpu")


def test_trainer_resumes_at_latest_step(tmp_path):
    """4 steps with a checkpoint every 2, then a fresh trainer resumes at 4
    and runs to 6: its steps 4 and 5 equal the uninterrupted run's bit for
    bit (the CPU is deterministic), as do the final params."""
    whole_p, _, whole = _port_trainer(tmp_path / "whole", 6, 1000).run(0)
    _, _, first = _port_trainer(tmp_path / "cut", 4, 2).run(0)
    assert latest_step(str(tmp_path / "cut")) == 4
    assert sorted(d for d in os.listdir(tmp_path / "cut")
                  if d.startswith("step_")) == ["step_2", "step_4"]
    resumed = _port_trainer(tmp_path / "cut", 6, 1000)
    params, opt, rest = resumed.run(0)
    assert [h["step"] for h in rest] == [4, 5]
    assert [h["loss"] for h in first + rest] == [h["loss"] for h in whole]
    assert int(opt["step"]) == 6
    for a, b in zip(flatten(params), flatten(whole_p)):
        assert torch.equal(a, b)


def test_port_resumes_the_reference_run(tmp_path):
    """The reference's Trainer writes steps 2 and 4; the port's resumes from
    its checkpoint at 4 and continues the same stream: steps 4 and 5 within
    1e-4 of the reference's uninterrupted run."""
    cfg = dataclasses.replace(ref_config(ARCH), dtype="float32")
    rm = RefModel(cfg)

    def ref_trainer(d, steps, every):
        return RefTrainer(rm, RefAdamWConfig(**TRAIN_OPT),
                          RefDataConfig(vocab_size=cfg.vocab_size, **DATA),
                          RefTrainerConfig(num_steps=steps, ckpt_every=every,
                                           ckpt_dir=str(d), log_every=1000))

    _, _, whole = ref_trainer(tmp_path / "whole", 6, 1000).run(
        jax.random.PRNGKey(0))
    ref_trainer(tmp_path / "cut", 4, 2).run(jax.random.PRNGKey(0))
    _, opt, rest = _port_trainer(tmp_path / "cut", 6, 1000).run(0)
    assert [h["step"] for h in rest] == [4, 5]
    np.testing.assert_allclose([h["loss"] for h in rest],
                               [h["loss"] for h in whole[4:]], rtol=1e-4,
                               atol=1e-4)
    assert int(opt["step"]) == 6
