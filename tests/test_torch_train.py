"""The port's training path against the JAX package's: ``Model.loss`` and
its grads on the six smoke configs of the LM zoo (dense, moe, ssm, hybrid,
vlm, audio), ``make_train_step`` at 1 and 4 microbatches, and six steps of
``Trainer.run``, all at ``dtype="float32"``.

The reference's ``Model.init`` params (biases and norms perturbed) cross as
numpy through ``interchange.model_params_from_numpy``; the port's grads
come back through ``model_params_to_numpy``.  In f32: loss, nll, aux and
zloss within rtol 1e-5; grads within rtol 1e-4 / atol 1e-5 (f32 sums in
another order through the backward pass); a train step's params within
rtol 1e-5 / atol 1e-6; the trainer's losses within 1e-4.  The loss runs in
two sequence chunks (``loss_chunk`` 8 of S = 16), each checkpointed; with
``remat`` each repeat of the pattern is checkpointed, and is held bit for
bit to the run without it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_helpers import perturbed
from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batch as ref_batch
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_init
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.interchange import (model_params_from_numpy,
                                     model_params_to_numpy)
from repro_torch.models import Model
from repro_torch.models.layout import flatten, unflatten
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import Trainer, TrainerConfig, make_train_step

ARCHS = ["stablelm-1.6b-smoke", "qwen2-moe-a2.7b-smoke", "mamba2-780m-smoke",
         "recurrentgemma-9b-smoke", "llama-3.2-vision-90b-smoke",
         "musicgen-medium-smoke"]
B, S, CHUNK = 2, 16, 8
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _batch(cfg, seed=1):
    """Seeded numpy inputs of the config's frontend, ``cond`` where it
    attends over one, and labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.num_cond_tokens:
        out["cond"] = rng.standard_normal(
            (B, cfg.num_cond_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def _port_loss_and_grads(m, params, batch):
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    loss, metrics = m.loss(unflatten(params, leaves),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(params, grads)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reference's f32 loss, metrics and grads on its own perturbed
    params, in two loss chunks; and the port's on the same params."""
    arch = request.param
    cfg = dataclasses.replace(ref_config(arch), dtype="float32",
                              loss_chunk=CHUNK)
    m = RefModel(cfg)
    params = perturbed(jax.jit(m.init)(jax.random.PRNGKey(0)), len(arch))
    batch = _batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        m.loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, batch))
    pcfg = dataclasses.replace(get_config(arch), dtype="float32",
                               loss_chunk=CHUNK)
    pm = Model(pcfg)
    got = _port_loss_and_grads(
        pm, model_params_from_numpy(params, pcfg, device="cpu"), batch)
    want = (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))
    return arch, params, batch, got, want


def test_loss_matches_reference(case):
    _, _, _, (loss, metrics, _), (want_loss, want_metrics, _) = case
    assert set(metrics) == {"nll", "aux", "zloss"}
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for k, w in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=LOSS_RTOL,
                                   atol=1e-7 if k == "aux" else 0, err_msg=k)


def test_grads_match_reference(case):
    _, _, _, (_, _, grads), (_, _, want) = case
    got = model_params_to_numpy(grads)
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (path, g), (_, w) in zip(got_flat, want_flat):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["stablelm-1.6b-smoke",
                                  "qwen2-moe-a2.7b-smoke",
                                  "recurrentgemma-9b-smoke"])
def test_chunks_and_remat_change_no_bit(arch):
    """One chunk against two (each checkpointed), and ``remat`` off against
    on (each repeat of the pattern checkpointed): loss and every grad bit
    for bit."""
    base = dataclasses.replace(get_config(arch), dtype="float32")
    params = Model(base).init(3, device="cpu")
    batch = _batch(base, seed=4)
    runs = {}
    for name, changes in (("plain", dict(remat=False, loss_chunk=S)),
                          ("remat", dict(remat=True, loss_chunk=S)),
                          ("chunks", dict(remat=False, loss_chunk=CHUNK)),
                          ("both", dict(remat=True, loss_chunk=CHUNK))):
        m = Model(dataclasses.replace(base, **changes))
        runs[name] = _port_loss_and_grads(m, params, batch)
    for name, base_name in (("remat", "plain"), ("both", "chunks")):
        got, want = runs[name], runs[base_name]
        assert torch.equal(got[0], want[0]), name
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), (name, k)
        for g, w in zip(flatten(got[2]), flatten(want[2])):
            assert torch.equal(g, w), name
    # chunked sums add in another order: equal to f32 rounding
    torch.testing.assert_close(runs["chunks"][0], runs["plain"][0],
                               rtol=1e-6, atol=0)
    for g, w in zip(flatten(runs["chunks"][2]), flatten(runs["plain"][2])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-8)


def test_loss_in_bf16_is_finite_and_close():
    """At the config's own bf16 compute dtype: the f32 logits' loss within
    2e-2 of the f32 run's (the reference's bf16 rule is 3e-2 relative on
    logits)."""
    arch = "stablelm-1.6b-smoke"
    cfg = get_config(arch)
    params = Model(cfg).init(5, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        bf, _ = Model(cfg).loss(params, batch)
        f32, _ = Model(dataclasses.replace(cfg, dtype="float32")).loss(
            params, batch)
    assert bf.dtype == torch.float32 and torch.isfinite(bf)
    assert abs(float(bf) - float(f32)) < 2e-2 * abs(float(f32))


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b-smoke"
STEP_OPT = dict(warmup_steps=0, decay_steps=10)


@pytest.fixture(scope="module")
def step_case():
    """The reference's jitted train step at 1 and 4 microbatches from its
    own init params, on synthetic batch 0 (B = 8, S = 16)."""
    cfg = dataclasses.replace(ref_config(TRAIN_ARCH), dtype="float32")
    m = RefModel(cfg)
    params = jax.tree.map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(0)))
    ocfg = RefAdamWConfig(**STEP_OPT)
    dcfg = RefDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=8)
    batch = jax.tree.map(np.asarray, ref_batch(dcfg, 0))
    out = {}
    for mb in (1, 4):
        jp = jax.tree.map(jnp.asarray, params)
        p, _, metrics = jax.jit(ref_make_train_step(m, ocfg, mb))(
            jp, ref_init(jp, ocfg), jax.tree.map(jnp.asarray, batch))
        out[mb] = (jax.tree.map(np.asarray, p),
                   {k: float(v) for k, v in metrics.items()})
    return params, batch, out


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(step_case, microbatches):
    params, batch, out = step_case
    want_params, want_metrics = out[microbatches]
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    p = model_params_from_numpy(params, cfg, device="cpu")
    ocfg = AdamWConfig(**STEP_OPT)
    step = make_train_step(Model(cfg), ocfg, microbatches)
    p, opt, metrics = step(p, adamw_init(p, ocfg),
                           {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert set(metrics) == set(want_metrics)
    for k, w in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert int(opt["step"]) == 1
    for g, w in zip(jax.tree.leaves(model_params_to_numpy(p)),
                    jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_microbatch_equivalence():
    """1 vs 4 microbatches in the port: the reference's own bounds (params
    within 5e-3, nll within 5e-2), and much closer in fact."""
    cfg = get_config(TRAIN_ARCH)
    m = Model(cfg)
    ocfg = AdamWConfig(**STEP_OPT)
    from repro_torch.data.pipeline import synthetic_batch
    batch = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=8), 0, device="cpu")
    runs = []
    for mb in (1, 4):
        p = m.init(0, device="cpu")
        p, _, metrics = make_train_step(m, ocfg, mb)(p, adamw_init(p, ocfg),
                                                     batch)
        runs.append((p, metrics))
    d = max(float((a - b).abs().max())
            for a, b in zip(flatten(runs[0][0]), flatten(runs[1][0])))
    assert d < 5e-3
    assert abs(float(runs[0][1]["nll"]) - float(runs[1][1]["nll"])) < 1e-5


def test_microbatches_must_divide_the_batch():
    cfg = get_config(TRAIN_ARCH)
    m = Model(cfg)
    p = m.init(0, device="cpu")
    batch = {"tokens": torch.zeros((6, 8), dtype=torch.int32),
             "labels": torch.zeros((6, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(m, AdamWConfig(), 4).grads(p, batch)


def test_cast_params_bf16_casts_by_the_stacked_rank():
    """``cast_params_bf16``: every leaf under ``blocks`` is cast (a block's
    norms included), ``final_norm`` is not; grads still arrive in f32."""
    cfg = get_config(TRAIN_ARCH)
    m = Model(cfg)
    seen = {}

    class Spy(Model):
        def loss(self, params, batch):
            seen["block_norm"] = params["blocks"][0][0]["ln1"]["scale"].dtype
            seen["final_norm"] = params["final_norm"]["scale"].dtype
            seen["head"] = params["lm_head"].dtype
            return super().loss(params, batch)

    p = m.init(0, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.ones((2, 8), dtype=torch.int32)}
    grads, _ = make_train_step(Spy(cfg), AdamWConfig(),
                               cast_params_bf16=True).grads(p, batch)
    assert seen == {"block_norm": torch.bfloat16,
                    "final_norm": torch.float32, "head": torch.bfloat16}
    assert all(g.dtype == torch.float32 for g in flatten(grads))


TRAIN_OPT = dict(warmup_steps=2, decay_steps=20, lr_peak=3e-3)


def test_trainer_matches_reference(tmp_path):
    """Six steps of ``Trainer.run`` from the reference's init params (the
    port's ``Model.init`` returns them), on the same synthetic stream
    (batches equal bit for bit): every step's loss within 1e-4."""
    cfg = dataclasses.replace(ref_config(TRAIN_ARCH), dtype="float32")
    rm = RefModel(cfg)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    rt = RefTrainer(rm, RefAdamWConfig(**TRAIN_OPT), RefDataConfig(**dkw),
                    RefTrainerConfig(num_steps=6, ckpt_every=1000,
                                     ckpt_dir=str(tmp_path / "ref"),
                                     log_every=1000))
    key = jax.random.PRNGKey(0)
    init = jax.tree.map(np.asarray, rm.init(key))
    _, _, want = rt.run(key)

    pm = Model(dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32"))
    pm.init = lambda seed, device: model_params_from_numpy(init, pm.cfg,
                                                           device=device)
    pt = Trainer(pm, AdamWConfig(**TRAIN_OPT), DataConfig(**dkw),
                 TrainerConfig(num_steps=6, ckpt_every=1000,
                               ckpt_dir=str(tmp_path / "port"),
                               log_every=1000), device="cpu")
    _, opt, got = pt.run(0)
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(
        range(6))
    assert not any(h["skipped"] for h in got)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-4,
                               atol=1e-4)
    assert int(opt["step"]) == 6
    assert len(pt.step_times) == len(pt.opt_times) == 6
    assert all(h["sec"] > 0 for h in got)


def test_nonfinite_step_is_skipped(tmp_path):
    """A NaN loss at step 2 skips the update: the state after the run is
    the one a run without step 2's update reaches."""
    cfg = get_config(TRAIN_ARCH)

    class Poisoned(Model):
        calls = 0

        def loss(self, params, batch):
            loss, metrics = super().loss(params, batch)
            Poisoned.calls += 1
            if Poisoned.calls == 3:
                metrics = dict(metrics, nll=metrics["nll"] * float("nan"))
            return loss, metrics

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    tcfg = TrainerConfig(num_steps=4, ckpt_every=1000,
                         ckpt_dir=str(tmp_path), log_every=1000)
    tr = Trainer(Poisoned(cfg), AdamWConfig(**TRAIN_OPT), dcfg, tcfg,
                 device="cpu")
    params, opt, hist = tr.run(0)
    assert [h["skipped"] for h in hist] == [False, False, True, False]
    assert "sec" not in hist[2] and len(tr.step_times) == 4
    assert int(opt["step"]) == 3


def test_straggler_watchdog():
    cfg = get_config(TRAIN_ARCH)
    tr = Trainer(Model(cfg), AdamWConfig(),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                            global_batch=2),
                 TrainerConfig(straggler_factor=3.0), device="cpu")
    for step, dt in enumerate([1.0] * 6 + [3.5, 1.0, 2.9]):
        tr._clock({"step": step, "skipped": False}, dt, dt / 2)
    assert tr.straggler_steps == [6]


def test_trainer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config(TRAIN_ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Model(cfg), AdamWConfig(),
                DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                           global_batch=2), TrainerConfig())
