"""The other families of the LM zoo (``repro_torch.models``: MoE, Mamba2 SSD,
RG-LRU with local attention, cross-attention) against the JAX package's, on
the six smoke configs qwen2-moe-a2.7b (shared experts, QKV bias),
qwen3-moe (no shared experts), mamba2-780m, recurrentgemma-9b (one
(rglru, rglru, lattn) repeat and two tail rglru layers), llama-3.2-vision
(self x 4 + self_cross, ``cond``) and musicgen-medium (the ``embeddings``
frontend, LayerNorm, ``cond``).

The JAX package's ``Model.init`` params, with the leaves that init leaves
constant (biases, norm scales, ``d_skip``, ``dt_bias``) replaced by seeded
noise, cross as numpy through ``interchange.model_params_from_numpy``; both
packages then run the same params on the same seeded inputs.  At
``dtype="float32"`` the port's forward (logits and the MoE aux), prefill
(logits and every layer's state), 4 decode steps (logits, then the state)
agree with the reference within rtol 1e-4 / atol 1e-4: f32 sums in another
order, and the RG-LRU scan pairs its terms in another order than the
reference's ``associative_scan``.  MoE configs keep their own
capacity_factor of 1.25, so the 32-token forward drops assignments, and the
same ones.  At bf16 the port is held to itself by the reference's
criterion, decode against forward within max-relative 3e-2.  The layers
are held one by one in tests/test_torch_models_families_layers.py."""

import numpy as np
import pytest
import torch

from _torch_lm_helpers import (BF16_REL, MAX_LEN, RTOL, STEPS, S, batch,
                               close, port, reference_case, states_close,
                               step_input)
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.interchange import model_params_from_numpy
from repro_torch.models import Model

# the MoE and SSM smokes; test_torch_models_hybrid_cross.py runs these
# tests on the other three
ARCHS = ["qwen2-moe-a2.7b-smoke", "qwen3-moe-235b-a22b-smoke",
         "mamba2-780m-smoke"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return reference_case(request.param)


def test_init_tree_matches_reference(case):
    """The port's own init and the carried tree: the reference's keys, its
    shapes per layer (a list a pattern position, one entry a repeat, and
    the tail), f32 leaves."""
    arch, params, _, _ = case
    cfg = get_config(arch)
    m = Model(cfg)
    ref_m = RefModel(ref_config(arch))
    assert m.pattern == ref_m.pattern and m.remainder == ref_m.remainder

    def layout(tree, unstack=False):
        if isinstance(tree, dict):
            return {k: layout(v, unstack) for k, v in tree.items()}
        return (tuple(tree.shape[1:] if unstack else tree.shape),
                str(tree.dtype).split(".")[-1])

    for got in (m.init(0, device="cpu"),
                model_params_from_numpy(params, cfg, device="cpu")):
        assert set(got) == set(params)
        for k in set(params) - {"blocks", "tail"}:
            assert layout(got[k]) == layout(params[k])
        assert len(got["blocks"]) == len(params["blocks"])
        for block, ref_block in zip(got["blocks"], params["blocks"]):
            assert len(block) == m.repeats
            for layer in block:
                assert layout(layer) == layout(ref_block, unstack=True)
        assert [layout(t) for t in got["tail"]] == [
            layout(t) for t in params["tail"]]


def test_forward_matches_reference(case):
    arch, params, inp, want = case
    m, p = port(arch, params)
    logits, aux = m.forward(p, batch(m.cfg, inp, S, torch.from_numpy))
    assert logits.dtype == torch.float32
    close(logits, want["logits"])
    np.testing.assert_allclose(float(aux), want["aux"], rtol=RTOL, atol=1e-7)
    assert (want["aux"] > 0) == (m.cfg.family == "moe")


def test_prefill_matches_reference(case):
    """Last-position logits and every layer's decode state: K/V caches,
    the local layer's ring (positions included), SSD conv + ssm states,
    RG-LRU conv + h, cross-attention K/V."""
    arch, params, inp, want = case
    m, p = port(arch, params)
    logits, state = m.prefill(p, batch(m.cfg, inp, S - 1, torch.from_numpy),
                              MAX_LEN)
    close(logits, want["prefill"])
    assert state["index"] == S - 1
    states_close(m, state, want["prefill_state"])


def test_decode_matches_reference(case):
    """4 decode steps after the prefill: each step's logits, then every
    layer's state."""
    arch, params, inp, want = case
    m, p = port(arch, params)
    _, state = m.prefill(p, batch(m.cfg, inp, S - 1, torch.from_numpy),
                         MAX_LEN)
    for i, t in enumerate(range(S - 1, S - 1 + STEPS)):
        logits, state = m.decode_step(
            p, state, torch.from_numpy(step_input(m.cfg, inp, t)))
        close(logits, want["steps"][i])
    assert state["index"] == want["index"] == S - 1 + STEPS
    states_close(m, state, want["state"])


def test_decode_matches_own_forward_bf16(case):
    """The reference's test_decode_matches_forward on the port at the
    config's own bf16 (MoE at capacity_factor 16, as there)."""
    arch, params, inp, _ = case
    extra = ({"capacity_factor": 16.0} if get_config(arch).family == "moe"
             else {})
    m, p = port(arch, params, dtype="bfloat16", **extra)
    full, _ = m.forward(p, batch(m.cfg, inp, S, torch.from_numpy))
    _, state = m.prefill(p, batch(m.cfg, inp, S - 1, torch.from_numpy),
                         MAX_LEN)
    got, _ = m.decode_step(p, state,
                           torch.from_numpy(step_input(m.cfg, inp, S - 1)))
    assert full.dtype == got.dtype == torch.bfloat16
    want = full[:, -1].float()
    rel = float((got.float() - want).abs().max() / want.abs().max())
    assert rel < BF16_REL, (arch, rel)


