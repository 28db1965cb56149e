"""The decode loop (``repro_torch.serve.serving``) on the other families
against the JAX package's: recurrentgemma-9b, mamba2-780m and
qwen2-moe-a2.7b smokes (at its own capacity_factor), and
llama-3.2-vision-90b with ``cond``.

At ``dtype="float32"``, both packages run the same params (the port's
seeded init, stacked into the reference's tree and carried back through
``interchange.model_params_from_numpy``): ``greedy_generate`` with the exact
head returns the reference's tokens here, and a decode loop through
``ServeSession.next_token`` with the reference's PQ head carried across
returns the tokens of the reference's ``greedy_generate(use_pq_head=True)``
in tests/test_torch_serving_families_pq.py.  ``_serving_params`` casts, at
bf16, exactly the leaves the reference casts where it uses them: the table
below lists the ones that stay f32, and a forward on the cast tree is the
forward on the f32 tree bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm_helpers import inputs, port, reference_generate
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serve import greedy_generate, serving

STEPS, MAX_LEN = 6, 48
ARCHS = ["recurrentgemma-9b-smoke", "mamba2-780m-smoke",
         "qwen2-moe-a2.7b-smoke", "llama-3.2-vision-90b-smoke"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference_generate(request.param, STEPS, MAX_LEN)


def test_greedy_exact_head_equals_reference(ref):
    m, p = port(ref["arch"], ref["params"])
    cond = None if ref["cond"] is None else torch.from_numpy(ref["cond"])
    got = greedy_generate(m, p, ref["prompt"], STEPS, MAX_LEN, cond=cond)
    assert got.dtype == torch.int32 and got.shape == (2, STEPS)
    np.testing.assert_array_equal(got.numpy(), ref["tokens"])


# (sub-dict, leaf) pairs of a layer that the reference reads in f32; every
# norm dict (ln1, ln2, lnx) and, outside the layers, embed and final_norm
# stay f32 too; every other leaf, and lm_head, goes to bf16
STAY_F32 = {("ssd", "a_log"), ("ssd", "dt_bias"), ("ssd", "norm"),
            ("rec", "lam")}
NORMS = ("ln1", "ln2", "lnx")


@pytest.mark.parametrize("arch", [
    "qwen2-moe-a2.7b-smoke", "qwen3-moe-235b-a22b-smoke",
    "mamba2-780m-smoke", "recurrentgemma-9b-smoke",
    "llama-3.2-vision-90b-smoke", "musicgen-medium-smoke"])
def test_serving_params_cast_the_references_leaves(arch):
    """At bf16, every leaf of every pattern position and of the tail has
    the dtype the table gives it; and the cast tree's forward (and decode
    step) is the f32 tree's bit for bit, as the reference casts at the
    point of use."""
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    m = Model(cfg)
    params = m.init(3, device="cpu")
    cast = serving._serving_params(params, cfg)
    assert cast["lm_head"].dtype == torch.bfloat16
    assert all(cast[k]["scale"].dtype == torch.float32
               for k in ("final_norm",))
    if "embed" in cast:
        assert cast["embed"].dtype == torch.float32
    seen = set()
    for _, layer in m.layers(cast):
        for sub, leaves in layer.items():
            for name, leaf in _leaves(leaves):
                f32 = sub in NORMS or (sub, name) in STAY_F32
                want = torch.float32 if f32 else torch.bfloat16
                assert leaf.dtype == want, (sub, name, leaf.dtype)
                seen.add((sub, name, f32))
    assert any(not f32 for *_, f32 in seen)
    inp = inputs(cfg, 8, seed=4)
    b = {("tokens" if cfg.frontend == "tokens" else "embeds"):
         torch.from_numpy(inp["seq"])}
    if "cond" in inp:
        b["cond"] = torch.from_numpy(inp["cond"])
    assert torch.equal(m.forward(cast, b)[0], m.forward(params, b)[0])
    step = (b["tokens"][:, -1] if cfg.frontend == "tokens"
            else b["embeds"][:, -1:])
    pre = {k: (v[:, :-1] if k != "cond" else v) for k, v in b.items()}
    got = m.decode_step(cast, m.prefill(cast, pre, 16)[1], step)[0]
    want = m.decode_step(params, m.prefill(params, pre, 16)[1], step)[0]
    assert torch.equal(got, want)


def _leaves(tree, prefix=""):
    """(leaf name, tensor) pairs of a sub-dict; a nested dict (the MoE's
    shared experts) names its leaves by their own keys."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, k)


def test_f32_configs_keep_their_tree():
    cfg = dataclasses.replace(get_config("mamba2-780m-smoke"),
                              dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    assert serving._serving_params(params, cfg) is params
