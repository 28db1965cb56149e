"""What the LM zoo's port tests (tests/test_torch_models_families*.py,
tests/test_torch_models_hybrid_cross.py,
tests/test_torch_serving_families*.py) share: seeded inputs, the perturbed
reference params, and the walk of a reference tree (params or decode state,
each pattern position stacked over its repeats) in depth order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serve import greedy_generate as ref_generate
from repro.serve.hybrid_head import HybridLMHead as RefHead
from repro_torch.configs import get_config
from repro_torch.interchange import model_params_from_numpy
from repro_torch.models import Model

B = 2
S, MAX_LEN, STEPS = 32, 64, 4   # forward over S, prefill S - 1, 4 steps
RTOL = ATOL = 1e-4          # f32 against f32 in another summation order
BF16_REL = 3e-2             # the reference's decode-vs-forward bound
# leaves that init leaves constant: biases, norm scales, d_skip, dt_bias
NOISY = ("bq", "bk", "bv", "scale", "bias", "conv_b", "ba", "bx", "d_skip",
         "norm", "dt_bias")


def perturbed(params, seed):
    """A params tree as writable numpy, with seeded noise on ``NOISY``'s
    leaves so that every leaf matters."""
    rng = np.random.default_rng(seed)

    def walk(x, name=""):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, name) for v in x]
        a = np.array(x)
        if name in NOISY:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return walk(params)


def reference_tree(params):
    """The port's params (a list of per-layer dicts a pattern position) as
    the reference's numpy tree: each position's leaves stacked over its
    repeats."""
    def np_tree(t):
        return jax.tree.map(lambda x: x.numpy(), t)

    out = {k: np_tree(v) for k, v in params.items()
           if k not in ("blocks", "tail")}
    out["blocks"] = [jax.tree.map(lambda *xs: np.stack(xs),
                                  *[np_tree(p) for p in block])
                     for block in params["blocks"]]
    out["tail"] = [np_tree(p) for p in params["tail"]]
    return out


def inputs(cfg, length, seed=1):
    """Seeded numpy inputs: ``seq``, tokens (B, length) or embeds
    (B, length, D), and ``cond`` (B, Tc, D) for the cross-attention
    families."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        out = {"seq": rng.integers(0, cfg.vocab_size, (B, length)).astype(
            np.int32)}
    else:
        out = {"seq": rng.standard_normal((B, length, cfg.d_model)).astype(
            np.float32)}
    if cfg.num_cond_tokens:
        out["cond"] = rng.standard_normal(
            (B, cfg.num_cond_tokens, cfg.d_model)).astype(np.float32)
    return out


def batch(cfg, inp, stop, lib=np.asarray):
    """The first ``stop`` positions as a model batch, through ``lib``
    (``jnp.asarray`` or ``torch.from_numpy``)."""
    key = "tokens" if cfg.frontend == "tokens" else "embeds"
    out = {key: lib(inp["seq"][:, :stop])}
    if "cond" in inp:
        out["cond"] = lib(inp["cond"])
    return out


def step_input(cfg, inp, t):
    """The decode input at position t: (B,) tokens or (B, 1, D) embeds."""
    return (inp["seq"][:, t] if cfg.frontend == "tokens"
            else inp["seq"][:, t:t + 1])


def ref_layers(model, tree):
    """A reference params or state tree as per-layer numpy dicts in depth
    order (blocks unstacked repeat by repeat, then the tail)."""
    out = []
    for r in range(model.repeats):
        for pos in range(len(model.pattern)):
            out.append(jax.tree.map(lambda t: np.asarray(t)[r],
                                    tree["blocks"][pos]))
    return out + [jax.tree.map(np.asarray, t) for t in tree["tail"]]


def port(arch, params, dtype="float32", **changes):
    """The port's Model at ``arch`` with ``changes``, and the reference's
    numpy ``params`` carried across on the CPU."""
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **changes)
    return Model(cfg), model_params_from_numpy(params, cfg, device="cpu")


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)


def states_close(m, state, want_layers):
    """Every layer's decode state against the reference's, leaf by leaf
    (a local ring's positions exactly)."""
    got_layers = [st for _, st in m.layers(state)]
    assert len(got_layers) == len(want_layers) == m.cfg.num_layers
    for got, want in zip(got_layers, want_layers):
        assert set(got) == set(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, name
            if name == "pos":
                np.testing.assert_array_equal(got[name].numpy(), w)
            else:
                close(got[name], w)


def seeded(init, cfg, seed, **kw):
    """A layer's params from the port's own init on a seeded CPU generator,
    as writable numpy (the data both packages then run)."""
    tree = init(torch.Generator().manual_seed(seed), cfg, **kw)
    return jax.tree.map(lambda t: t.numpy().copy(), tree)


def reference_case(arch):
    """The JAX package's f32 forward over S positions, prefill over S - 1
    and STEPS decode steps after it, on its own init params (perturbed):
    (arch, numpy params, inputs, reference outputs)."""
    cfg = dataclasses.replace(ref_config(arch), dtype="float32")
    m = RefModel(cfg)
    params = perturbed(jax.jit(m.init)(jax.random.PRNGKey(0)), len(arch))
    jp = jax.tree.map(jnp.asarray, params)
    inp = inputs(cfg, S + STEPS - 1)
    logits, aux = jax.jit(m.forward)(jp, batch(cfg, inp, S, jnp.asarray))
    pre_logits, state = jax.jit(m.prefill, static_argnums=2)(
        jp, batch(cfg, inp, S - 1, jnp.asarray), MAX_LEN)
    pre_state = ref_layers(m, state)
    decode = jax.jit(m.decode_step)
    steps = []
    for t in range(S - 1, S - 1 + STEPS):
        lg, state = decode(jp, state, jnp.asarray(step_input(cfg, inp, t)))
        steps.append(np.asarray(lg))
    want = {"logits": np.asarray(logits), "aux": float(aux),
            "prefill": np.asarray(pre_logits), "prefill_state": pre_state,
            "steps": steps, "state": ref_layers(m, state),
            "index": int(state["index"])}
    return arch, params, inp, want


def reference_generate(arch, steps, max_len, pq=False, prompt=12):
    """The reference's greedy tokens at f32 over a seeded prompt (and cond)
    on the port's seeded init stacked into its tree: with ``pq``, through
    its PQ head, whose arrays come back too.  Returns a dict of numpy
    (``params`` in the reference's layout)."""
    cfg = dataclasses.replace(ref_config(arch), dtype="float32")
    m = RefModel(cfg)
    params = reference_tree(Model(cfg).init(5, device="cpu"))
    jp = jax.tree.map(jnp.asarray, params)
    inp = inputs(cfg, prompt, seed=2)
    cond = jnp.asarray(inp["cond"]) if "cond" in inp else None
    out = {"arch": arch, "params": params, "prompt": inp["seq"],
           "cond": inp.get("cond"),
           "tokens": np.asarray(ref_generate(
               m, jp, jnp.asarray(inp["seq"]), steps, max_len,
               use_pq_head=pq, cond=cond))}
    if pq:
        hp = RefHead(cfg).build(jp["lm_head"])
        out["head"] = {"centers": np.asarray(hp.codebooks.centers),
                       "codes": np.asarray(hp.codes),
                       "q": np.asarray(hp.residual.q),
                       "scale": np.asarray(hp.residual.scale),
                       "zero": np.asarray(hp.residual.zero),
                       "head": np.asarray(hp.head)}
    return out
