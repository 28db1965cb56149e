"""The port's AdamW (``repro_torch.optim``) against the JAX package's
(``repro.optim``): the schedule, the global norm and its clip, the int8
block quantizer, and one ``adamw_update`` on the stablelm-1.6b-smoke and
recurrentgemma-9b-smoke param trees (blocks and a tail) with f32, bf16 and
int8 moments, the params and grads carried across with
``interchange.model_params_from_numpy`` and the result carried back with
``model_params_to_numpy``.

Tolerances: f32 params and moments within rtol 1e-6 / atol 1e-7 (the port
may round ``b1 * m + (1 - b1) * g`` once where the reference rounds twice);
bf16 moments within one bf16 step (2**-7 relative at most), where a value
on a bf16 rounding boundary may land on either side; int8 ``q`` equal
except where the value before rounding lies within 1e-6 (relative) of a
half-integer, and at most 2 such elements a tree (0 were seen in these
cases).

Two traps of the reference's stacked layout are held on their own: weight
decay goes by the rank of the stacked leaf (a block's norm scale and bias
are decayed, ``final_norm`` and a tail layer's are not), and int8 moments
are quantized over the stacked leaf (a 256-block straddles two layers; a
leaf of fewer than 256 elements a layer is quantized when its stack holds
256)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_helpers import perturbed
from repro.checkpoint.checkpoint import _flatten_with_names
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.interchange import (model_params_from_numpy,
                                     model_params_to_numpy)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               global_norm)
from repro_torch.optim.adamw import _dequantize, _quantize

RTOL, ATOL = 1e-6, 1e-7
BF16_STEP = 2.0 ** -7          # one bf16 step, relative, at most
MAX_BOUNDARY_FLIPS = 2


def _np(tree):
    """A port tree (moments in the reference's layout) as numpy, bf16 read
    as f32."""
    def leaf(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return jax.tree.map(leaf, tree)


# ---------------------------------------------------------------------------
# schedule, norm, clip, quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(),
                                dict(lr_peak=1e-3, lr_min=1e-4,
                                     warmup_steps=10, decay_steps=100),
                                dict(warmup_steps=0, decay_steps=1)],
                         ids=["default", "short", "no-warmup"])
def test_cosine_schedule_matches_reference(kw):
    steps = np.array([0, 1, 5, 10, 11, 50, 99, 100, 101, 200, 10000, 20000],
                     np.int32)
    got = cosine_schedule(AdamWConfig(**kw), torch.from_numpy(steps))
    want = ref_adamw.cosine_schedule(RefAdamWConfig(**kw),
                                     jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((7, 5))).astype(np.float32),
            "b": [{"c": (scale * rng.standard_normal(300)).astype(
                np.float32)}],
            "d": np.float32(scale) * np.ones((3,), np.float32)}


@pytest.mark.parametrize("max_norm", [1.0, 1e3], ids=["clips", "passes"])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _tree(0)
    got_tree, got_norm = clip_by_global_norm(
        jax.tree.map(torch.from_numpy, tree), max_norm)
    want_tree, want_norm = ref_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=RTOL)
    np.testing.assert_allclose(
        float(global_norm(jax.tree.map(torch.from_numpy, tree))),
        float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=RTOL)
    for g, w in zip(jax.tree.leaves(_np(got_tree)),
                    jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1000,), (256,), (7, 300), (2, 3, 100)])
def test_quantize_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:5] = 0.0
    q, s = _quantize(torch.from_numpy(x), 256)
    rq, rs = ref_adamw._quantize(jnp.asarray(x), 256)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q.dtype == torch.int8 and q.shape == rq.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    back = _dequantize(q, s, shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        ref_adamw._dequantize(rq, rs, shape)))
    assert np.abs(back.numpy() - x).max() < np.abs(x).max() / 100


# ---------------------------------------------------------------------------
# one update on the LM trees
# ---------------------------------------------------------------------------

MOMENTS = {"f32": dict(), "bf16": dict(moment_dtype="bfloat16"),
           "int8": dict(quantize_moments=True)}
OPT = dict(warmup_steps=2, decay_steps=10, lr_peak=1e-2, lr_min=1e-3)


def _grads(params, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (scale * rng.standard_normal(
        np.shape(x))).astype(np.float32), params)


def _prerounded(params_np, grads_np, ocfg):
    """The reference's f32 first moments after one step (the values its
    int8 quantizer rounds), by name: (m, v) flattened, block by block
    divided by their scale."""
    f32 = RefAdamWConfig(**{**dataclasses.asdict(ocfg),
                            "quantize_moments": False})
    jp = jax.tree.map(jnp.asarray, params_np)
    _, st, _ = ref_update(jp, jax.tree.map(jnp.asarray, grads_np),
                          ref_init(jp, f32), f32)
    out = {}
    for name, x in _flatten_with_names({"m": st["m"], "v": st["v"]}).items():
        flat = np.asarray(x, np.float64).reshape(-1)
        if flat.size < ocfg.quant_block:
            continue
        flat = np.pad(flat, (0, (-flat.size) % ocfg.quant_block))
        blocks = flat.reshape(-1, ocfg.quant_block)
        scale = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
        out[name + "/q"] = blocks / np.maximum(scale, 1e-12)
    return out


def _compare(got: dict, want: dict, pre: dict | None = None) -> int:
    """Leaf by leaf under the module's tolerances; returns the int8 values
    that rounded the other way on a boundary."""
    assert list(got) == list(want)
    flips = 0
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        assert g.shape == w.shape, name
        if name.endswith("/q"):
            diff = g.astype(np.int32) - w.astype(np.int32)
            if diff.any():
                x = pre[name.replace("opt/", "")][diff != 0]
                near = np.abs(np.abs(x - np.floor(x)) - 0.5)
                assert (np.abs(diff) <= 1).all() and \
                    (near <= 1e-6 * np.maximum(np.abs(x), 1.0)).all(), name
                flips += int((diff != 0).sum())
        elif w.dtype == jnp.bfloat16:
            np.testing.assert_allclose(g, w.astype(np.float32),
                                       rtol=BF16_STEP, atol=1e-30,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    return flips


@pytest.mark.parametrize("moments", list(MOMENTS))
@pytest.mark.parametrize("arch", ["stablelm-1.6b-smoke",
                                  "recurrentgemma-9b-smoke"])
def test_adamw_update_matches_reference(arch, moments):
    m = RefModel(ref_config(arch))
    params = perturbed(jax.jit(m.init)(jax.random.PRNGKey(0)), 3)
    grads = _grads(params, 5)
    ocfg = RefAdamWConfig(**OPT, **MOMENTS[moments])
    jp = jax.tree.map(jnp.asarray, params)
    jp, st, met = ref_update(jp, jax.tree.map(jnp.asarray, grads),
                             ref_init(jp, ocfg), ocfg)
    cfg = get_config(arch)
    tp = model_params_from_numpy(params, cfg, device="cpu")
    pcfg = AdamWConfig(**OPT, **MOMENTS[moments])
    tp, ts, tmet = adamw_update(
        tp, model_params_from_numpy(grads, cfg, device="cpu"),
        adamw_init(tp, pcfg), pcfg)
    got = _flatten_with_names({"params": model_params_to_numpy(tp),
                               "opt": _np(ts)})
    want = _flatten_with_names({"params": jp, "opt": st})
    pre = _prerounded(params, grads, ocfg) if moments == "int8" else None
    assert _compare(got, want, pre) <= MAX_BOUNDARY_FLIPS
    assert int(tmet["step"]) == int(met["step"]) == 1
    np.testing.assert_allclose(float(tmet["lr"]), float(met["lr"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(met["grad_norm"]), rtol=RTOL)


def test_two_updates_match_reference():
    """A second step: non-zero moments in, bias corrections at step 2, the
    clip active (grads of norm ~30 against clip_norm 1)."""
    arch = "stablelm-1.6b-smoke"
    m = RefModel(ref_config(arch))
    params = perturbed(jax.jit(m.init)(jax.random.PRNGKey(1)), 4)
    ocfg = RefAdamWConfig(**OPT)
    pcfg = AdamWConfig(**OPT)
    cfg = get_config(arch)
    jp = jax.tree.map(jnp.asarray, params)
    st = ref_init(jp, ocfg)
    tp = model_params_from_numpy(params, cfg, device="cpu")
    ts = adamw_init(tp, pcfg)
    for seed in (6, 7):
        grads = _grads(params, seed, scale=0.2)
        jp, st, _ = ref_update(jp, jax.tree.map(jnp.asarray, grads), st,
                               ocfg)
        tp, ts, _ = adamw_update(
            tp, model_params_from_numpy(grads, cfg, device="cpu"), ts, pcfg)
    _compare(_flatten_with_names({"params": model_params_to_numpy(tp),
                                  "opt": _np(ts)}),
             _flatten_with_names({"params": jp, "opt": st}))


# ---------------------------------------------------------------------------
# the traps of the stacked layout
# ---------------------------------------------------------------------------

def test_decay_goes_by_the_stacked_rank():
    """Zero grads, so the update is decay alone: p * (1 - lr * wd) where the
    reference leaf has rank >= 2.  recurrentgemma-9b-smoke's block norms
    ((d,) a layer, (R, d) stacked) are decayed; ``final_norm`` and the two
    tail layers' norms and biases are not.  A rule on the port's per-layer
    rank would leave the block norms as they were."""
    arch = "recurrentgemma-9b-smoke"
    m = RefModel(ref_config(arch))
    params = perturbed(jax.jit(m.init)(jax.random.PRNGKey(0)), 3)
    zeros = jax.tree.map(np.zeros_like, params)
    kw = dict(OPT)                  # step 1: lr = lr_peak / 2, wd = 0.1
    jp, _, _ = ref_update(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, zeros), ref_init(
                              jax.tree.map(jnp.asarray, params),
                              RefAdamWConfig(**kw)), RefAdamWConfig(**kw))
    cfg = get_config(arch)
    tp = model_params_from_numpy(params, cfg, device="cpu")
    tp, _, _ = adamw_update(tp, model_params_from_numpy(zeros, cfg,
                                                        device="cpu"),
                            adamw_init(tp, AdamWConfig(**kw)),
                            AdamWConfig(**kw))
    got = model_params_to_numpy(tp)
    factor = 1.0 - OPT["lr_peak"] / 2 * 0.1
    np.testing.assert_allclose(got["blocks"][0]["ln1"]["scale"],
                               params["blocks"][0]["ln1"]["scale"] * factor,
                               rtol=RTOL)
    np.testing.assert_allclose(got["blocks"][0]["rec"]["ba"],
                               params["blocks"][0]["rec"]["ba"] * factor,
                               rtol=RTOL)
    assert not np.array_equal(got["blocks"][0]["ln1"]["scale"],
                              params["blocks"][0]["ln1"]["scale"])
    np.testing.assert_array_equal(got["final_norm"]["scale"],
                                  params["final_norm"]["scale"])
    for i in range(len(params["tail"])):
        for name in ("ln1", "ln2"):
            np.testing.assert_array_equal(got["tail"][i][name]["scale"],
                                          params["tail"][i][name]["scale"])
        np.testing.assert_array_equal(got["tail"][i]["rec"]["ba"],
                                      params["tail"][i]["rec"]["ba"])
    np.testing.assert_allclose(got["tail"][0]["rec"]["wa"],
                               params["tail"][0]["rec"]["wa"] * factor,
                               rtol=RTOL)
    _compare(_flatten_with_names(got), _flatten_with_names(jp))


def test_int8_blocks_span_the_stack():
    """Two layers of (3, 100) and of (200,): stacked (2, 3, 100) is 600
    elements in three 256-blocks, the second straddling the layers; the
    stacked (2, 200) holds 400 >= 256 and is quantized though a layer
    holds 200.  Names, q and scales as the reference's, and block 1's
    scale is the max over both layers' parts."""
    rng = np.random.default_rng(0)
    layers = [{"w": rng.standard_normal((3, 100)).astype(np.float32),
               "b": rng.standard_normal(200).astype(np.float32)}
              for _ in range(2)]
    ref_params = {"blocks": [jax.tree.map(lambda *xs: np.stack(xs),
                                          *layers)], "tail": []}
    grads_layers = [jax.tree.map(lambda x: rng.standard_normal(
        x.shape).astype(np.float32), layer) for layer in layers]
    ref_grads = {"blocks": [jax.tree.map(lambda *xs: np.stack(xs),
                                         *grads_layers)], "tail": []}
    ocfg = RefAdamWConfig(**OPT, quantize_moments=True)
    jp = jax.tree.map(jnp.asarray, ref_params)
    jp, st, _ = ref_update(jp, jax.tree.map(jnp.asarray, ref_grads),
                           ref_init(jp, ocfg), ocfg)
    port = {"blocks": [jax.tree.map(torch.from_numpy, layers)], "tail": []}
    pgrads = {"blocks": [jax.tree.map(torch.from_numpy, grads_layers)],
              "tail": []}
    pcfg = AdamWConfig(**OPT, quantize_moments=True)
    port, ts, _ = adamw_update(port, pgrads, adamw_init(port, pcfg), pcfg)
    m_w = ts["m"]["blocks"][0]["w"]
    assert set(ts["m"]["blocks"][0]) == {"w", "b"}
    assert tuple(m_w["q"].shape) == (3, 256)
    assert tuple(ts["m"]["blocks"][0]["b"]["q"].shape) == (2, 256)
    g = np.concatenate([x["w"].reshape(-1) for x in grads_layers])
    gnorm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                        for x in jax.tree.leaves(grads_layers)))
    m_first = (1 - 0.9) * g * min(1.0, 1.0 / gnorm)
    np.testing.assert_allclose(float(m_w["scale"][1, 0]),
                               np.abs(m_first[256:512]).max() / 127.0,
                               rtol=1e-5)
    assert np.abs(m_first[256:300]).max() != np.abs(m_first[300:512]).max()
    got = _flatten_with_names({"params": model_params_to_numpy(port),
                               "opt": _np(ts)})
    want = _flatten_with_names({"params": jp, "opt": st})
    pre = _prerounded(ref_params, ref_grads, ocfg)
    assert _compare(got, want, pre) <= MAX_BOUNDARY_FLIPS
