"""The port's sharded searches (repro_torch.core.distributed) against the JAX
package's, on the CPU.

The port runs one row shard per entry of a device list; here the list is
``["cpu"] * S`` for S = 1, 2, 4, so no process group and no subprocess is
needed.  The reference runs its shard_map bodies in-process: its
``_pass1_local`` / ``_search3_local`` (local search, ``all_gather``,
``merge_topk``) under ``jax.vmap`` over the stacked shards with the mesh
axis as the vmap axis name, and its ``sharded_pass1_topk`` /
``sharded_three_pass_topk`` on a 1-device CPU mesh.  Scores are held
within rtol 1e-5, atol 1e-4 and ids tie-aware (``assert_topk_match``);
inside the port, the kernel backends give the same bits at every S."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import assert_topk_match

from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.launch.mesh import make_test_mesh
from repro_torch.core import distributed as dist
from repro_torch.core.engine import scatter_queries_compact
from repro_torch.kernels.ops import pack_codes

N, KPQ, L, Q, NQ, D_ACT, LM, DD, R = 4800, 8, 16, 4, 12, 48, 200, 16, 6
BACKENDS = ["ref", "cuda", "cuda-packed"]


@pytest.fixture(scope="module")
def data():
    """Random index arrays (a global inverted index, row ids in [0, N),
    pad N) and queries, as the reference's own sharded tests draw them."""
    rng = np.random.default_rng(5)
    rows = np.stack([np.sort(rng.choice(N, LM, replace=False))
                     for _ in range(D_ACT)]).astype(np.int32)
    rows[:, -20:] = N                                          # pad slots
    d = dict(
        codes=rng.integers(0, L, (N, KPQ)).astype(np.uint8),
        lut=rng.normal(size=(Q, KPQ, L)).astype(np.float32),
        inv_rows=rows,
        inv_vals=np.where(rows < N, rng.normal(size=(D_ACT, LM)),
                          0.0).astype(np.float32),
        res_q=rng.integers(-128, 128, (N, DD)).astype(np.int8),
        res_scale=rng.uniform(0.01, 0.1, DD).astype(np.float32),
        res_zero=rng.normal(size=DD).astype(np.float32),
        sres_cols=rng.integers(0, D_ACT, (N, R)).astype(np.int32),
        sres_vals=rng.normal(size=(N, R)).astype(np.float32),
        q_dims=np.stack([rng.choice(D_ACT, NQ, replace=False)
                         for _ in range(Q)]).astype(np.int32),
        q_vals=rng.normal(size=(Q, NQ)).astype(np.float32),
        q_dense=rng.normal(size=(Q, DD)).astype(np.float32))
    d["q_cols"] = scatter_queries_compact(
        torch.from_numpy(d["q_dims"]), torch.from_numpy(d["q_vals"]),
        D_ACT).numpy()
    return d


def _stacked(d, s_count):
    """The inverted index split into S equal row shards, each localized
    (ids relative to the shard, pad = its row count) and stacked:
    (S * d_active, L), as the reference's callers build it."""
    per = N // s_count
    rows, vals = d["inv_rows"], d["inv_vals"]
    parts_r, parts_v = [], []
    for s in range(s_count):
        inside = (rows >= s * per) & (rows < (s + 1) * per)
        parts_r.append(np.where(inside, rows - s * per, per))
        parts_v.append(np.where(inside, vals, 0.0))
    return (np.concatenate(parts_r).astype(np.int32),
            np.concatenate(parts_v).astype(np.float32))


def _codes(d, backend):
    return pack_codes(d["codes"]) if backend == "cuda-packed" else d["codes"]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _stack_rows(x, s_count):
    return jnp.asarray(x.reshape(s_count, -1, *x.shape[1:]))


def _jax_pass1(d, s_count, k):
    """The reference's shard body, every shard in-process under vmap."""
    inv_r, inv_v = _stacked(d, s_count)
    offs = jnp.asarray(np.arange(s_count, dtype=np.int32)[:, None]
                       * (N // s_count))
    body = functools.partial(jdist._pass1_local, k=k, axis="data",
                             backend=jengine.Backend.REF)
    s, i = jax.jit(jax.vmap(body, in_axes=(0, None, 0, 0, None, None, 0),
                            axis_name="data"))(
        _stack_rows(d["codes"], s_count), jnp.asarray(d["lut"]),
        _stack_rows(inv_r, s_count), _stack_rows(inv_v, s_count),
        jnp.asarray(d["q_dims"]), jnp.asarray(d["q_vals"]), offs)
    return np.asarray(s[0]), np.asarray(i[0])


def _jax_search3(d, s_count, h, alpha, beta):
    inv_r, inv_v = _stacked(d, s_count)
    offs = jnp.asarray(np.arange(s_count, dtype=np.int32)[:, None]
                       * (N // s_count))
    body = functools.partial(jdist._search3_local, h=h, alpha=alpha,
                             beta=beta, axis="data",
                             backend=jengine.Backend.REF)
    rows = functools.partial(_stack_rows, s_count=s_count)
    s, i = jax.jit(jax.vmap(body, in_axes=(0, None, 0, 0, 0, None, None, 0,
                                           0, None, None, None, None, 0),
                            axis_name="data"))(
        rows(d["codes"]), jnp.asarray(d["lut"]), rows(inv_r), rows(inv_v),
        rows(d["res_q"]), jnp.asarray(d["res_scale"]),
        jnp.asarray(d["res_zero"]), rows(d["sres_cols"]),
        rows(d["sres_vals"]), jnp.asarray(d["q_dims"]),
        jnp.asarray(d["q_vals"]), jnp.asarray(d["q_dense"]),
        jnp.asarray(d["q_cols"]), offs)
    return np.asarray(s[0]), np.asarray(i[0])


@pytest.fixture(scope="module")
def jax_ref(data):
    """The reference's results, each computed once per module."""
    cache = {}

    def get(fn, *args):
        if (fn, args) not in cache:
            cache[fn, args] = fn(data, *args)
        return cache[fn, args]
    return get


def _port_pass1(d, s_count, k, backend):
    inv_r, inv_v = _stacked(d, s_count)
    return dist.sharded_pass1_topk(
        ["cpu"] * s_count, *_t(_codes(d, backend), d["lut"], inv_r, inv_v,
                               d["q_dims"], d["q_vals"]), k=k, adc=backend)


def _port_search3(d, s_count, backend, h, alpha, beta):
    inv_r, inv_v = _stacked(d, s_count)
    return dist.sharded_three_pass_topk(
        ["cpu"] * s_count,
        *_t(_codes(d, backend), d["lut"], inv_r, inv_v, d["res_q"],
            d["res_scale"], d["res_zero"], d["sres_cols"], d["sres_vals"],
            d["q_dims"], d["q_vals"], d["q_dense"], d["q_cols"]),
        h=h, alpha=alpha, beta=beta, adc=backend)


@pytest.mark.parametrize("k", [50, 1100])
@pytest.mark.parametrize("s_count", [1, 2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_pass1_matches_reference(data, jax_ref, backend, s_count,
                                         k):
    """k = 50 takes the fused scan-and-select on the kernel backends,
    k = 1100 (> 1024) the materialised scan + stable top-k."""
    got_s, got_i = _port_pass1(data, s_count, k, backend)
    assert got_s.shape == (Q, k) and got_i.dtype == torch.int32
    want_s, want_i = jax_ref(_jax_pass1, s_count, k)
    assert_topk_match(got_s.numpy(), got_i.numpy(), want_s, want_i)


@pytest.mark.parametrize("backend", ["cuda", "cuda-packed"])
def test_sharded_pass1_bits_do_not_depend_on_shards(data, backend):
    """A row's ADC sum and slot-ordered bias do not depend on its shard, and
    the merge in shard order keeps the lowest-id tie rule: S = 2, 4 equal
    S = 1 bit for bit, and the k = 1100 route's prefix the fused one's."""
    one = _port_pass1(data, 1, 500, backend)
    for s_count in (2, 4):
        got = _port_pass1(data, s_count, 500, backend)
        assert all(torch.equal(a, b) for a, b in zip(got, one))
    wide = _port_pass1(data, 1, 1100, backend)
    assert torch.equal(wide[0][:, :500], one[0])
    assert torch.equal(wide[1][:, :500], one[1])


@pytest.mark.parametrize("adc", ["gather", "pallas"])
def test_pass1_matches_reference_on_a_one_device_mesh(data, adc):
    """The reference's own entry point, on a 1-device CPU mesh (its Pallas
    backend in interpret mode), against the port's on ["cpu"]."""
    mesh = make_test_mesh((1,), ("data",))
    want_s, want_i = jdist.sharded_pass1_topk(
        mesh, jnp.asarray(data["codes"]), jnp.asarray(data["lut"]),
        jnp.asarray(data["inv_rows"]), jnp.asarray(data["inv_vals"]),
        jnp.asarray(data["q_dims"]), jnp.asarray(data["q_vals"]), k=50,
        adc=adc)
    got_s, got_i = _port_pass1(data, 1, 50, {"gather": "ref",
                                             "pallas": "cuda"}[adc])
    assert_topk_match(got_s.numpy(), got_i.numpy(), np.asarray(want_s),
                      np.asarray(want_i))


@pytest.mark.parametrize("s_count", [1, 2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_three_pass_matches_reference(data, jax_ref, backend,
                                              s_count):
    """h = 10, alpha = 20, beta = 5: c1 = 200, c2 = 50 per shard."""
    got_s, got_i = _port_search3(data, s_count, backend, 10, 20, 5)
    want_s, want_i = jax_ref(_jax_search3, s_count, 10, 20, 5)
    assert_topk_match(got_s.numpy(), got_i.numpy(), want_s, want_i)


def test_three_pass_matches_reference_on_a_one_device_mesh(data):
    mesh = make_test_mesh((1,), ("data",))
    j = {k: jnp.asarray(v) for k, v in data.items()}
    want_s, want_i = jdist.sharded_three_pass_topk(
        mesh, j["codes"], j["lut"], j["inv_rows"], j["inv_vals"], j["res_q"],
        j["res_scale"], j["res_zero"], j["sres_cols"], j["sres_vals"],
        j["q_dims"], j["q_vals"], j["q_dense"], j["q_cols"], h=10, alpha=20,
        beta=5)
    got_s, got_i = _port_search3(data, 1, "ref", 10, 20, 5)
    assert_topk_match(got_s.numpy(), got_i.numpy(), np.asarray(want_s),
                      np.asarray(want_i))


@pytest.mark.parametrize("s_count", [2, 4])
@pytest.mark.parametrize("backend", ["cuda", "cuda-packed"])
def test_fully_refined_three_pass_is_the_global_top_h(data, backend,
                                                      s_count):
    """With per-shard alpha·h >= the shard's rows every row is refined
    through all three passes, so the merged top-h is the global top-h of
    ADC + bias + dense residual + sparse residual (the reference's
    tests/test_distributed.py check)."""
    h = 10
    full = (N // s_count) // h + 1
    got_s, _ = _port_search3(data, s_count, backend, h, full, full)
    d = data
    dense = np.zeros((Q, N), np.float32)
    for kk in range(KPQ):
        dense += d["lut"][:, kk, :][:, d["codes"][:, kk]]
    sparse = np.zeros((Q, N + 1), np.float32)
    for qi in range(Q):
        for j, w in zip(d["q_dims"][qi], d["q_vals"][qi]):
            np.add.at(sparse[qi], d["inv_rows"][j], w * d["inv_vals"][j])
    qs = d["q_dense"] * d["res_scale"][None]
    dres = (d["res_q"].astype(np.float32) @ qs.T).T + (
        128.0 * qs.sum(-1) + d["q_dense"] @ d["res_zero"])[:, None]
    sres = np.einsum("nr,qnr->qn", d["sres_vals"],
                     d["q_cols"][:, d["sres_cols"]])
    total = dense + sparse[:, :N] + dres + sres
    want = -np.sort(-total, axis=1)[:, :h]
    np.testing.assert_allclose(got_s.numpy(), want, rtol=1e-4, atol=1e-4)


def test_sharded_search_refuses_unequal_shards(data):
    with pytest.raises(ValueError, match="equal"):
        _port_pass1(dict(data, codes=data["codes"][:N - 1]), 4, 10, "ref")
    with pytest.raises(ValueError, match="at least one device"):
        dist.make_sharded_search_fn([], k=10)
