"""The port's persistence (repro_torch.persist, checkpoint.leaves) against
the JAX package's, on the CPU: the on-disk format crosses in both
directions.

One mutation sequence goes through a durable JAX service and a durable
port service over the same main generation (a JAX mutable index on the
``ref`` backend, carried across with ``interchange``).  The WAL segments
must be byte-identical, and so must the snapshots' leaf tables (dtype,
shape, sha256).  A store written by either package recovers in the other
with the same ids and scores (``assert_topk_match``: rtol 1e-5, atol 1e-4,
ties up to the tolerance), also from a WAL cut at several byte offsets.
The port's manifests carry only backend names the reference reads (C1).
The committed store of ``tools/make_reference_store.py`` recovers in both
packages to the results recorded beside it.  The port is held to the
``ref`` backend throughout."""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
from _torch_port_helpers import assert_topk_match, jax_index_state

from repro import persist as jpersist
from repro.core.engine import Backend as JaxBackend
from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.hybrid import HybridIndexParams as JaxParams
from repro.data import make_hybrid_dataset
from repro.serve import QueryService as JaxQueryService
from repro_torch import persist
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.interchange import mutable_index_from_numpy
from repro_torch.serve import QueryService

N = 600
PARAMS = dict(keep_top=24, head_dims=16, kmeans_iters=3)
FIXTURE = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def ds():
    return make_hybrid_dataset(num_points=N + 48, num_queries=8,
                               d_sparse=900, d_dense=12, nnz_per_row=14,
                               seed=31)


def _mutate(svc, ds):
    """The mutation sequence both packages log: inserts, deletes of main
    and delta rows, an upsert, a no-op delete (not logged)."""
    xs, xd = ds.x_sparse, ds.x_dense
    svc.insert(xs[N:N + 16], xd[N:N + 16])
    svc.insert(xs[N + 16:N + 32], xd[N + 16:N + 32])
    svc.delete([3, N + 2])
    svc.insert(xs[N + 32:N + 34], xd[N + 32:N + 34], ids=[7, N + 5])
    svc.delete([99999])


def _search(svc, ds):
    return svc.search_sparse(ds.q_sparse, ds.q_dense)


@pytest.fixture(scope="module")
def stores(ds, tmp_path_factory):
    """Both packages' stores after the same sequence, a delta-state
    checkpoint in the middle, and each live service's last results."""
    jidx = JaxHybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N],
                                JaxParams(backend="ref", **PARAMS),
                                mutable=True)
    leaves, scalars = jax_index_state(jidx)
    tidx = mutable_index_from_numpy(
        leaves, scalars, ds.x_sparse[:N], ds.x_dense[:N],
        params=HybridIndexParams(backend="ref", **PARAMS), device="cpu")
    base = tmp_path_factory.mktemp("stores")
    jroot, troot = str(base / "jax"), str(base / "port")
    kw = dict(h=10, cache_size=0, auto_compact=False)
    jsvc = JaxQueryService(index=jidx, persist_dir=jroot, **kw)
    tsvc = QueryService(index=tidx, persist_dir=troot, device="cpu", **kw)
    first = {r: json.load(open(os.path.join(r, "snap-000001",
                                            "manifest.json")))
             for r in (jroot, troot)}
    for svc in (jsvc, tsvc):
        _mutate(svc, ds)
        svc.checkpoint()
        svc.insert(ds.x_sparse[N + 34:N + 40], ds.x_dense[N + 34:N + 40])
        svc.delete([N + 35, 11])
    live = {jroot: _search(jsvc, ds), troot: _search(tsvc, ds)}
    jsvc.close()
    tsvc.close()
    return dict(jax=jroot, port=troot, first=first, live=live)


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_wal_segments_byte_identical(stores):
    jw = _files(os.path.join(stores["jax"], "wal"))
    tw = _files(os.path.join(stores["port"], "wal"))
    assert sorted(jw) == sorted(tw) and jw
    for name in jw:
        assert open(tw[name], "rb").read() == open(jw[name], "rb").read()


@pytest.mark.parametrize("snap", ["first", "snap-000002"])
def test_snapshot_manifests_match_reference(stores, snap):
    """Same main generation, same sequence: every leaf has the reference's
    dtype, shape and bytes, and the scalars and params are the same."""
    if snap == "first":
        jm, tm = (stores["first"][stores[k]] for k in ("jax", "port"))
    else:
        jm, tm = (json.load(open(os.path.join(stores[k], snap,
                                              "manifest.json")))
                  for k in ("jax", "port"))
    assert tm == jm


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _recover_jax(root, **kw):
    rec = jpersist.recover(root, **kw)
    rec.durability.close()
    return rec


def _recover_port(root, **kw):
    rec = persist.recover(root, device="cpu", **kw)
    rec.durability.close()
    return rec


def test_reference_store_recovers_in_port(stores, ds, tmp_path):
    rec = _recover_port(_copy(stores["jax"], tmp_path / "s"))
    assert rec.index.engine.backend.value == "ref" and rec.replayed == 2
    res = rec.index.search(ds.q_sparse, ds.q_dense, h=10)
    s, ids = stores["live"][stores["jax"]]
    assert_topk_match(res.scores, res.ids, s, ids)


def test_port_store_recovers_in_reference(stores, ds, tmp_path):
    rec = _recover_jax(_copy(stores["port"], tmp_path / "s"),
                       backend="ref")
    assert rec.replayed == 2
    res = rec.index.search(ds.q_sparse, ds.q_dense, h=10)
    s, ids = stores["live"][stores["port"]]
    assert_topk_match(s, ids, res.scores, res.ids)


def test_port_restore_is_bit_identical_to_live(stores, ds, tmp_path):
    root = _copy(stores["port"], tmp_path / "s")
    svc = QueryService(restore_from=root, h=10, cache_size=0,
                       auto_compact=False, device="cpu")
    s, ids = _search(svc, ds)
    live_s, live_ids = stores["live"][stores["port"]]
    np.testing.assert_array_equal(ids, live_ids)
    np.testing.assert_array_equal(s, live_s)
    assert svc.stats()["recovered_replayed"] == 2
    # compaction cuts a snapshot and truncates the WAL behind it
    svc.compact(retrain=False)
    s2, i2 = _search(svc, ds)
    svc.close()
    assert persist.read_current(root)["snapshot"] == "snap-000003"
    again = QueryService(restore_from=root, h=10, cache_size=0,
                         auto_compact=False, device="cpu")
    assert again.stats()["recovered_replayed"] == 0
    s3, i3 = _search(again, ds)
    again.close()
    np.testing.assert_array_equal(i3, i2)
    np.testing.assert_array_equal(s3, s2)


@pytest.mark.parametrize("backend", ["ref", "onehot", "cuda", "cuda-packed",
                                     None])
def test_manifest_backend_names_read_by_reference(ds, tmp_path, backend):
    """C1: a port-written manifest names its backends as the reference's
    ``Backend.from_name`` reads them, in ``scalars`` and in ``params``."""
    idx = HybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N],
                            HybridIndexParams(backend=backend, **PARAMS),
                            mutable=True, device="cpu")
    root = idx.save(str(tmp_path / "s"))
    m = json.load(open(os.path.join(root, "snap-000001", "manifest.json")))
    want = {"ref": "ref", "onehot": "onehot-mxu", "cuda": "pallas",
            "cuda-packed": "pallas-packed", None: "pallas"}[backend]
    assert m["scalars"]["backend"] == want
    assert JaxBackend.from_name(m["scalars"]["backend"]).value == want
    assert m["params"]["backend"] == (None if backend is None else want)
    JaxParams(**m["params"]).resolve_backend()
    # and the port reads its own store back under either set of names
    back = HybridIndex.load(root, device="cpu")
    assert back.engine.backend is idx.engine.backend


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.55, 0.8, 0.999])
def test_truncated_wal_recovers_like_reference(stores, ds, tmp_path, frac):
    """A crash that tears the WAL: both packages recover the same prefix
    of records from the same bytes, to the same results."""
    src = stores["jax"]
    seg = sorted(_files(os.path.join(src, "wal")))[-1]
    size = os.path.getsize(os.path.join(src, "wal", seg))
    cut = int(frac * size)
    roots = []
    for name in ("a", "b"):
        root = _copy(src, tmp_path / name)
        with open(os.path.join(root, "wal", seg), "r+b") as f:
            f.truncate(cut)
        roots.append(root)
    jrec = _recover_jax(roots[0])
    trec = _recover_port(roots[1])
    assert (trec.replayed, trec.last_seq) == (jrec.replayed, jrec.last_seq)
    assert trec.durability.wal.next_seq == jrec.durability.wal.next_seq
    jres = jrec.index.search(ds.q_sparse, ds.q_dense, h=10)
    tres = trec.index.search(ds.q_sparse, ds.q_dense, h=10)
    assert_topk_match(tres.scores, tres.ids, jres.scores, jres.ids)


def test_load_refuses_a_leaf_of_another_dtype(stores, tmp_path):
    root = _copy(stores["port"], tmp_path / "s")
    snap = persist.read_current(root)["snapshot"]
    path = os.path.join(root, snap, "manifest.json")
    m = json.load(open(path))
    m["leaves"]["head_occupancy"]["dtype"] = "|u1"
    json.dump(m, open(path, "w"))
    with pytest.raises(ValueError, match="head_occupancy.*dtype"):
        persist.load_snapshot(root, device="cpu")


def test_committed_reference_store_recovers_in_both(tmp_path):
    """The store ``tools/make_reference_store.py`` wrote with the JAX
    package, against the results it recorded beside it."""
    e = np.load(os.path.join(FIXTURE, "reference_store_expected.npz"))
    q = sp.csr_matrix((e["q_data"], e["q_indices"], e["q_indptr"]),
                      shape=tuple(e["q_shape"]))
    kw = dict(h=int(e["h"]), alpha=int(e["alpha"]), beta=int(e["beta"]))
    src = os.path.join(FIXTURE, "reference_store")
    jrec = _recover_jax(_copy(src, tmp_path / "a"))
    trec = _recover_port(_copy(src, tmp_path / "b"))
    assert jrec.replayed == trec.replayed == int(e["replayed"]) > 0
    jres = jrec.index.search(q, e["q_dense"], **kw)
    np.testing.assert_array_equal(jres.ids, e["ids"])
    np.testing.assert_array_equal(jres.scores, e["scores"])
    tres = trec.index.search(q, e["q_dense"], **kw)
    assert_topk_match(tres.scores, tres.ids, e["scores"], e["ids"])
