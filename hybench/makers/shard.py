"""A drawn index shard served through ``QueryService``: the reference dry
run's one-card share of the billion-vector index.

The shard's arrays are drawn on the device from the seed, as the dry run
draws them (codes uniform in [0, l), every posting list full with rows
uniform over the shard and values uniform in [0, 1), int8 residual codes
uniform with scale and zero uniform in [0, 0.01), sparse residual columns
uniform over the compact space and padding, values uniform); the PQ
centers and the dense queries are standard normal, the query dims distinct
and uniform, their values uniform.  The arrays are wrapped as
``IndexArrays`` and served by a ``ScoringEngine`` behind ``QueryService``;
ids come back as global ids (the shard's row offset added).
"""

from __future__ import annotations

import numpy as np
import torch

from hybench import reference
from hybench.built import Built, Pools
from hybench.costs import SearchShape, candidate_counts
from hybench.makers import serving


def draw_shard(cfg: dict, seed: int, device) -> dict:
    """The shard's arrays, drawn from ``seed`` on ``device`` in a few large
    calls."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    n, k, l = cfg["num_points"], cfg["pq_subspaces"], cfg["pq_codes"]
    d, da = cfg["d_dense"], cfg["d_active"]

    def ints(lo, hi, size, dtype):
        return torch.randint(lo, hi, size, generator=g, dtype=dtype,
                             device=device)

    def unif(size):
        return torch.rand(size, generator=g, device=device)

    return {"codes": ints(0, l, (n, k), torch.uint8),
            "centers": torch.randn((k, l, d // k), generator=g,
                                   device=device),
            "inv_rows": ints(0, n, (da, cfg["l_max"]), torch.int32),
            "inv_vals": unif((da, cfg["l_max"])),
            "res_q": ints(-128, 128, (n, d), torch.int8),
            "res_scale": unif((d,)) * 0.01,
            "res_zero": unif((d,)) * 0.01,
            "sres_cols": ints(0, da + 1, (n, cfg["r_max"]), torch.int32),
            "sres_vals": unif((n, cfg["r_max"]))}


def draw_queries(cfg: dict, seed: int, rows: int, device,
                 chunk: int = 2048) -> dict:
    """``rows`` query rows: nq distinct dims uniform over the compact space
    (the top nq of uniform keys), values uniform, dense standard normal."""
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    da, nq = cfg["d_active"], cfg["nq"]
    dims = torch.cat([
        torch.rand((min(chunk, rows - s), da), generator=g,
                   device=device).topk(nq, dim=1).indices.to(torch.int32)
        for s in range(0, rows, chunk)])
    return {"dims": dims,
            "vals": torch.rand((rows, nq), generator=g, device=device),
            "dense": torch.randn((rows, cfg["d_dense"]), generator=g,
                                 device=device)}


def build(cfg: dict, mix: dict, seed: int, device, trace: bool) -> Built:
    from repro_torch.core.engine import Backend, IndexArrays, ScoringEngine
    from repro_torch.core.pq import PQCodebooks, ScalarQuant
    from repro_torch.core.sparse_index import (PaddedInvertedIndex,
                                               PaddedSparseRows)

    a = draw_shard(cfg, seed, device)
    n, fresh_n, warm_n = cfg["num_points"], cfg["fresh_pool"], \
        cfg["warm_rows"]
    q = draw_queries(cfg, seed, fresh_n + warm_n, device)
    host = {key: v.cpu().numpy() for key, v in q.items()}
    fresh = Pools(host["dims"][:fresh_n], host["vals"][:fresh_n],
                  host["dense"][:fresh_n])
    warm = Pools(host["dims"][fresh_n:], host["vals"][fresh_n:],
                 host["dense"][fresh_n:])
    offset = int(cfg["row_offset"])

    arrays = IndexArrays.build(
        codebooks=PQCodebooks(centers=a["centers"]), codes=a["codes"],
        inv_index=PaddedInvertedIndex(rows=a["inv_rows"],
                                      vals=a["inv_vals"], num_points=n),
        head=None,
        dense_residual=ScalarQuant(q=a["res_q"], scale=a["res_scale"],
                                   zero=a["res_zero"]),
        sparse_residual=PaddedSparseRows(cols=a["sres_cols"],
                                         vals=a["sres_vals"]),
        num_points=n, d_active=cfg["d_active"], with_bcsr=False)
    engine = ScoringEngine(arrays=arrays,
                           backend=Backend.from_name(cfg["backend"]))
    hooks = serving.serve(engine, cfg, device, trace,
                          np.arange(n, dtype=np.int64) + offset)
    c1, c2 = candidate_counts(n, cfg["h"], cfg["alpha"], cfg["beta"])

    data = reference.ShardData(
        codes=a["codes"], centers=a["centers"], inv_rows=a["inv_rows"],
        inv_vals=a["inv_vals"], res_q=a["res_q"], res_scale=a["res_scale"],
        res_zero=a["res_zero"], sres_cols=a["sres_cols"],
        sres_vals=a["sres_vals"])

    def scorer(rows, precision):
        idx = torch.from_numpy(np.asarray(rows)).to(device)
        return reference.ShardScorer(data, q["dims"][idx], q["vals"][idx],
                                     q["dense"][idx], precision)

    shape = SearchShape(
        n=n, k=cfg["pq_subspaces"], l=cfg["pq_codes"],
        p=cfg["d_dense"] // cfg["pq_subspaces"], d_dense=cfg["d_dense"],
        nq=cfg["nq"], h=cfg["h"], c1=c1, c2=c2,
        postings_per_row=cfg["nq"] * cfg["l_max"],
        residual_per_row=cfg["r_max"])
    return Built(
        fresh=fresh, hot=None, warm=warm, shape=shape, h=cfg["h"], c1=c1,
        c2=c2, buckets=tuple(cfg["buckets"]), scorer=scorer,
        ref_ids=lambda ids: torch.from_numpy(ids - offset).to(device),
        prog_ids=lambda ids: ids + offset, **hooks)
