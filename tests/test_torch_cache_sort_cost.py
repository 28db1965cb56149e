"""The port's cache-sort cost model (repro_torch.core.cache_sort, paper Eq. 4
/ Eq. 5 and the measured block counter) against the JAX package's: a numpy
copy, so the same inputs give the same numbers exactly."""

import numpy as np
import pytest

import repro.core as jcore
import repro.core.cache_sort as jcs
import repro_torch.core as pcore
import repro_torch.core.cache_sort as pcs


@pytest.mark.parametrize("alpha", [0.8, 1.5, 2.0, 3.0])
def test_power_law_probs_equal(alpha):
    for d in (1, 17, 4096):
        assert np.array_equal(pcs.power_law_probs(d, alpha),
                              jcs.power_law_probs(d, alpha))


@pytest.mark.parametrize("n,b", [(1000, 16), (100000, 128), (2 ** 20, 64)])
@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_expected_costs_equal(n, b, alpha):
    d = 3000
    p = pcs.power_law_probs(d, alpha) * 0.5
    q = np.random.default_rng(n + b).random(d)
    for fn in ("expected_cost_unsorted", "expected_cost_sorted_bound"):
        got = getattr(pcs, fn)(p, q, n, b)
        want = getattr(jcs, fn)(p, q, n, b)
        assert isinstance(got, float) and got == want, fn
    assert (pcs.expected_cost_sorted_bound(p, q, n, b)
            <= pcs.expected_cost_unsorted(p, q, n, b))


@pytest.mark.parametrize("b", [8, 64, 128])
@pytest.mark.parametrize("sorted_rows", [False, True])
def test_block_occupancy_and_measured_cost_equal(powerlaw_sparse, b,
                                                 sorted_rows):
    x = powerlaw_sparse
    pi = pcs.cache_sort(x) if sorted_rows else None
    if sorted_rows:
        assert np.array_equal(pi, jcs.cache_sort(x))
    occ = pcs.block_occupancy(x, b, pi)
    assert occ.dtype == bool
    assert np.array_equal(occ, jcs.block_occupancy(x, b, pi))
    rng = np.random.default_rng(b)
    for _ in range(4):
        dims = rng.choice(x.shape[1], size=12, replace=False)
        assert (pcs.measured_block_cost(x, b, dims, pi)
                == jcs.measured_block_cost(x, b, dims, pi))


def test_cache_sort_lowers_measured_cost(powerlaw_sparse):
    """The quantity Algorithm 1 minimises falls after sorting, in both
    packages alike."""
    x = powerlaw_sparse
    pi = pcs.cache_sort(x)
    dims = np.arange(40)
    assert (pcs.measured_block_cost(x, 64, dims, pi)
            < pcs.measured_block_cost(x, 64, dims))


def test_core_reexports_match_reference():
    """repro_torch.core exports what repro.core exports (streaming aside,
    which has its own tests), and ``cache_sort`` stays the submodule."""
    names = ("expected_cost_unsorted", "expected_cost_sorted_bound",
             "measured_block_cost", "block_occupancy", "power_law_probs",
             "HybridIndex", "HybridIndexParams", "SearchResult",
             "PQCodebooks", "train_codebooks", "pq_encode", "pq_decode",
             "adc_lut", "adc_scores_ref", "scalar_quantize", "ScalarQuant",
             "prune_split", "per_dim_thresholds", "DeltaShard",
             "MutableState", "search_mutable")
    for name in names:
        assert hasattr(jcore, name), name
        assert hasattr(pcore, name), name
    assert pcore.cache_sort is pcs
    assert callable(pcore.cache_sort.cache_sort)
