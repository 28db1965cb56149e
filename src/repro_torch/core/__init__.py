"""Index build, three-pass search, the streaming mutable index, the paper's
baselines, the cache-sort cost model and the sharded search (counterpart of
``repro.core``).

NOTE: the Algorithm-1 entry point lives at repro_torch.core.cache_sort.
cache_sort (not re-exported here: it would shadow the submodule attribute).
"""

from . import cache_sort                                              # noqa: F401
from .cache_sort import (expected_cost_unsorted,                      # noqa: F401
                         expected_cost_sorted_bound, measured_block_cost,
                         block_occupancy, power_law_probs)
from .hybrid import HybridIndex, HybridIndexParams, SearchResult      # noqa: F401
from .pq import (PQCodebooks, train_codebooks, pq_encode, pq_decode,  # noqa: F401
                 adc_lut, adc_scores_ref, scalar_quantize, ScalarQuant)
from .pruning import prune_split, per_dim_thresholds                  # noqa: F401
from .streaming import DeltaShard, MutableState, search_mutable       # noqa: F401
