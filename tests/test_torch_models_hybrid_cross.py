"""The checks of tests/test_torch_models_families.py (the init tree,
forward, prefill, 4 decode steps against the JAX package's in f32, decode
against forward in bf16) on the other three of the six smoke configs:
recurrentgemma-9b (RG-LRU and the local-attention ring; one (rglru, rglru,
lattn) repeat and two tail rglru layers), llama-3.2-vision (self x 4 +
self_cross over ``cond``) and musicgen-medium (the ``embeddings``
frontend, LayerNorm, ``cond``).  The two files split the JAX compiles."""

import pytest

from _torch_lm_helpers import reference_case
from test_torch_models_families import (  # noqa: F401  run on this file's case
    test_decode_matches_own_forward_bf16, test_decode_matches_reference,
    test_forward_matches_reference, test_init_tree_matches_reference,
    test_prefill_matches_reference)

ARCHS = ["recurrentgemma-9b-smoke", "llama-3.2-vision-90b-smoke",
         "musicgen-medium-smoke"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return reference_case(request.param)
