"""The JAX package's HybridIndexParams cross into the port's.

The JAX package's snapshot manifests store ``dataclasses.asdict`` of the
index params and rebuild them with ``HybridIndexParams(**params)``
(``repro/persist/snapshot.py``), so the port's params must take every field
of the reference's.  Its backends resolve by the documented mapping:
``backend=None`` serves on the kernels (``cuda``) whatever
``use_lut16_kernel`` says, the JAX names are aliases of the port's, and
codes are packed iff the backend is packed unless ``pack_codes`` says."""

import dataclasses

import pytest

from repro.core.hybrid import HybridIndexParams as JaxParams
from repro_torch.core.engine import Backend
from repro_torch.core.hybrid import HybridIndexParams


@pytest.mark.parametrize("kw,backend,pack", [
    ({}, Backend.CUDA, False),
    ({"use_lut16_kernel": True}, Backend.CUDA, False),
    ({"backend": "pallas-packed"}, Backend.CUDA_PACKED, True),
    ({"backend": "pallas"}, Backend.CUDA, False),
    ({"backend": "ref"}, Backend.REF, False),
    ({"backend": "onehot-mxu"}, Backend.ONEHOT, False),
    ({"backend": "pallas-packed", "pack_codes": False}, Backend.CUDA_PACKED,
     False),
    ({"backend": "ref", "pack_codes": True, "keep_top": 64}, Backend.REF,
     True),
])
def test_params_cross_from_jax(kw, backend, pack):
    theirs = JaxParams(**kw)
    ours = HybridIndexParams(**dataclasses.asdict(theirs))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.resolve_backend() is backend
    assert ours.resolve_pack() is pack


def test_params_have_the_same_fields():
    assert ([f.name for f in dataclasses.fields(HybridIndexParams)]
            == [f.name for f in dataclasses.fields(JaxParams)])
