"""The port's configs (``repro_torch.configs``) against the JAX package's:
every registered config, the ten archs and their ``-smoke`` variants, equal
field for field; the registry's names and the shape table equal; an unknown
name raises ``KeyError``."""

import dataclasses

import pytest

from repro import configs as ref
from repro_torch import configs as port

NAMES = ref.list_archs(include_smoke=True)


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    got, want = port.get_config(name), ref.get_config(name)
    assert type(got).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.resolved_head_dim, got.effective_kv_heads,
            got.attention_free, got.sub_quadratic) == (
        want.resolved_head_dim, want.effective_kv_heads,
        want.attention_free, want.sub_quadratic)


def test_registry_and_tables_equal_reference():
    assert len(NAMES) == 20
    assert port.list_archs() == ref.list_archs()
    assert port.list_archs(include_smoke=True) == NAMES
    assert port.ARCH_IDS == ref.ARCH_IDS
    assert sorted(port.list_archs()) == sorted(port.ARCH_IDS)
    assert ({k: dataclasses.asdict(v) for k, v in port.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()})


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        port.get_config("nope")
