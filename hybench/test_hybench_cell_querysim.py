"""``querysim524k-ragged1`` (ready in ``hybench/later/``, not yet in
``BENCHMARK.json``) at test size on the CPU: a sound run, its last line,
and ``correct`` false under the control and each fault."""

import pytest

from hybench import _cell_tests as ct
from hybench.conftest import tiny

CELL = "querysim524k-ragged1"


def test_sound_run_and_last_line(later_bench, capsys):
    ct.check_sound_run(later_bench, tiny(later_bench, CELL), capsys)


def test_traced_run(later_bench):
    ct.check_traced_run(later_bench, tiny(later_bench, CELL))


@pytest.mark.parametrize("fault", ["control", "answer_altered",
                                   "half_left_out", "answer_duplicated"])
def test_broken_path_is_not_correct(later_bench, fault):
    ct.check_fails(later_bench, tiny(later_bench, CELL), fault)
