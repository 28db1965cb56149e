"""``shard1b-batch32`` at test size on the CPU: a sound run, its last
line, and ``correct`` false under the control and each fault."""

import pytest

from hybench import _cell_tests as ct
from hybench.conftest import tiny

CELL = "shard1b-batch32"


def test_sound_run_and_last_line(bench, capsys):
    ct.check_sound_run(bench, tiny(bench, CELL), capsys)


def test_traced_run(bench):
    ct.check_traced_run(bench, tiny(bench, CELL))


@pytest.mark.parametrize("fault", ["control", "answer_altered",
                                   "half_left_out", "answer_duplicated"])
def test_broken_path_is_not_correct(bench, fault):
    ct.check_fails(bench, tiny(bench, CELL), fault)
