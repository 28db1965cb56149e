"""The traffic generator: schedules from the mix files."""

import json

import numpy as np
import pytest

from hybench import load, run


@pytest.fixture(scope="module")
def mixes(bench):
    return {p.stem: json.loads(p.read_text())
            for p in (bench.pkg / "traffic").glob("*.json")}


def test_schedule_deterministic_by_seed(mixes):
    for mix in mixes.values():
        a = load.make_schedule(mix, 2**33 + 1, 4096)
        b = load.make_schedule(mix, 2**33 + 1, 4096)
        assert len(a) == int(mix["requests"])
        assert all(np.array_equal(x, y) for x, y in zip(a.rows, b.rows))


def test_seeds_send_the_same_work_in_another_order(mixes):
    for mix in mixes.values():
        a = load.make_schedule(mix, 5, 1 << 20)
        b = load.make_schedule(mix, 2**31 + 11, 1 << 20)
        if len(mix["sizes"]) > 1:
            assert not np.array_equal(a.sizes(), b.sizes())
        assert np.array_equal(np.sort(a.sizes()), np.sort(b.sizes()))
        hot = [np.sort(np.concatenate([r[r < 0] for r in s.rows]))
               for s in (a, b)]
        assert np.array_equal(*hot)


def test_sizes_follow_the_mix(mixes):
    mix = mixes["ragged1"]
    sizes = load.make_schedule(mix, 3, 1 << 20).sizes()
    assert sizes.min() >= 1 and sizes.max() <= 128
    for lo, hi, share in mix["sizes"]:
        got = np.mean((sizes >= lo) & (sizes <= hi))
        assert abs(got - share) < 0.02
    assert np.all(load.make_schedule(mixes["batch32"], 3, 4096).sizes()
                  == 32)


def test_hot_rows_and_fresh_rows(mixes):
    mix = mixes["ragged1"]
    s = load.make_schedule(mix, 9, 1 << 30)
    rows = np.concatenate(s.rows)
    hot = rows < 0
    assert abs(hot.mean() - mix["hot_share"]) < 0.01
    assert (-1 - rows[hot]).max() < mix["hot_set"]
    ranks = np.bincount(-1 - rows[hot], minlength=mix["hot_set"])
    assert ranks[0] > ranks[10] > ranks[1000]           # Zipf
    fresh = rows[~hot]
    assert len(np.unique(fresh)) == len(fresh)          # never repeated
    small = load.make_schedule(mix, 9, 64)
    assert np.concatenate(small.rows).max() < 64        # pool reused


def test_buckets_reached():
    b = (1, 8, 32)
    assert run.buckets_reached([32], b, False) == [32]
    assert run.buckets_reached([40], b, False) == [8, 32]
    assert run.buckets_reached([3, 128], b, True) == [1, 8, 32]


def test_closed_loop_counts_every_request():
    sched = load.Schedule(rows=[np.arange(i % 3 + 1) for i in range(50)])
    calls = []

    def send(rows):
        calls.append(len(rows))
        if len(calls) % 7 == 0:
            raise RuntimeError("refused")
        return np.zeros((len(rows), 1)), np.zeros((len(rows), 1), int)

    loop = load.ClosedLoop(sched, send, clients=3)
    start, stop = loop.run(0.2)
    assert len(loop.records) == len(calls) > 0
    assert sum(not r.ok for r in loop.records) == len(calls) // 7
    assert all(start <= r.sent < stop for r in loop.records)
    assert np.isinf(load.percentile([1.0, float("inf")], 99))
    assert load.percentile([3.0, 1.0, 2.0, 4.0], 50) == np.percentile(
        [3.0, 1.0, 2.0, 4.0], 50)


def test_sample_takes_each_position_from_its_own_request():
    recs = [load.Record(index=i, rows=np.arange(4) + 10 * i, sent=0.0,
                        done=0.0, ok=True, scores=np.zeros((4, 2)),
                        ids=np.arange(8).reshape(4, 2) + 100 * i)
            for i in range(20)]
    rows, ids, _ = run.sample_answers(recs, 12, 2**33 + 5)
    assert sorted(rows % 10) == sorted(list(range(4)) * 3)
    assert len(set(rows // 10)) == 12                  # 12 requests
    assert np.array_equal(ids[:, 0] % 100, 2 * (rows % 10))
    again = run.sample_answers(recs, 12, 2**33 + 5)[0]
    assert np.array_equal(rows, again)
    few = run.sample_answers(recs[:2], 8, 1)[0]
    assert sorted(few.tolist()) == list(range(4)) + list(range(10, 14))
