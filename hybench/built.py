"""What a maker hands the runner: the program's service for the window,
the benchmark's query pools, and the reference's view of the same data."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .costs import SearchShape


@dataclasses.dataclass
class Pools:
    """Host query rows in the layout ``QueryService.search`` takes:
    (P, nq) int32 dims, (P, nq) float32 values, (P, d) float32 dense."""
    dims: np.ndarray
    vals: np.ndarray
    dense: np.ndarray

    def __len__(self) -> int:
        return self.dims.shape[0]

    def take(self, idx: np.ndarray) -> tuple:
        return self.dims[idx], self.vals[idx], self.dense[idx]


@dataclasses.dataclass
class Built:
    """One cell's set-up.

    ``fresh``, ``hot`` and ``warm`` are the query pools (schedule rows >= 0
    index ``fresh``, rows < 0 index ``hot`` as ``-1 - row``; ``warm`` only
    serves the warm-up).  ``search(dims, vals, dense)`` is the timed entry;
    ``pass1(pools, rows)`` returns a call of the program's pass 1 alone on
    those rows.  ``scorer(rows, precision)`` gives the reference's scorer
    for schedule rows; ``ref_ids`` maps the program's answer ids into the
    reference's row space (a tensor on the reference's device) and
    ``prog_ids`` maps the reference's back.  ``release()`` drops the program's objects and
    keeps the benchmark's data.  ``checks()`` gives further compared
    numbers as {name: value}."""
    search: Callable
    cache_info: Callable
    fresh: Pools
    hot: Pools | None
    warm: Pools
    shape: SearchShape
    h: int
    c1: int
    c2: int
    buckets: tuple
    pass1: Callable
    scorer: Callable
    ref_ids: Callable
    prog_ids: Callable
    release: Callable
    obs: object = None
    checks: Callable = lambda: {}

    def rows(self, rows: np.ndarray) -> tuple:
        """Host arrays of schedule rows, fresh and hot mixed in order."""
        if self.hot is None or (rows >= 0).all():
            return self.fresh.take(rows)
        parts = [np.empty((len(rows),) + a.shape[1:], a.dtype)
                 for a in (self.fresh.dims, self.fresh.vals,
                           self.fresh.dense)]
        f, h = rows >= 0, rows < 0
        for out, a, b in zip(parts, self.fresh.take(rows[f]),
                             self.hot.take(-1 - rows[h])):
            out[f], out[h] = a, b
        return tuple(parts)
