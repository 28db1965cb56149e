"""Production mesh shapes (counterpart of ``repro.launch.mesh``).

The port runs no SPMD program, so a mesh here holds no devices: a
``LogicalMesh`` is the axis names and sizes that ``models.common``'s
``resolve_spec`` and ``models.shardings`` read (``axis_names`` and
``shape``), enough to reckon each device's share of a cell's arrays, as the
reference's ``build_lowered`` lays them out on the TPU pods.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["LogicalMesh", "make_production_mesh", "make_test_mesh"]


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Mesh axis names and their sizes, with no devices."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1: {self.sizes}")

    @property
    def shape(self) -> dict:
        """axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod:  (pod=2, data=16, model=16) = 512 chips; the 'pod' axis is
    the slowest axis and carries only data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(axes, shape)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> LogicalMesh:
    """A small mesh, as the reference's CPU multi-device tests use."""
    return LogicalMesh(tuple(axes), tuple(shape))
