"""The benchmark of ``repro_torch``, the PyTorch + CUDA port of the hybrid
inner-product search (``BENCHMARK.json`` at the root of the checkout).

``python -m hybench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once.  Everything that belongs to one configuration,
traffic mix or per-layer metric sits in a file of its own, found by the
name that ``BENCHMARK.json`` gives:

* ``hybench/configs/<config>.json``: sizes, source, cuts and the name of
  the maker (``hybench/makers/<maker>.py``) that draws the data on the
  device from the seed and builds the service;
* ``hybench/traffic/<mix>.json``: the parameters that ``hybench/load.py``,
  the one traffic generator, reads;
* ``hybench/metrics/<metric>.py``: a reader with ``read(ctx)`` that
  returns one number, or None where it finds nothing to read.

``hybench/reference.py`` is the plain reference that decides ``correct``;
``hybench/costs.py`` counts the least work a search needs.  Nothing here
imports ``jax`` or the JAX package ``repro``.
"""
