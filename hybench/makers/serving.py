"""What every maker does with the program once its engine is built: serve
it through ``QueryService`` and hand the runner the calls it times."""

from __future__ import annotations

import torch


def serve(engine, cfg: dict, device, trace: bool, id_map) -> dict:
    """The timed entry and its hooks, as ``Built`` takes them: ``search``,
    ``cache_info``, ``pass1`` (``pass1(pools, rows)``: a call of the
    engine's pass 1 alone on those rows), ``release`` and ``obs``."""
    from repro_torch.core.pq import adc_lut
    from repro_torch.obs import Observability
    from repro_torch.serve.query_service import QueryService

    obs = Observability(trace=trace, keep_traces=1 << 20)
    prog = {"engine": engine, "service": QueryService(
        engine, h=cfg["h"], alpha=cfg["alpha"], beta=cfg["beta"],
        buckets=tuple(cfg["buckets"]), cache_size=cfg["cache_rows"],
        id_map=id_map, device=device, obs=obs)}
    c1, _ = engine.candidate_counts(cfg["h"], cfg["alpha"], cfg["beta"])

    def pass1(pools, rows):
        eng = prog["engine"]
        qd, qv, dense = (torch.from_numpy(a).to(device)
                         for a in pools.take(rows))
        lut = adc_lut(dense, eng.arrays.codebooks,
                      fixed_order=eng.backend.uses_kernels)
        return lambda: eng.pass1_topk(qd, qv, lut, c1)

    def release():
        prog["service"].close()
        prog.clear()

    return {"search": lambda *x: prog["service"].search(*x),
            "cache_info": lambda: prog["service"].cache_info(),
            "pass1": pass1, "release": release, "obs": obs}
