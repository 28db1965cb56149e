"""Roofline accounting (counterpart of ``repro.roofline``): the pass-1
byte model, the analytic params and model FLOPs of a config, the counted
flops and bytes of an eager step (``cost_of``) and the terms over the H100's
peaks.  The reference's HLO collective parser is not ported: the port runs
no SPMD program."""

from .analysis import (H100, RooflineTerms, cost_of,  # noqa: F401
                       count_params, model_flops, roofline_from_cost)
from .pass1 import measured_bytes, predicted_pass1_bytes  # noqa: F401
