"""The pass-1 byte model (counterpart of ``repro.roofline``).  The
reference's ``analysis.py`` and ``report.py`` read and render the TPU
dry-run's compiled HLO and are not ported."""

from .pass1 import predicted_pass1_bytes  # noqa: F401
