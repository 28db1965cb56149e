"""The optimizer of the training stack (counterpart of ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    global_norm, clip_by_global_norm, cosine_schedule)
