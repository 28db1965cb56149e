"""The LM zoo (counterpart of ``repro.models``): every family's layers and
the ``Model`` that stacks them."""

from .model import Model  # noqa: F401

__all__ = ["Model"]
