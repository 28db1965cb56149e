"""The LM zoo (counterpart of ``repro.models``): the dense family so far."""

from .model import Model  # noqa: F401

__all__ = ["Model"]
