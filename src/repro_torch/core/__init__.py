"""Index build, three-pass search and the streaming mutable index
(counterpart of ``repro.core``)."""

from .streaming import DeltaShard, MutableState, search_mutable  # noqa: F401
