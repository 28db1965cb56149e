"""Index build and three-pass search (counterpart of ``repro.core``)."""
