"""Launchers of the port (counterpart of ``repro.launch``): the retrieval
modes of ``serve``."""
