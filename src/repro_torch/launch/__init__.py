"""Launchers of the port (counterpart of ``repro.launch``): ``serve`` (the
LM, retrieval and cluster modes) and ``train``."""
