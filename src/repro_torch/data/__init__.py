from .hybrid_synth import HybridDataset, make_hybrid_dataset  # noqa: F401
