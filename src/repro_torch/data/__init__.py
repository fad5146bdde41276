"""Deterministic synthetic data (the port's copy of the JAX package's
``data/``)."""
from .pipeline import Batch, SyntheticStream

__all__ = ["Batch", "SyntheticStream"]
