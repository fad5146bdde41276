"""Runtime checks of the port: :mod:`repro_torch.analysis.sanitize`.

The JAX package's ``analysis/`` also holds its static lint rules; they
lint the port's sources as they stand (``python -m repro.analysis src``).
"""
