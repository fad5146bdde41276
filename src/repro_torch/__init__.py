"""repro_torch: the PyTorch and CUDA port of the partitioning system.

A package of its own beside the JAX reference ``repro``: it imports torch
and numpy, never jax or ``repro``. Entry points take ``device="cuda"`` by
default and run the hand-written CUDA kernels of ``csrc/`` on the card;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""
