"""The port's experiments: each module runs one of the repository's
benchmarks on the port and writes its results under ``experiments/torch/``."""
