"""Measurement on one CUDA device: the device-time helper and the
micro-benchmarks of the port's kernels."""
