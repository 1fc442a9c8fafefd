"""Measurement on one CUDA device: the device-time helper, the
micro-benchmark of kernel K6, and the drivers that print one JSON record
each (``reconstruct`` for ``bench.py``; ``profile_sift``, ``match_kernel``,
``nview``, ``pose``, ``dense``, ``scaling`` for the ``scripts/`` drivers),
sharing ``scene``."""
