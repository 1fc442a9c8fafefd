"""The benchmark of ``ssrlcv_tpu_torch`` on one NVIDIA H100: a stream of
2-view and 3-view reconstructions timed through ``run_pipeline``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the measurement rests on lives here, where the program cannot
change it: the scene generator (``scene.py``), the job loop and its timing
(``harness.py``), the trace readers (``trace.py``, ``metrics/``), the
operation and byte counts of the kernels (``counts.py``), the plain
reference (``reference/``) and the comparison that decides ``correct``
(``compare.py``).  A cell is ``workloads/<cell>.json``, a deployment
``configs/<config>.json``, a per-layer metric ``metrics/<metric>.py``: the
harness finds each by its name.
"""
