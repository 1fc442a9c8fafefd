"""Set-up: from the start of the benchmark's process to the window's
first job (imports, CUDA initialisation, the kernel library's build or
load, the pool's rendering, one warm job)."""


def read(run):
    return run.setup_s
