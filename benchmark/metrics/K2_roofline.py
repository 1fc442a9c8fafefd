"""K2's (csrc/desc.cu) share (%) of its roofline in the traced jobs: the
least time of its launches (each the larger of its operations at the
H100's float32 peak and its bytes at its memory rate, counted from the
launch's inputs by counts.py) over its device time by kernel name."""

from benchmark import counts
from benchmark.trace import K2_KERNEL


def read(run):
    if run.trace is None or not run.trace.k2_calls:
        return None
    kernel_s = run.trace.kernel_s(K2_KERNEL)
    if kernel_s <= 0:
        return None
    least = 0.0
    for c in run.trace.k2_calls:
        ops = counts.k2_samples(c["theta"], c["sigma"], c["pw"], c["lam"], c["w_max"])
        least += counts.bound(counts.nbytes(*c["tensors"]),
                              ops * counts.K2_OPS_PER_SAMPLE, "fp32")["bound_s"]
    return 100.0 * least / kernel_s
