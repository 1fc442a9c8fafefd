"""K3's (csrc/match.cu: the layout and the matcher) share (%) of its
roofline in the traced jobs: the least time of its calls (each the larger
of 2 x 128 int8 operations for every pair the pass needs -- every live
pair on a seed pass, the gated pairs on a constrained one -- at the H100's
int8 peak, and each input byte read once and each output byte written
once at its memory rate) over its device time by kernel name."""

from benchmark import counts
from benchmark.trace import K3_KERNEL


def read(run):
    if run.trace is None or not run.trace.k3_calls:
        return None
    kernel_s = run.trace.kernel_s(K3_KERNEL)
    if kernel_s <= 0:
        return None
    least = 0.0
    for c in run.trace.k3_calls:
        pairs = counts.gated_pairs(c["q_mask"], c["t_valid"], c["p1"], c["p2"], c["t_loc"],
                                   c["eps"])
        least += counts.bound(counts.nbytes(*c["tensors"]), pairs * counts.K3_OPS_PER_PAIR,
                              "int8")["bound_s"]
    return 100.0 * least / kernel_s
