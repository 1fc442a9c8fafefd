"""Interval arithmetic over the program's own ranges in a traced run.

The program opens a profiler range named ``stage.<name>`` at each of its
layers (``ssrlcv_tpu_torch.logging.Logger.span``); ``trace.collect`` keeps
them in ``Trace.spans`` on the device trace's clock.  The per-layer readers
of one layer's ranges take from here the union of those ranges, the share
of it in which the card ran nothing, and its seconds.  A program without a
layer's ranges gives ``None`` throughout.
"""

from __future__ import annotations


def ranges(trace, name: str) -> list:
    """(start_ns, end_ns) of every range named ``name``."""
    return [(a, b) for n, a, b in trace.spans if n == name]


def union(intervals) -> list:
    """The union of ``intervals`` as sorted, disjoint (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_ns(xs: list, ys: list) -> int:
    """The length of the intersection of two unions (``union``'s form)."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(trace, name: str):
    """The share (%) of the union of the ranges named ``name`` in which no
    operation ran on the card; None without such a range."""
    if trace is None:
        return None
    spans = union(ranges(trace, name))
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    busy = overlap_ns(spans, union((a, b) for _, a, b in trace.device_ops))
    return 100.0 * (1.0 - busy / total)


def seconds(trace, names) -> float:
    """Seconds of the union of the ranges named any of ``names``."""
    spans = union(r for name in names for r in ranges(trace, name))
    return sum(b - a for a, b in spans) / 1e9
