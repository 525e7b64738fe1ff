"""Readings of the port's program spans (``utils.profiling`` stages).

In the window's jobs a stage is the ``Probe``'s per-job delta of its total,
summed over the threads that recorded it. In the trace of the traced jobs a
stage is a ``record_function`` range on the jobs' thread: a program span is a
host event there whose name is a stage's name. A reader returns None where
the port records no such stage or span.
"""

from __future__ import annotations

import numpy as np

from portbench.telemetry import _union, mean_ms

PAIRWISE = "register.pairwise_registrations"


def stage_ms(name: str):
    """A reader of the stage ``name`` a job of the window, ms."""
    return lambda run: mean_ms(run.jobs, lambda j: j["stages"].get(name))


def _stage_names() -> set:
    from multiview_stitcher_torch.utils import profiling

    return set(profiling.get_stage_times())


def _spans(trace, names) -> list:
    """The merged (start, end) of the jobs' thread's host events named in
    ``names``, us."""
    return _union((a, b) for a, b, n in zip(trace._host_start, trace._host_end,
                                            trace._host_name) if n in names)


def _overlap_us(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unspanned_pct(run) -> float | None:
    """The share of the traced jobs' idle time (the gaps that ``idle_pct``
    counts) inside no program span on the jobs' thread, %."""
    trace = run.trace
    if trace is None:
        return None
    spans = _spans(trace, _stage_names())
    gaps = trace._gaps()
    idle = sum(b - a for a, b in gaps)
    if not spans or idle <= 0:
        return None
    return 100.0 * (1.0 - _overlap_us(gaps, spans) / idle)


def pairwise_launches(run) -> float | None:
    """Device kernels (not copies or sets) that start inside the traced jobs'
    pairwise-registration spans, over those jobs' crop-shape buckets."""
    trace = run.trace
    if trace is None or not trace._dev_start.size:
        return None
    spans = _spans(trace, {PAIRWISE})
    buckets = sum(j["registration"].get("buckets", 0) for j in run.traced_jobs)
    if not spans or not buckets:
        return None
    kernel = np.array([not n.startswith(("Memcpy", "Memset")) for n in trace._dev_name],
                      dtype=bool)
    starts = np.sort(trace._dev_start[kernel])
    inside = sum(int(np.searchsorted(starts, b) - np.searchsorted(starts, a))
                 for a, b in spans)
    return inside / buckets
