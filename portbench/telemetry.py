"""What the harness reads of the port, and of the profiler's trace.

The port publishes: the stage registry of ``utils.profiling`` (host wall
time a stage, e.g. ``fuse.plan``), ``fusion._streaming.last_telemetry`` (a
new dict for each streamed pass), ``registration.last_telemetry`` (refilled
by each ``register()``) and a ``launches`` counter on each kernel wrapper.
The harness only reads them; it replaces nothing of the port.

The trace is ``torch.profiler``'s, over the traced jobs that follow the
window, each job's timed part inside a ``record_function`` span named
:data:`JOB`.
"""

from __future__ import annotations

import numpy as np

JOB = "portbench.job"
# the kernel wrappers' modules, whose ``launches`` counters are read
_COUNTED_MODULES = (
    "multiview_stitcher_torch.ops.translation_fusion",
    "multiview_stitcher_torch.ops.exact_affine",
)
# how many of the longest idle gaps are labelled by the host's activity
_LABELLED_GAPS = 400


def _launch_counters() -> dict:
    import importlib

    found = {}
    for name in _COUNTED_MODULES:
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int):
                found[attr] = obj.launches
    return found


class Probe:
    """The port's published telemetry around one job: ``start()`` before the
    timed call, ``finish()`` after it; ``finish`` returns the job's share."""

    def start(self) -> None:
        from multiview_stitcher_torch import registration
        from multiview_stitcher_torch.fusion import _streaming
        from multiview_stitcher_torch.utils import profiling

        self._stages = {k: v["total_s"] for k, v in profiling.get_stage_times().items()}
        self._launches = _launch_counters()
        self._stream = _streaming.last_telemetry
        self._registration = dict(registration.last_telemetry)

    def finish(self) -> dict:
        from multiview_stitcher_torch import registration
        from multiview_stitcher_torch.fusion import _streaming
        from multiview_stitcher_torch.utils import profiling

        stages = {
            k: v["total_s"] - self._stages.get(k, 0.0)
            for k, v in profiling.get_stage_times().items()
            if v["total_s"] - self._stages.get(k, 0.0) > 0
        }
        launches = {k: v - self._launches.get(k, 0) for k, v in _launch_counters().items()}
        stream = _streaming.last_telemetry
        reg = dict(registration.last_telemetry)
        return {
            "stages": stages,
            "launches": {k: v for k, v in launches.items() if v},
            # the last streamed pass of the job, if it streamed
            "stream": dict(stream) if stream is not self._stream else {},
            "registration": reg if reg != self._registration else {},
        }


def _union(intervals) -> list:
    """Sorted, merged copy of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


class Trace:
    """Device and host activity of a traced window, in microseconds on the
    profiler's clock. ``jobs`` are the timed parts of the jobs; host
    activity is that of the thread that ran the jobs.

    ``events``: (start_us, end_us, name, on_device, is_annotation, thread)
    tuples."""

    def __init__(self, events):
        self.jobs, dev, host = [], [], []
        for a, b, name, on_device, annotation, thread in events:
            if name == JOB:
                if not on_device:
                    self.jobs.append((a, b, thread))
            elif on_device:
                if not annotation and b > a:
                    dev.append((a, b, name))
            elif b > a:
                host.append((a, b, name, thread))
        self.jobs.sort()
        main = {t for _, _, t in self.jobs}
        self.jobs = [(a, b) for a, b, _ in self.jobs]
        host = [h for h in host if h[3] in main]
        self._host_start = np.array([h[0] for h in host], dtype=np.float64)
        self._host_end = np.array([h[1] for h in host], dtype=np.float64)
        self._host_name = [h[2] for h in host]
        self._dev_start = np.array([d[0] for d in dev], dtype=np.float64)
        self._dev_end = np.array([d[1] for d in dev], dtype=np.float64)
        self._dev_name = np.array([d[2] for d in dev], dtype=object)
        merged = _union(list(zip(self._dev_start.tolist(), self._dev_end.tolist())))
        busy = []
        for lo, hi in self.jobs:
            busy += _clip(merged, lo, hi)
        self._busy = _union(busy)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """From a finished ``torch.profiler.profile``, reading its raw events
        (the profiler's own event tree is not built: it costs minutes on a
        window of many small launches)."""
        from torch.autograd import DeviceType

        raw = prof.profiler.kineto_results
        t0 = raw.trace_start_ns()
        return cls(
            ((e.start_ns() - t0) / 1e3, (e.start_ns() - t0 + e.duration_ns()) / 1e3, e.name(),
             e.device_type() != DeviceType.CPU, e.is_user_annotation(), e.start_thread_id())
            for e in raw.events())

    def window_s(self) -> float:
        """The jobs' own time."""
        return sum(b - a for a, b in self.jobs) / 1e6

    def busy_s(self) -> float:
        """Time within the jobs in which a kernel, copy or set ran."""
        return sum(b - a for a, b in self._busy) / 1e6

    def _overlap(self) -> np.ndarray:
        """Each device operation's time within the jobs, us."""
        total = np.zeros(len(self._dev_start))
        for lo, hi in self.jobs:
            total += np.clip(np.minimum(self._dev_end, hi) - np.maximum(self._dev_start, lo),
                             0, None)
        return total

    def device_s(self, name_part: str) -> float:
        """Device time within the jobs of the operations whose name holds
        ``name_part``."""
        hit = np.array([name_part in n for n in self._dev_name], dtype=bool)
        return float(self._overlap()[hit].sum()) / 1e6 if hit.size else 0.0

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...] of the device operations with the most time
        within the jobs."""
        sums: dict = {}
        for name, us in zip(self._dev_name, self._overlap()):
            if us > 0:
                sums[name] = sums.get(name, 0.0) + us / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def _gaps(self) -> list:
        gaps = []
        for lo, hi in self.jobs:
            t = lo
            for a, b in _clip(self._busy, lo, hi):
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if hi > t:
                gaps.append((t, hi))
        return gaps

    def _host_label(self, a: float, b: float) -> str:
        """The operation of the jobs' thread that overlaps the gap (a, b)
        most."""
        over = np.minimum(self._host_end, b) - np.maximum(self._host_start, a)
        if not over.size or over.max() <= 0:
            return "host: no torch op on the jobs' thread"
        return f"host: {self._host_name[int(over.argmax())]}"

    def idle_gaps(self, n: int = 10) -> list:
        """[[label, seconds], ...]: the longest idle gaps within the jobs,
        summed by what the jobs' thread was doing in them."""
        gaps = sorted(self._gaps(), key=lambda g: g[0] - g[1])[:_LABELLED_GAPS]
        sums: dict = {}
        for a, b in gaps:
            label = self._host_label(a, b)
            sums[label] = sums.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def mean_ms(jobs, value) -> float | None:
    """The mean over ``jobs`` of ``value(job)`` seconds, in ms; None where a
    job has no value."""
    vals = [value(j) for j in jobs]
    if not vals or any(v is None for v in vals):
        return None
    return float(np.mean(vals)) * 1e3


def idle_pct(run) -> float | None:
    """The share of the traced jobs' own time in which no kernel, copy or
    set ran on the card, %."""
    if run.trace is None or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())


def plan_ms(run) -> float | None:
    """The port's host plan (its ``fuse.plan`` stage) a job of the window, ms."""
    return mean_ms(run.jobs, lambda j: j["stages"].get("fuse.plan"))
