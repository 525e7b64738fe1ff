"""Profiling and per-stage timing hooks.

The port of ``multiview_stitcher_tpu.utils.profiling``: a registry of stage
wall times that ``register()`` (``register.adjacency_graph``,
``register.pairwise_registrations``, ``register.groupwise_resolution``) and
``fuse()`` record into, a context manager around ``torch.profiler`` for
device-level traces (a Chrome trace, viewable in Perfetto), and a timer that
waits for the CUDA devices a result lies on.

``fuse()`` records ``fuse.plan`` (the host plan), ``tiles.upload`` (the tile
stack to the device: cache lookup, reads, the copy), ``fuse.download`` (the
wait for the fused output and its copy out) and, writing an OME-Zarr,
``fuse.pyramid`` (every level above 0). A streamed pass records
``stream.pass`` (its band loop and waits), ``stream.seed_cache`` (the tile
stack it leaves in the device tile cache) and, on its worker threads,
``stream.read`` (a batch's tile reads) and ``stream.write`` (a band's write to
the sink). The batched tier records ``batched.tables`` (its kernel tables, on
a plan that has none yet), ``batched.resample`` (a batch's resample of its
views' data and blending grids) and ``batched.blend`` (a batch's blend over
the views, its cast, and the copy of its chunks into the output). Stages of
one thread do not enclose one another, except that ``register.*`` encloses
what registration calls.

While a ``torch.profiler`` records on the calling thread, a stage is also a
``record_function`` range of its name, so that the trace shows the program's
stages on the profiler's clock beside the device's activity.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import record_function

logger = logging.getLogger(__name__)

_STAGE_TIMES: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)
# stages are recorded from worker threads too
_STAGE_LOCK = threading.Lock()
# whether a profiler records on the calling thread
_profiler_enabled = torch.autograd._profiler_enabled


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time under a stage name, and mark it in the trace of a
    ``torch.profiler`` that records on this thread. Also a decorator.

    >>> with profiling.stage("pairwise_batch"):
    ...     run_pairwise(...)
    """
    span = record_function(name) if _profiler_enabled() else None
    if span is not None:
        span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _STAGE_LOCK:
            _STAGE_TIMES[name] += dt
            _STAGE_COUNTS[name] += 1
            total = _STAGE_TIMES[name]
        if span is not None:
            span.__exit__(None, None, None)
        logger.debug("stage %s: %.3fs (total %.3fs)", name, dt, total)


def get_stage_times() -> Dict[str, dict]:
    with _STAGE_LOCK:
        return {
            k: {"total_s": _STAGE_TIMES[k], "count": _STAGE_COUNTS[k]}
            for k in _STAGE_TIMES
        }


def reset_stage_times():
    with _STAGE_LOCK:
        _STAGE_TIMES.clear()
        _STAGE_COUNTS.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block: CPU activity, and CUDA
    activity where a CUDA device is present. On exit the Chrome trace is
    written to ``log_dir/trace.json`` (``log_dir`` defaults to a new
    directory under the temporary directory). Yields the profiler, whose
    ``key_averages()`` sums the recorded ops by name; the block's stages
    appear in the trace under their names."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="torch-trace-")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (nested tuples, lists and
    dicts)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def block_and_time(fn, *args, **kwargs):
    """Run ``fn``, wait until every CUDA device that holds a tensor of the
    result is done, and return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0
