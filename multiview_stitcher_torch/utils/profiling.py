"""Profiling and per-stage timing hooks.

The port of ``multiview_stitcher_tpu.utils.profiling``: a registry of stage
wall times that ``register()`` (``register.adjacency_graph``,
``register.pairwise_registrations``, ``register.groupwise_resolution``) and
``fuse()`` (``fuse.plan``) record into, a context manager around
``torch.profiler`` for device-level traces (a Chrome trace, viewable in
Perfetto), and a timer that waits for the CUDA devices a result lies on.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

_STAGE_TIMES: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time under a stage name.

    >>> with profiling.stage("pairwise_batch"):
    ...     run_pairwise(...)
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _STAGE_TIMES[name] += dt
        _STAGE_COUNTS[name] += 1
        logger.debug("stage %s: %.3fs (total %.3fs)", name, dt, _STAGE_TIMES[name])


def get_stage_times() -> Dict[str, dict]:
    return {
        k: {"total_s": _STAGE_TIMES[k], "count": _STAGE_COUNTS[k]}
        for k in _STAGE_TIMES
    }


def reset_stage_times():
    _STAGE_TIMES.clear()
    _STAGE_COUNTS.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block: CPU activity, and CUDA
    activity where a CUDA device is present. On exit the Chrome trace is
    written to ``log_dir/trace.json`` (``log_dir`` defaults to a new
    directory under the temporary directory). Yields the profiler, whose
    ``key_averages()`` sums the recorded ops by name."""
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
