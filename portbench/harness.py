"""The engine of the port's benchmark, driven by data.

A run of one cell (an entry of ``workloads`` in ``BENCHMARK.json``) finds
everything it needs by name, under the benchmark's folder:

- the configuration's file, as ``BENCHMARK.json`` names it;
- ``traffic/<traffic>.json``: the job kind and its parameters (pacing, the
  port's keyword arguments, how many job outputs the check samples);
- ``jobs/<kind>.py``: the job kind, a ``Job`` class (its methods are in
  ``README.md``);
- ``cells/<workload>.json``: the limit of each number the check compares;
- ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader a metric, ``read(run)`` giving a number or None.

The run makes the cell's inputs from the seed, warms the job up once, then
starts jobs until the window's seconds have passed (paced as the traffic
says) and times each from its call to its synchronised result. A traced run
then runs ``traced_jobs`` more jobs (the traffic's, 3 by default) under the
profiler: the window's jobs, untraced, give the host spans, and the traced
jobs the device's activity. After that it reads the peak device memory,
frees the program's state, reads the metrics and compares the sampled
outputs with the plain reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "multiview_stitcher_tpu")


class BenchError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise BenchError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def folder(self) -> Path:
        return self.root / self.bench["paths"][0]

    def metrics(self, section: str) -> list:
        """The metrics of ``section`` ("end_to_end" or "per_layer") this cell
        reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise BenchError(f"no configuration {entry['config']!r} in BENCHMARK.json")
    folder = root / bench["paths"][0]
    config = _load_json(root / configs[0]["file"])
    traffic = _load_json(folder / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(folder / "cells" / f"{workload}.json")
    return Cell(root, bench, entry, config, traffic, limits)


def job_class(cell: Cell):
    kind = cell.traffic["job"]
    return load_module(cell.folder / "jobs" / f"{kind}.py", f"portbench_job_{kind}").Job


def reader(cell: Cell, section_dir: str, metric: str):
    mod = load_module(cell.folder / section_dir / f"{metric}.py",
                      f"portbench_{section_dir}_{metric.replace('.', '_')}")
    return mod.read


def planned_start(k: int, now: float, seconds: float, pacing: dict) -> float | None:
    """When job ``k`` starts, in seconds from the window's start, with the
    previous job done at ``now``; None when the window starts no more jobs.
    ``{"mode": "back_to_back"}``: at once, while the window is open.
    ``{"mode": "slots", "jobs": n}``: job k at ``k * seconds / n`` or at
    ``now``, whichever is later, and only the first n. The first job always
    starts, however long its preparation took."""
    mode = pacing.get("mode", "back_to_back")
    if mode == "back_to_back":
        start = now
    elif mode == "slots":
        n = int(pacing["jobs"])
        if k >= n:
            return None
        start = max(now, k * seconds / n)
    else:
        raise BenchError(f"unknown pacing {mode!r}")
    return start if start < seconds or k == 0 else None


@dataclass
class Run:
    """What a finished window gives the metric readers: the window's jobs'
    records (``wall_s``, ``start_s``, the port's telemetry of the job and
    what the job kind adds), in a traced run the records of the traced jobs
    that follow the window and their trace, the cell and set-up."""

    cell: Cell
    jobs: list
    seconds: float
    setup_s: float
    traced_jobs: list = field(default_factory=list)
    trace: object = None


class _Sample:
    """A reservoir of ``cap`` job outputs, drawn from the seed."""

    def __init__(self, cap: int, seed: int):
        self.cap = cap
        self.rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x5EED])
        self.kept: dict = {}
        self.seen = 0

    def offer(self, k: int, output) -> None:
        self.seen += 1
        if len(self.kept) < self.cap:
            self.kept[k] = output
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.cap:
            del self.kept[sorted(self.kept)[j]]
            self.kept[k] = output


def _card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, workdir: str, log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    job = job_class(cell)(cell.config, cell.traffic, seed, device, workdir)
    job.setup()
    job.warm()
    sync()
    pacing = cell.traffic.get("pacing", {"mode": "back_to_back"})
    sample = _Sample(int(cell.traffic.get("check_jobs", 2)), seed)
    records, failed = [], 0
    from portbench.telemetry import JOB, Probe, Trace

    probe = Probe()

    def timed(k, span=contextlib.nullcontext()):
        probe.start()
        t0 = time.perf_counter()
        with span:
            rec = job.run(k)
            sync()
        t1 = time.perf_counter()
        rec.update(probe.finish(), wall_s=t1 - t0)
        return rec, t0

    t_win = time.perf_counter()
    setup_s = t_win - t_start
    k = 0
    while True:
        job.before(k)
        start = planned_start(k, time.perf_counter() - t_win, seconds, pacing)
        if start is None:
            break
        delay = start - (time.perf_counter() - t_win)
        if delay > 0:
            time.sleep(delay)
        try:
            rec, t0 = timed(k)
        except Exception:  # a failed job ends the window and the run is not correct
            log(traceback.format_exc(), file=sys.stderr)
            failed += 1
            break
        rec["start_s"] = t0 - t_win
        sample.offer(k, rec.pop("output", None))
        records.append(rec)
        k += 1
    sync()
    log("jobs: wall_s " + " ".join(f"{r['wall_s']:.4f}" for r in records), file=sys.stderr)
    traced, prof = [], None
    if trace and not failed:
        # the profiler slows the host, so the window's jobs run untraced and
        # give the host spans; a few more jobs after it run traced and give
        # the device's activity
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            for i in range(int(cell.traffic.get("traced_jobs", 3))):
                job.before(k + i)
                try:
                    rec, _ = timed(k + i, record_function(JOB))
                except Exception:
                    log(traceback.format_exc(), file=sys.stderr)
                    failed += 1
                    break
                rec.pop("output", None)
                traced.append(rec)
        log("traced jobs: wall_s " + " ".join(f"{r['wall_s']:.4f}" for r in traced),
            file=sys.stderr)
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded after the window: {found}")
    run = Run(cell=cell, jobs=records, seconds=seconds, setup_s=setup_s, traced_jobs=traced)
    if prof is not None:
        t_read = time.perf_counter()
        run.trace = Trace.from_profiler(prof)
        log(f"trace: read in {time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    del prof
    job.release()

    metrics = {}
    if not trace:
        for m in cell.metrics("end_to_end"):
            value = setup_s if m["name"] == "setup_s" else (
                reader(cell, "e2e_metrics", m["name"])(run) if records else None)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.metrics("per_layer"):
            value = reader(cell, "layer_metrics", m["name"])(run) if records else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    numbers = job.check(sample.kept) if sample.kept else {}
    checks, ok = {}, failed == 0 and bool(records)
    for name, value in numbers.items():
        limit = cell.limits["limits"].get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": float(value), "limit": limit}
    if set(cell.limits["limits"]) - set(numbers):
        ok = False  # a number the cell holds was not read
    job.close()

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.workload.get("chips", 1)),
           "memory_peak_bytes": memory_peak}
    result = {"correct": bool(ok), "attempted": len(records) + len(traced) + failed,
              "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["checks"] = checks
    return result


def main(argv=None, t_start=None, root: Path = ROOT, device: str = "cuda",
         port_root: Path | None = ROOT) -> int:
    """The command line: run one cell found under ``root`` on ``device``
    and print its result; the port must come from ``port_root`` (the
    checkout), when given."""
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def err(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        cell = load_cell(root, args.workload)
        import torch

        import multiview_stitcher_torch

        port = Path(multiview_stitcher_torch.__file__).resolve()
        if port_root is not None and Path(port_root).resolve() not in port.parents:
            raise BenchError(f"the port was imported from {port}, outside {port_root}")
        if device == "cuda":
            need = int(cell.workload.get("chips", 1))
            if not torch.cuda.is_available() or torch.cuda.device_count() < need:
                raise BenchError(f"the cell needs {need} CUDA device(s); "
                                 f"{torch.cuda.device_count()} available")
            err(f"card: {_card_line()}")
        workdir = tempfile.mkdtemp(prefix="portbench-")
        try:
            result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                              t_start, workdir, log=print)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        found = forbidden_modules()
        if found:
            raise BenchError(f"modules loaded in the run: {found}")
    except (BenchError, ImportError, OSError) as exc:
        err(f"portbench: {type(exc).__name__}: {exc}")
        return 2
    for name, c in result["checks"].items():
        verdict = "ok" if c["limit"] is not None and c["value"] <= c["limit"] else "FAIL"
        err(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
