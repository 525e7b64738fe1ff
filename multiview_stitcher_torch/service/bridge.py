"""Task transport between a session and stateless compute workers.

The port of ``multiview_stitcher_tpu.service.bridge``: a bridge moves JSON
task documents to workers and JSON results back, in batches
(``dispatch(tasks, batch_size, progress)``). :class:`LocalBridge` runs them
in process through a private :class:`~.worker.WorkerRuntime`;
:class:`ProcessPoolBridge` through a pool of OS processes. Other transports
(RPC, job queues) subclass :class:`Bridge` and implement ``run_batch``.

Contract, shared by all transports:

- a task is one JSON-safe dict with a ``"task"`` field naming the handler
  in :class:`~.worker.WorkerRuntime`;
- the session spec travels inside the task; workers cache rebuilt sessions
  keyed by the spec (which carries the generation), so state is reopened
  once, not per task;
- image data never crosses the bridge: workers reopen the sources;
- a worker's error raises to the caller of ``dispatch``.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional


class Bridge:
    """Transport for JSON task batches. Subclass and implement run_batch."""

    def run_batch(self, task_jsons: List[str]) -> List[str]:
        raise NotImplementedError

    def dispatch(
        self,
        tasks: List[dict],
        batch_size: int = 128,
        progress: Optional[Callable[[int, int], None]] = None,
    ) -> List[dict]:
        """Run tasks in batches; returns one result dict per task."""
        results: List[dict] = []
        n = len(tasks)
        for lo in range(0, n, batch_size):
            batch = tasks[lo : lo + batch_size]
            raw = self.run_batch([json.dumps(t) for t in batch])
            if len(raw) != len(batch):
                raise RuntimeError(
                    f"bridge returned {len(raw)} results for {len(batch)} tasks"
                )
            results.extend(json.loads(r) for r in raw)
            if progress is not None:
                progress(len(results), n)
        return results

    def close(self):
        pass


class LocalBridge(Bridge):
    """In-process transport through a private WorkerRuntime on ``device``
    (the CUDA device by default).

    Runs the whole serialize → rebuild-from-spec → deserialize path without
    extra processes: the session the caller holds is never touched by the
    worker side.
    """

    def __init__(self, device=None):
        from multiview_stitcher_torch.service.worker import WorkerRuntime

        self._runtime = WorkerRuntime(device=device)

    def run_batch(self, task_jsons: List[str]) -> List[str]:
        return [self._runtime.run_task(t) for t in task_jsons]


_POOL_RUNTIME = None


def _pool_worker_init(platform: Optional[str]) -> None:
    """Make the worker process's runtime on the torch device ``platform``
    names (None: the CUDA device). Raises where that device is missing,
    which breaks the pool: no worker falls back to the CPU."""
    global _POOL_RUNTIME  # noqa: PLW0603
    from multiview_stitcher_torch.service.worker import WorkerRuntime

    _POOL_RUNTIME = WorkerRuntime(device=platform)


def _pool_worker_run(task_json: str) -> str:
    # one WorkerRuntime per worker process, kept for the pool's lifetime so
    # its session cache persists across batches
    return _POOL_RUNTIME.run_task(task_json)


class ProcessPoolBridge(Bridge):
    """OS-process worker pool transport.

    Workers start by ``spawn``: a forked process cannot use CUDA, and each
    worker reaches the device on its own.

    ``platform`` names each worker's torch device (``"cpu"``, ``"cuda"``,
    ``"cuda:1"``); None means the CUDA device. A worker that finds no such
    device raises, and ``dispatch`` raises with it.
    """

    def __init__(self, n_workers: int = 2, platform: Optional[str] = None):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        from multiview_stitcher_torch.utils import misc as misc_utils

        misc_utils.resolve_device(platform)  # raises at once where it is missing
        self._pool = ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_pool_worker_init,
            initargs=(platform,),
        )

    def run_batch(self, task_jsons: List[str]) -> List[str]:
        return list(self._pool.map(_pool_worker_run, task_jsons))

    def close(self):
        self._pool.shutdown(wait=True)
