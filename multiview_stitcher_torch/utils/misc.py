"""Small host-side utilities, and the device an entry point runs on.

The port's copy of ``multiview_stitcher_tpu.utils.misc``: Otsu's threshold;
the decorators by which a fusion or weights function declares the chunk halo
or the source shrinkage it needs, which the fusion planner reads; block batch
iteration and the batch executors (sequential, threads, processes, and
joblib, ray and dask where those packages import); logging helpers. Also the
context in which matmuls and convolutions run at full float32 precision.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import logging
from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch


def threshold_otsu(values: np.ndarray, nbins: int = 256) -> float:
    """Otsu threshold of a 1-D sample (the finite values of ``values``)."""
    values = np.asarray(values, dtype=float).ravel()
    values = values[np.isfinite(values)]
    if values.size == 0:
        return 0.0
    vmin, vmax = float(values.min()), float(values.max())
    if vmin == vmax:
        return vmin
    hist, bin_edges = np.histogram(values, bins=nbins, range=(vmin, vmax))
    hist = hist.astype(float)
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    mean1 = np.cumsum(hist * bin_centers) / np.maximum(weight1, 1e-32)
    mean2 = (np.cumsum((hist * bin_centers)[::-1]) / np.maximum(weight2[::-1], 1e-32))[::-1]
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    return float(bin_centers[int(np.argmax(variance12))])


def requires_overlap(overlap_spec):
    """Declare that a fusion/weights func needs chunk halo context.

    ``overlap_spec`` is a value or callable(kwargs)->value giving the required
    overlap (int or dict per dim); the fusion planner reads
    ``func.required_overlap``.
    """

    def deco(func):
        func.required_overlap = (
            overlap_spec if callable(overlap_spec) else (lambda kwargs: overlap_spec)
        )
        return func

    return deco


def requires_source_shrinkage(shrinkage_spec):
    """Declare that a func needs source bounding boxes shrunk inward."""

    def deco(func):
        func.required_source_shrinkage = (
            shrinkage_spec if callable(shrinkage_spec) else (lambda kwargs: shrinkage_spec)
        )
        return func

    return deco


def get_required_overlap(func, kwargs) -> object:
    spec = getattr(func, "required_overlap", None)
    return spec(kwargs) if spec is not None else 0


def get_required_source_shrinkage(func, kwargs) -> object:
    spec = getattr(func, "required_source_shrinkage", None)
    return spec(kwargs) if spec is not None else 0


def has_keyword(func, keyword: str) -> bool:
    """Whether ``func`` names ``keyword`` among its parameters. Only named
    parameters count: a ``**kwargs`` catch-all does not signal that a func
    wants a given input."""
    if func is None:
        return False
    try:
        sig = inspect.signature(func)
    except (TypeError, ValueError):
        return False
    return keyword in sig.parameters


def ndindex_batches(nblocks: Sequence[int], batch_size: int) -> Iterable[List[tuple]]:
    """Batches of ``batch_size`` block indices over an n-D block grid, in
    C order."""
    it = itertools.product(*[range(n) for n in nblocks])
    while True:
        batch = list(itertools.islice(it, batch_size))
        if not batch:
            return
        yield batch


def process_batch_sequential(func: Callable, batch: Sequence) -> list:
    return [func(item) for item in batch]


def process_batch_using_threads(func: Callable, batch: Sequence, n_workers: int = 8) -> list:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        return list(ex.map(func, batch))


def process_batch_using_processes(func: Callable, batch: Sequence, n_workers: int = 4) -> list:
    """Worker processes started by spawn (this process has threads, which
    fork does not carry safely); ``func`` must pickle by its import path."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=n_workers,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(func, batch))


def supports_process_scheduler() -> bool:
    import multiprocessing

    try:
        multiprocessing.get_context("spawn")
        return True
    except ValueError:
        return False


def process_batch_using_joblib(func: Callable, batch: Sequence, n_workers: int = 4,
                               backend: str = "loky") -> list:
    """joblib batch executor; raises ImportError where joblib is absent."""
    try:
        from joblib import Parallel, delayed
    except ImportError as e:
        raise ImportError("joblib is not installed") from e
    return Parallel(n_jobs=n_workers, backend=backend)(delayed(func)(item) for item in batch)


def process_batch_using_ray(func: Callable, batch: Sequence) -> list:
    """ray batch executor; raises ImportError where ray is absent."""
    try:
        import ray
    except ImportError as e:
        raise ImportError("ray is not installed") from e
    if not ray.is_initialized():
        ray.init(ignore_reinit_error=True)
    remote_func = ray.remote(func)
    return ray.get([remote_func.remote(item) for item in batch])


def process_batch_using_dask(func: Callable, batch: Sequence, scheduler: str = "threads") -> list:
    """dask batch executor; raises ImportError where dask is absent."""
    try:
        import dask
    except ImportError as e:
        raise ImportError("dask is not installed") from e
    tasks = [dask.delayed(func)(item) for item in batch]
    return list(dask.compute(*tasks, scheduler=scheduler))


@contextlib.contextmanager
def temporary_log_level(logger, level):
    """Set ``logger``'s level inside a with-block, restoring it after."""
    old_level = logger.level
    logger.setLevel(level)
    try:
        yield logger
    finally:
        logger.setLevel(old_level)


class DisableLogger:
    """Context manager silencing all logging."""

    def __enter__(self):
        logging.disable(logging.CRITICAL)

    def __exit__(self, exit_type, exit_value, exit_traceback):
        logging.disable(logging.NOTSET)


def clear_cupy_memory():
    """The reference's release of the device memory pool: here the blocks
    that torch's CUDA caching allocator holds and no tensor uses."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another. Raises where CUDA is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this runs on the CUDA device by default and this machine has "
            "none; pass device='cpu' for the plain PyTorch path"
        )
    return device


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions without TF32 inside the
    block (the reference computes them in float32), restoring the caller's
    settings after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
