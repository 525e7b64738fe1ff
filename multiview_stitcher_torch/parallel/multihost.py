"""Multi-process (multi-host) execution.

The port of ``multiview_stitcher_tpu.parallel.multihost``. Stitching scales
past one machine by handing disjoint output-block subsets to separate
processes that attach to one shared zarr store. Here the processes form a
``torch.distributed`` group over the gloo backend, which carries only the
control plane (the barriers): the data go through disjoint zarr region
writes, so no NCCL is needed. Each process fuses on its own CUDA device,
``cuda:{LOCAL_RANK % device_count}``, unless the caller names one.

Single-process runs need no set-up: :func:`initialize` is a no-op,
:func:`process_info` reports (0, 1), and :func:`multihost_fuse` fuses
everything locally, so the same driver script runs unchanged on one machine
or under ``torchrun``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from multiview_stitcher_torch.parallel.executors import (
    SourceSpec,
    fuse_block_subset,
    partition_blocks,
)

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Join the ``torch.distributed`` process group (gloo) of a
    multi-process job.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    process 0, ``num_processes`` the world size and ``process_id`` this
    process's rank; ``kwargs`` go to ``init_process_group`` (for example
    ``timeout``). Unset arguments are read from torch.distributed's own
    variables, as ``torchrun`` sets them: ``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. With none of them set this is a no-op
    (single process), and so is a repeat call."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE") is not None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK") is not None:
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR") is not None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs the coordinator address, the number of "
            f"processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}"
        )
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=coordinator_address, world_size=int(num_processes),
        rank=int(process_id), **kwargs,
    )
    logger.info(
        "torch.distributed initialized: process %d / %d",
        dist.get_rank(), dist.get_world_size(),
    )


def process_info() -> tuple:
    """(process_index, process_count) of this host ((0, 1) single-process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sync(name: str = "mvs_tpu_sync") -> None:
    """Barrier across hosts (no-op single-process). ``name`` labels the
    barrier in the log."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        logger.debug("barrier %s", name)
        dist.barrier()


def partition_for_this_host(n_items: int) -> list:
    """Disjoint contiguous item-index subset owned by this host."""
    pid, n = process_info()
    return partition_blocks(n_items, n, pid)


def _local_device():
    """This process's CUDA device (``LOCAL_RANK`` modulo the devices), or
    None without CUDA (``fuse`` then raises, naming the CPU option)."""
    if not torch.cuda.is_available():
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def multihost_fuse(
    source_specs: Sequence[SourceSpec],
    output_zarr_url: str,
    transform_key: str,
    output_chunksize=None,
    device=None,
    **fuse_kwargs,
):
    """Fuse a dataset across all processes of a multi-process job.

    Process 0 creates the output store; all processes barrier, then each
    fuses its disjoint output-chunk subset on ``device`` (by default its
    local CUDA device) into it (chunk-aligned zarr region writes never
    collide). Returns after a final barrier so every process sees the
    complete store. Run the same script in every process."""
    initialize()
    if device is None:
        device = _local_device()
    pid, n = process_info()
    if pid == 0:
        fuse_block_subset(
            source_specs,
            output_zarr_url,
            transform_key,
            worker_index=0,
            n_workers=n,
            output_chunksize=output_chunksize,
            create_output=True,
            create_only=True,
            device=device,
            **fuse_kwargs,
        )
    sync("mvs_tpu_fuse_created")
    fuse_block_subset(
        source_specs,
        output_zarr_url,
        transform_key,
        worker_index=pid,
        n_workers=n,
        output_chunksize=output_chunksize,
        create_output=False,
        device=device,
        **fuse_kwargs,
    )
    sync("mvs_tpu_fuse_done")
    return output_zarr_url
