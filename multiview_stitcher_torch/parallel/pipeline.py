"""Sharded register and fuse batches.

The port of ``multiview_stitcher_tpu.parallel.pipeline``: the two hot
batches of stitching, split along their leading axis over a
:class:`~.mesh.Mesh`, one call per mesh entry on its device.

- pairwise registration: the ``(N_pairs, *crop)`` batch of overlap crops,
  each part through ``ops.phase_correlation.phase_cross_correlation_batch``;
  every pair is independent, so no data crosses devices;
- fusion: the chunk batch, each part through the gather-resample chunk
  kernel (``fusion._core._fuse_chunk_batch_kernel``) or the exact-affine
  kernels (``_fuse_chunk_batch_kernel_exact``); each entry owns a disjoint
  set of output chunks.

Every part is issued before any result is read; the results are joined on
the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from multiview_stitcher_torch.fusion._core import (
    _fuse_chunk_batch_kernel,
    _fuse_chunk_batch_kernel_exact,
)
from multiview_stitcher_torch.ops import exact_affine as ea
from multiview_stitcher_torch.ops import phase_correlation as pc_ops
from multiview_stitcher_torch.parallel import mesh as mesh_utils
from multiview_stitcher_torch.utils import misc as misc_utils


def _host(x) -> np.ndarray:
    """A table as a numpy array (tensors are copied to the host)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sharded_pairwise_shifts(
    fixed_batch,
    moving_batch,
    mesh,
    upsample_factor: int = 10,
    normalization: str = "phase",
):
    """Batched subpixel shifts with the pair axis sharded across the mesh.

    Inputs: (N, *crop) float arrays or tensors; N need not divide the mesh
    size. Returns (shifts (N, ndim), peaks (N,)) on the mesh's first device.
    """
    mesh = mesh_utils.check_mesh(mesh)
    fixed = torch.as_tensor(fixed_batch)
    moving = torch.as_tensor(moving_batch)
    results = [
        pc_ops.phase_cross_correlation_batch(
            fixed[sl].to(d), moving[sl].to(d), upsample_factor, normalization
        )
        for sl, d in mesh_utils.shard_parts(len(fixed), mesh)
    ]
    return tuple(mesh_utils.gather(r, mesh.devices[0]) for r in zip(*results))


def sharded_fuse_chunks(
    slabs, mats, offs, wgrids, wmats, woffs, valid,
    out_shape: tuple,
    mesh,
    mode: str = "weighted_average",
    use_bw: bool = True,
):
    """Fused chunk kernel with the chunk axis sharded across the mesh:
    (B, K, *S) slabs and their (B, K, ...) tables; returns the float32
    (B, *out_shape) fused batch on the mesh's first device."""
    mesh = mesh_utils.check_mesh(mesh)
    slabs = torch.as_tensor(slabs)
    tables = [_host(a) for a in (mats, offs, wgrids, wmats, woffs, valid)]
    parts = [
        _fuse_chunk_batch_kernel(
            slabs[sl].to(d), *(t[sl] for t in tables), tuple(out_shape), mode, use_bw
        )
        for sl, d in mesh_utils.shard_parts(len(slabs), mesh)
    ]
    return mesh_utils.gather(parts, mesh.devices[0])


def register_and_fuse_step(
    fixed_batch,
    moving_batch,
    slabs, mats, offs, wgrids, wmats, woffs, valid,
    out_shape: tuple,
    upsample_factor: int = 2,
    device=None,
):
    """One combined step: batched pairwise shifts + batched chunk fusion, on
    ``device`` (the CUDA device by default). Returns (shifts, peaks, fused)."""
    device = misc_utils.resolve_device(device)
    shifts, peaks = pc_ops.phase_cross_correlation_batch(
        torch.as_tensor(fixed_batch).to(device), torch.as_tensor(moving_batch).to(device),
        upsample_factor,
    )
    fused = _fuse_chunk_batch_kernel(
        torch.as_tensor(slabs).to(device), *(_host(a) for a in (mats, offs, wgrids, wmats, woffs)),
        _host(valid), tuple(out_shape), "weighted_average", True,
    )
    return shifts, peaks, fused


def sharded_fuse_chunks_exact(
    slabs, mats, offs, extents, wgrids, wmats, woffs, valid,
    out_shape: tuple,
    mesh,
    mode: str = "weighted_average",
    use_bw: bool = True,
):
    """The exact-affine chunk kernels with the chunk axis sharded across the
    mesh (multi-device rotated multi-view fusion): each entry's part runs
    through ``_fuse_chunk_batch_kernel_exact`` on its device, which launches
    the exact-affine kernels for CUDA tensors. The 3D kernel is the
    y-decoupled one when every view map and, with ``use_bw``, every weight
    map is y-decoupled, else the general one, which reads every coupling
    term. The batch size need not divide the mesh size. Returns the float32
    (N, *out_shape) fused chunk batch on the mesh's first device."""
    mesh = mesh_utils.check_mesh(mesh)
    ndim = len(out_shape)
    mats = _host(mats).astype(np.float32)
    wmats = _host(wmats).astype(np.float32)
    kind = "2d"
    if ndim == 3:
        coupled = not ea.is_y_decoupled(mats.reshape(-1, 3, 3)) or (
            use_bw and not ea.is_y_decoupled(wmats.reshape(-1, 3, 3))
        )
        kind = "general" if coupled else "sepy"
    slabs = torch.as_tensor(slabs)
    tables = [mats, _host(offs), _host(extents), _host(wgrids), wmats, _host(woffs),
              _host(valid)]
    parts = [
        _fuse_chunk_batch_kernel_exact(
            slabs[sl].to(d), *(t[sl] for t in tables), tuple(out_shape), mode, use_bw, kind,
        )
        for sl, d in mesh_utils.shard_parts(len(slabs), mesh)
    ]
    return mesh_utils.gather(parts, mesh.devices[0])
