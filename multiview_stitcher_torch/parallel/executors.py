"""Work-description executors for distributed stitching.

The port of ``multiview_stitcher_tpu.parallel.executors``: work units are
described as small JSON-serializable specs (never image data: workers
reopen their views from the spec), and pluggable executors run them
locally, over a process pool, or across hosts.

- ``pairwise_executor(msims, edges, register_kwargs)`` for
  :func:`..registration.register`: :func:`make_spec_pairwise_executor` runs
  the pairwise-registration edge batch through :class:`RegistrationTaskSpec`
  units and returns one {'transform', 'quality', 'bbox'} per edge.
- block partitioning for fusion into one store: any process may attach to
  the output zarr array and fuse a disjoint block subset;
  :func:`partition_blocks` computes the per-worker subsets and
  :func:`fuse_block_subset` runs one.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# work specs (JSON-serializable; data is rebuilt at the worker)
# ---------------------------------------------------------------------------


@dataclass
class SourceSpec:
    """How a worker reopens one view: a file URL + transform overrides.

    OME-Zarr URLs open directly; any other suffix goes through the mosaic
    dispatcher (``io.read_mosaic_into_sims``), where ``scene_index`` picks
    the scene and ``view_index`` the tile/view within it (mosaic files yield
    several views from one file).
    """

    url: str
    transform_key: str = "affine_metadata"
    origin: Optional[Dict[str, float]] = None
    affines: Dict[str, list] = field(default_factory=dict)
    scene_index: int = 0
    view_index: int = 0

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "SourceSpec":
        return cls(**json.loads(s))

    def open_sim(self):
        from multiview_stitcher_torch import param_utils
        from multiview_stitcher_torch.io import ngff_utils

        if str(self.url).endswith((".zarr", ".ome.zarr")):
            sim = ngff_utils.read_sim_from_ome_zarr(
                self.url, transform_key=self.transform_key
            )
        else:
            from multiview_stitcher_torch import io as msio

            sims = msio.read_mosaic_into_sims(
                self.url, scene_index=self.scene_index
            )
            if not 0 <= self.view_index < len(sims):
                raise IndexError(
                    f"view_index {self.view_index} out of range: "
                    f"{self.url} scene {self.scene_index} has "
                    f"{len(sims)} views"
                )
            sim = sims[self.view_index]
        if self.origin is not None:
            sim.origin = dict(self.origin)
        for key, mat in self.affines.items():
            sim.transforms[key] = param_utils.to_xaffine(np.asarray(mat))
        return sim

    def open_msim(self):
        from multiview_stitcher_torch import msi_utils

        return msi_utils.get_msim_from_sim(self.open_sim(), scale_factors=[])


@dataclass
class RegistrationTaskSpec:
    """One pairwise-registration work unit."""

    fixed: SourceSpec
    moving: SourceSpec
    transform_key: str
    register_kwargs: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "fixed": asdict(self.fixed),
                "moving": asdict(self.moving),
                "transform_key": self.transform_key,
                "register_kwargs": self.register_kwargs,
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "RegistrationTaskSpec":
        d = json.loads(s)
        return cls(
            fixed=SourceSpec(**d["fixed"]),
            moving=SourceSpec(**d["moving"]),
            transform_key=d["transform_key"],
            register_kwargs=d["register_kwargs"],
        )

    def run(self) -> dict:
        from multiview_stitcher_torch import registration

        result = registration.register_pair_of_msims(
            self.fixed.open_msim(),
            self.moving.open_msim(),
            transform_key=self.transform_key,
            **self.register_kwargs,
        )
        return {
            "transform": np.asarray(result["transform"].squeeze()).tolist(),
            "quality": (
                None
                if result["quality"] is None
                or (np.isscalar(result["quality"]) and np.isnan(result["quality"]))
                else float(np.asarray(result["quality"]))
            ),
            "bbox": np.asarray(result["bbox"]).tolist(),
        }


def _run_registration_task_json(spec_json: str) -> dict:
    return RegistrationTaskSpec.from_json(spec_json).run()


def make_spec_pairwise_executor(
    source_specs: Sequence[SourceSpec],
    batch_func: Optional[Callable] = None,
):
    """Build a ``pairwise_executor`` that ships JSON task specs to workers.

    ``batch_func(fn, items) -> results`` defaults to sequential execution;
    pass e.g. :func:`..utils.misc.process_batch_using_processes` to fan the
    edge batch over worker processes (each reopens its views from the spec;
    no image data is serialized). The call's ``device`` travels by name.
    """
    from multiview_stitcher_torch import param_utils
    from multiview_stitcher_torch.utils import misc as misc_utils

    if batch_func is None:
        batch_func = misc_utils.process_batch_sequential

    def pairwise_executor(msims, edges, register_kwargs):
        kwargs = dict(register_kwargs)
        transform_key = kwargs.pop("transform_key")
        kwargs.pop("pairwise_executor", None)
        kwargs.pop("n_parallel_pairwise_regs", None)
        if isinstance(kwargs.get("device"), torch.device):
            kwargs["device"] = str(kwargs["device"])
        # only JSON-safe kwargs travel
        kwargs = {
            k: v
            for k, v in kwargs.items()
            if isinstance(v, (int, float, str, bool, dict, list, type(None)))
        }
        specs = [
            RegistrationTaskSpec(
                fixed=source_specs[i],
                moving=source_specs[j],
                transform_key=transform_key,
                register_kwargs=kwargs,
            ).to_json()
            for i, j in edges
        ]
        raw = batch_func(_run_registration_task_json, specs)
        results = []
        for r in raw:
            results.append(
                {
                    "transform": param_utils.affine_to_xaffine(
                        np.asarray(r["transform"])
                    ),
                    "quality": (
                        np.nan if r["quality"] is None else r["quality"]
                    ),
                    "bbox": np.asarray(r["bbox"]),
                }
            )
        return results

    return pairwise_executor


# ---------------------------------------------------------------------------
# block partitioning for fusion into one shared store
# ---------------------------------------------------------------------------


def partition_blocks(n_blocks: int, n_workers: int, worker_index: int) -> List[int]:
    """Disjoint, contiguous block-index subset for one worker."""
    per = math.ceil(n_blocks / n_workers)
    return list(range(worker_index * per, min((worker_index + 1) * per, n_blocks)))


def fuse_block_subset(
    source_specs: Sequence[SourceSpec],
    output_zarr_url: str,
    transform_key: str,
    worker_index: int,
    n_workers: int,
    output_chunksize=None,
    create_output: bool = False,
    create_only: bool = False,
    block_ids: Optional[Sequence[int]] = None,
    device=None,
    **fuse_kwargs,
):
    """Fuse this worker's disjoint chunk subset into a shared output store.

    ``create_only=True`` creates the output array and returns immediately
    (multi-host driver: host 0 creates, all hosts barrier, everyone fuses).

    ``block_ids`` overrides the contiguous partition with an explicit block
    subset (a scheduler may assign ids itself).

    Worker 0 (or any single caller with ``create_output=True``) creates the
    output array, a plain zarr v2 array; every other worker attaches. Each
    block is fused by :func:`..fusion.fuse` on ``device`` (the CUDA device
    by default) and written as one region. Returns the number of blocks
    fused.
    """
    from multiview_stitcher_torch import fusion, msi_utils, mv_graph, si_utils
    from multiview_stitcher_torch.fusion import _core
    from multiview_stitcher_torch.io import zarr_backend

    sims = [
        msi_utils.get_sim_from_msim(spec.open_msim()) for spec in source_specs
    ]
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    ndim = len(sdims)
    if output_chunksize is None:
        output_chunksize = si_utils.get_default_spatial_chunksizes(ndim)
    elif not isinstance(output_chunksize, dict):
        output_chunksize = {d: int(output_chunksize) for d in sdims}

    field_sims = [si_utils.get_sim_field(s) for s in sims]
    osp = _core.process_output_stack_properties(
        field_sims, transform_key=transform_key
    )
    osp = {
        k: {d: (int(v[d]) if k == "shape" else float(v[d])) for d in sdims}
        for k, v in osp.items()
    }
    chunk_bbs, _ = mv_graph.get_chunk_bbs(osp, output_chunksize)
    if block_ids is not None:
        bad = [b for b in block_ids if not 0 <= int(b) < len(chunk_bbs)]
        if bad:
            raise ValueError(
                f"block_ids {bad} out of range for {len(chunk_bbs)} blocks"
            )
        my_blocks = set(int(b) for b in block_ids)
    else:
        my_blocks = set(
            partition_blocks(len(chunk_bbs), n_workers, worker_index)
        )

    nsdims = [d for d in sims[0].dims if d not in sdims]
    out_shape = tuple(sims[0].sizes[d] for d in nsdims) + tuple(
        osp["shape"][d] for d in sdims
    )
    if create_output and worker_index == 0:
        zarr_backend.create_zarr_array(
            output_zarr_url,
            shape=out_shape,
            chunks=tuple(1 for _ in nsdims)
            + tuple(
                min(output_chunksize[d], osp["shape"][d]) for d in sdims
            ),
            dtype=np.dtype(sims[0].dtype),
            zarr_format=2,
            overwrite=True,
        )
    if create_only:
        return 0
    out_arr = zarr_backend.attach_zarr_array(output_zarr_url)

    for bi in sorted(my_blocks):
        bb = chunk_bbs[bi]
        fused = fusion.fuse(
            sims,
            transform_key=transform_key,
            output_stack_properties={
                "origin": bb["origin"],
                "spacing": bb["spacing"],
                "shape": bb["shape"],
            },
            output_chunksize=output_chunksize,
            device=device,
            **fuse_kwargs,
        )
        starts = [
            int(
                round(
                    (bb["origin"][d] - osp["origin"][d]) / osp["spacing"][d]
                )
            )
            for d in sdims
        ]
        region = tuple(slice(None) for _ in nsdims) + tuple(
            slice(s, s + int(bb["shape"][d])) for s, d in zip(starts, sdims)
        )
        out_arr[region] = fused.to_numpy()
    return len(my_blocks)
