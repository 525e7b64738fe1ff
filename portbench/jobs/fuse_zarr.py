"""Job kind ``fuse_zarr``: ``fuse()`` of zarr tiles into an OME-Zarr store.

Set-up writes every tile of the configuration as its own zarr v2 array (one
chunk a tile) under the run's temporary directory and opens them lazily, as
a user's acquisition on disk. A job is one ``fuse(lazy, transform_key=...,
output_chunksize=..., output_zarr_url=...)`` into a store of its own, which
writes level 0, every pyramid level and the metadata, from empty caches.
The check reads each store back with a plain reader and compares level 0,
every pyramid level, the number of levels and the origin in the metadata
with the plain reference fusion and its plain pyramid.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from portbench import data, jobkit, roofline
from portbench.reference import pyramid, zarr_read


class Job:
    def __init__(self, config, traffic, seed, device, workdir):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.workdir = workdir
        self.kwargs = dict(traffic.get("fuse_kwargs", {}))

    def setup(self):
        from multiview_stitcher_torch.io import zarr_backend

        self.grid = data.make_grid(self.config, self.seed, self.device)
        arrays = []
        for v, tile in enumerate(self.grid.tiles):
            url = os.path.join(self.workdir, "tiles", f"tile_{v:05d}.zarr")
            arr = zarr_backend.create_zarr_array(url, tile.shape, tile.shape, tile.dtype)
            arr[...] = tile
            arrays.append(zarr_backend.open_zarr_array(url))
        self.sims = data.to_sims(self.grid, jobkit.KEY, arrays=arrays)

    def _store(self, k) -> str:
        return os.path.join(self.workdir, f"fused_{k}.ome.zarr")

    def _fuse(self, url):
        from multiview_stitcher_torch.fusion import fuse

        return fuse(self.sims, transform_key=jobkit.KEY, output_zarr_url=url,
                    device=jobkit.port_device(self.device), **self.kwargs)

    def warm(self):
        jobkit.clear_port_caches()
        self._fuse(self._store("warm"))
        shutil.rmtree(self._store("warm"), ignore_errors=True)

    def before(self, k):
        jobkit.clear_port_caches()

    def run(self, k):
        url = self._store(k)
        out = self._fuse(url)
        spatial = out.data.shape[-len(self.grid.sdims):]
        return {
            "output": url,
            "out_voxels": int(np.prod(out.data.shape)),
            "kernel_bytes": roofline.fusion_bytes(
                len(self.grid.tiles), self.grid.tiles.shape[-len(spatial):], spatial),
        }

    def release(self):
        jobkit.release(self.device)

    def _reference(self, dtype, pyramid_dtype):
        img, origin, _ = jobkit.reference_fusion(self.grid, self.device, dtype=dtype)
        return img, origin, pyramid.pyramid(img, len(self.grid.sdims), pyramid_dtype)

    def _numbers(self, level0, levels, origin, n_datasets, ref) -> dict:
        ref0, ref_origin, ref_levels = ref
        nums = jobkit.image_numbers(level0, ref0)
        nums = {"level0_max_counts": nums["max_counts"], "level0_mean_counts": nums["mean_counts"]}
        worst = 0.0
        for got, want in zip(levels, ref_levels):
            worst = max(worst, jobkit.image_numbers(got, want)["max_counts"])
        nums["pyramid_max_counts"] = worst
        nums["levels_gap"] = float(abs(n_datasets - (len(ref_levels) + 1)))
        nums["origin_px"] = float(abs(origin - ref_origin).max() / self.grid.spacing)
        return nums

    def check(self, outputs: dict) -> dict:
        ref = self._reference(torch.float32, torch.float64)
        nums = []
        for url in outputs.values():
            ms = zarr_read.read_attrs(url)["multiscales"][0]
            paths = [d["path"] for d in ms["datasets"]]
            level0 = zarr_read.read_array(os.path.join(url, paths[0]))
            levels = [zarr_read.read_array(os.path.join(url, p)) for p in paths[1:]]
            levels += [np.zeros((0,), level0.dtype)] * max(0, len(ref[2]) - len(levels))
            origin = np.array(next(t["translation"] for t in
                                   ms["datasets"][0]["coordinateTransformations"]
                                   if t["type"] == "translation"), dtype=float)
            origin = origin[-len(self.grid.sdims):]
            nums.append(self._numbers(level0, levels, origin, len(paths), ref))
        return jobkit.worst(nums)

    def control(self) -> dict:
        """The numbers of the reference computed in bfloat16 in the
        program's place, its pyramid means in bfloat16 too."""
        ref = self._reference(torch.float32, torch.float64)
        low0, low_origin, low_levels = self._reference(torch.bfloat16, torch.bfloat16)
        return self._numbers(low0, low_levels, low_origin, len(low_levels) + 1, ref)

    def close(self):
        self.sims = self.grid = None
