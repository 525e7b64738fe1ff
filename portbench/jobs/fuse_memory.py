"""Job kind ``fuse_memory``: ``fuse()`` of host tiles into a host image.

A job is one ``fuse(sims, transform_key=...)`` of the configuration's tiles,
held as host arrays, into a host result, from empty caches (tiles, plans,
stashes): every job pays what a new dataset pays. The check compares every
sampled job's image, and its origin, with the plain reference fusion of the
same tiles at the same stage positions.
"""

from __future__ import annotations

import torch

from portbench import data, jobkit, roofline


class Job:
    def __init__(self, config, traffic, seed, device, workdir):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.kwargs = dict(traffic.get("fuse_kwargs", {}))

    def setup(self):
        self.grid = data.make_grid(self.config, self.seed, self.device)
        self.sims = data.to_sims(self.grid, jobkit.KEY)

    def _fuse(self):
        from multiview_stitcher_torch.fusion import fuse

        return fuse(self.sims, transform_key=jobkit.KEY,
                    device=jobkit.port_device(self.device), **self.kwargs)

    def warm(self):
        jobkit.clear_port_caches()
        self._fuse()

    def before(self, k):
        jobkit.clear_port_caches()

    def run(self, k):
        out = self._fuse()
        image = out.data
        spatial = image.shape[-len(self.grid.sdims):]
        channels = image.shape[0] if image.ndim > len(spatial) else 1
        return {
            "output": (image, dict(out.origin)),
            "out_voxels": int(image.size),
            "kernel_bytes": roofline.fusion_bytes(
                len(self.grid.tiles), self.grid.tiles.shape[-len(spatial):], spatial, channels),
        }

    def release(self):
        jobkit.release(self.device)

    def check(self, outputs: dict) -> dict:
        ref, ref_origin, _ = jobkit.reference_fusion(self.grid, self.device)
        nums = []
        for image, origin in outputs.values():
            n = jobkit.image_numbers(image, ref)
            n["origin_px"] = jobkit.origin_px(origin, self.grid.sdims, ref_origin,
                                              self.grid.spacing)
            nums.append(n)
        return jobkit.worst(nums)

    def control(self) -> dict:
        """The numbers of the reference computed in bfloat16 in the program's
        place."""
        ref, ref_origin, _ = jobkit.reference_fusion(self.grid, self.device)
        low, low_origin, _ = jobkit.reference_fusion(self.grid, self.device, dtype=torch.bfloat16)
        n = jobkit.image_numbers(low, ref)
        n["origin_px"] = float(abs(low_origin - ref_origin).max() / self.grid.spacing)
        return n

    def close(self):
        self.sims = self.grid = None
