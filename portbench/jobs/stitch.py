"""Job kind ``stitch``: ``stitch()`` of host tiles: register, resolve, fuse.

A job is one ``stitch(msims, transform_key=..., register_kwargs=...)`` of
the configuration's tiles (host arrays at their stage positions), from empty
caches; the msims it is given carry the resolved transforms back. The check
holds every sampled job's resolved tile positions against the generator's
truth (the median error of neighbours' relative positions), and its fused
image and origin against the plain reference fusion of the same tiles under the
job's resolved positions.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import data, jobkit
from portbench.reference import registration as ref_reg

NEW_KEY = "registered"


class Job:
    def __init__(self, config, traffic, seed, device, workdir):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device

    def setup(self):
        self.grid = data.make_grid(self.config, self.seed, self.device)
        self.sims = data.to_sims(self.grid, jobkit.KEY)
        rkw = dict(self.traffic.get("register_kwargs", {}))
        tol = self.traffic.get("overlap_tolerance_px")
        if tol is not None:
            rkw["overlap_tolerance"] = {d: tol * self.grid.spacing for d in self.grid.sdims}
        self.register_kwargs = rkw
        self.pairs = ref_reg.grid_pairs(self.config["grid"])

    def _stitch(self):
        from multiview_stitcher_torch import msi_utils
        from multiview_stitcher_torch.stitch import stitch

        msims = [msi_utils.get_msim_from_sim(s, scale_factors=[]) for s in self.sims]
        fused = stitch(msims, transform_key=jobkit.KEY, new_transform_key=NEW_KEY,
                       register_kwargs=self.register_kwargs,
                       device=jobkit.port_device(self.device))
        return msims, fused

    def warm(self):
        jobkit.clear_port_caches()
        self._stitch()

    def before(self, k):
        jobkit.clear_port_caches()

    def run(self, k):
        from multiview_stitcher_torch import msi_utils

        msims, fused = self._stitch()
        affines = np.stack([
            np.asarray(msi_utils.get_transform_from_msim(m, NEW_KEY).data, dtype=np.float64)
            .reshape(-1, len(self.grid.sdims) + 1, len(self.grid.sdims) + 1)[0]
            for m in msims])
        image = fused.data
        return {"output": (image, dict(fused.origin), affines), "out_voxels": int(image.size)}

    def release(self):
        jobkit.release(self.device)

    def _numbers(self, image, origin, affines, dtype=None) -> tuple:
        placed = ref_reg.placed_origins(affines, self.grid.meta, self.grid.spacing)
        ref, ref_origin, _ = jobkit.reference_fusion(self.grid, self.device, origins_px=placed)
        nums = {
            "link_px": ref_reg.link_error_px(affines, self.grid.meta, self.grid.truth,
                                             self.grid.spacing, self.pairs),
        }
        if dtype is not None:  # the control: the reference in ``dtype`` in the program's place
            image, origin_arr, _ = jobkit.reference_fusion(self.grid, self.device,
                                                           origins_px=placed, dtype=dtype)
            origin = dict(zip(self.grid.sdims, origin_arr))
        nums.update(jobkit.image_numbers(image, ref))
        nums["origin_px"] = jobkit.origin_px(origin, self.grid.sdims, ref_origin,
                                             self.grid.spacing)
        return nums

    def check(self, outputs: dict) -> dict:
        return jobkit.worst([self._numbers(*out) for out in outputs.values()])

    def control(self) -> dict:
        """The reference in the program's place: the plain registration of
        whole pixels on the registration channel (``reference.registration``)
        and the fusion under its positions in bfloat16."""
        g = self.grid
        channel = int(self.register_kwargs.get("reg_channel_index", 0))
        reg = g.tiles[:, channel] if "c" in g.dims else g.tiles
        offsets = ref_reg.pairwise_offsets(reg, g.meta, self.pairs)
        centre = int(np.ravel_multi_index([n // 2 for n in self.config["grid"]],
                                          self.config["grid"]))
        positions = ref_reg.shortest_path_positions(len(g.meta), self.pairs, offsets, centre)
        affines = ref_reg.translation_affines(positions, g.meta, g.spacing)
        return self._numbers(None, None, affines, dtype=torch.bfloat16)

    def close(self):
        self.sims = self.grid = None
