"""Job kind ``fuse_views``: ``fuse()`` of registered multi-view stacks into
one isotropic host volume.

A job is one ``fuse(sims, transform_key=...)`` of the configuration's views,
held as host arrays, each under the affine that registration left on it,
onto the traffic's output spacing, from empty caches (tiles, plans,
stashes): every job pays what a new data set pays. The check compares every
sampled job's volume, and its origin, with the plain affine fusion
(``reference/affine_fusion.py``) of the same views under the same affines.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench import jobkit, multiview, roofline
from portbench.reference import affine_fusion


class Job:
    def __init__(self, config, traffic, seed, device, workdir):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.kwargs = dict(traffic.get("fuse_kwargs", {}))

    def setup(self):
        self.views = multiview.make_views(self.config, self.seed, self.device)
        self.sims = multiview.to_sims(self.views, jobkit.KEY)

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
        image = np.asarray(out.data)
        shape = self.views.views.shape
        return {
            "output": (image, dict(out.origin)),
            "out_voxels": int(image.size),
            "kernel_bytes": roofline.fusion_bytes(shape[0], shape[1:], image.shape),
        }

    def release(self):
        jobkit.release(self.device)

    def _reference(self, dtype=torch.float32):
        views = torch.from_numpy(self.views.views).to(self.device)
        out, origin, _, near = affine_fusion.fuse(
            views, self.views.spacing, self.views.affines, self.views.output_spacing,
            dtype=dtype)
        del views
        print(f"reference: {near} voxels within {affine_fusion.FACE_PX} px of a view's face "
              "decided by the float32 frame", file=sys.stderr)
        return out, origin

    def check(self, outputs: dict) -> dict:
        ref, ref_origin = self._reference()
        nums = []
        for image, origin in outputs.values():
            n = jobkit.image_numbers(image, ref)
            n["origin_px"] = jobkit.origin_px(origin, multiview.SPATIAL, ref_origin,
                                              self.views.output_spacing)
            nums.append(n)
        return jobkit.worst(nums)

    def control(self) -> dict:
        """The numbers of the reference computed in bfloat16 in the program's
        place."""
        ref, ref_origin = self._reference()
        low, low_origin = self._reference(torch.bfloat16)
        n = jobkit.image_numbers(low, ref)
        n["origin_px"] = float(np.abs(low_origin - ref_origin).max()
                               / self.views.output_spacing)
        return n

    def close(self):
        self.sims = self.views = None
