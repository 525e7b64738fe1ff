"""What the job kinds share: the transform key, the device argument, the
port's cache reset and the reference fusion of a grid."""

from __future__ import annotations

import numpy as np
import torch

from portbench import data
from portbench.reference import compare
from portbench.reference import fusion as ref_fusion

KEY = "affine_metadata"


def port_device(device: str):
    """The port's ``device`` argument: its default (the CUDA device) on the
    card, "cpu" in the CPU tests."""
    return None if device == "cuda" else device


def clear_port_caches() -> None:
    """Empty the port's device tile cache, plan cache and upload stashes, so
    that the next job pays what a new dataset pays, and collect the last
    job's garbage, so that no job pays for another's."""
    import gc

    from multiview_stitcher_torch.fusion import _core

    _core.clear_device_tile_cache()
    gc.collect()


def release(device: str) -> None:
    """Free the program's device state once the window has closed."""
    clear_port_caches()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_fusion(grid: data.Grid, device: str, origins_px=None, dtype=torch.float32):
    """The plain fusion of ``grid``'s tiles at ``origins_px`` (pixels; the
    metadata origins by default) on ``device``: (image, origin, shape)."""
    origins = grid.meta if origins_px is None else origins_px
    tiles = torch.from_numpy(grid.tiles).to(device)
    out = ref_fusion.fuse(tiles, np.asarray(origins) * grid.spacing, grid.spacing, dtype=dtype)
    del tiles
    return out


def image_numbers(got, ref: torch.Tensor) -> dict:
    """``compare.image_numbers`` of a host or device image against ``ref``."""
    got_t = torch.from_numpy(np.ascontiguousarray(got)) if isinstance(got, np.ndarray) else got
    return compare.image_numbers(got_t.to(ref.device), ref)


def origin_px(got_origin: dict, sdims, ref_origin, spacing: float) -> float:
    """The largest gap, in pixels, between an output's origin and the
    reference's."""
    got = np.array([float(got_origin[d]) for d in sdims])
    return float(np.abs(got - np.asarray(ref_origin)).max() / spacing)


def worst(numbers: list) -> dict:
    """Per name, the largest value over several outputs' numbers."""
    out: dict = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out
