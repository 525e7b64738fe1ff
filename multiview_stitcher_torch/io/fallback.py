"""First-party catch-all image reader (PNG/JPEG/BMP/GIF/...).

The port of ``multiview_stitcher_tpu.io.fallback``. Upstream
multiview-stitcher delegates every non-CZI format to the optional
``aicsimageio`` package; here common everyday formats get a first-party
reader built on ``imageio``/PIL instead: single- or multi-frame 2D images
are mapped onto the sim data model with pixel-center coordinates and (where
the file carries it) physical pixel sizes. Without imageio the reader
raises ``ImportError``.

Scope: formats imageio can decode without extra plugins (PNG, JPEG, BMP,
GIF, PPM/PGM, ...).  TIFF/CZI/Imaris/OME-Zarr have richer dedicated
readers elsewhere in :mod:`multiview_stitcher_torch.io` and never reach
this module.  Formats imageio cannot decode raise a clear error that
also mentions the optional aicsimageio escape hatch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from multiview_stitcher_torch import si_utils

__all__ = [
    "read_image_into_sim",
    "read_image_into_sims",
    "can_read",
]

# Suffixes imageio's built-in plugins decode without optional extras.
_IMAGEIO_SUFFIXES = {
    ".png",
    ".jpg",
    ".jpeg",
    ".bmp",
    ".gif",
    ".ppm",
    ".pgm",
    ".pbm",
    ".pnm",
    ".webp",
}


def can_read(filepath) -> bool:
    """True when :func:`read_image_into_sim` should be able to decode
    ``filepath`` (by suffix; decode errors still surface on read)."""
    return Path(filepath).suffix.lower() in _IMAGEIO_SUFFIXES


def _physical_pixel_sizes(meta: dict) -> dict:
    """Extract per-axis physical pixel sizes from imageio metadata.

    PNG ``pHYs`` chunks arrive as ``resolution`` in dots-per-unit with
    ``unit`` ('meter' or unknown); JPEG JFIF density likewise.  Only a
    *meaningful* resolution (non-unit, positive) is converted; otherwise
    unit spacing is kept, matching upstream's ``or 1.0`` guard on
    aicsimageio's pixel sizes.
    """
    res = meta.get("dpi") or meta.get("resolution")
    if not res:
        return {}
    try:
        rx, ry = float(res[0]), float(res[1])
    except (TypeError, ValueError, IndexError):
        return {}
    if rx <= 0 or ry <= 0 or (rx == 1.0 and ry == 1.0):
        return {}
    if "dpi" in meta:  # dots/inch -> micrometers/pixel
        # 72/96 dpi are screen placeholders written by default (e.g.
        # PIL's BMP plugin), not physical calibration — ignore them.
        if any(abs(rx - d) < 0.5 and abs(ry - d) < 0.5 for d in (72, 96)):
            return {}
        scale = 25400.0
    else:
        unit = str(meta.get("unit", "")).lower()
        # dots per meter -> micrometers per pixel; anything else: per-dot.
        scale = 1e6 if unit in ("meter", "m") else 1.0
    return {"x": scale / rx, "y": scale / ry}


def _frames_to_sim(frames, meta, transform_key, c_coords=None):
    """Stack decoded frames (each (Y, X) or (Y, X, C)) into one sim."""
    arr = np.asarray(frames[0]) if len(frames) == 1 else np.stack(frames)
    multi_t = len(frames) > 1

    if arr.ndim == 2 + multi_t:  # grayscale
        dims = ("y", "x")
    elif arr.ndim == 3 + multi_t:  # interleaved color -> leading c
        arr = np.moveaxis(arr, -1, 0 if not multi_t else 1)
        dims = ("c", "y", "x")
        if c_coords is None:
            c_coords = ["R", "G", "B", "A"][: arr.shape[int(multi_t)]]
    else:
        raise ValueError(
            f"unsupported decoded image rank {arr.ndim} "
            f"(shape {arr.shape})"
        )
    if multi_t:
        dims = ("t",) + dims

    return si_utils.get_sim_from_array(
        arr,
        dims=dims,
        scale=_physical_pixel_sizes(meta) or None,
        c_coords=c_coords,
        transform_key=transform_key,
    )


def read_image_into_sim(
    filepath,
    transform_key=si_utils.DEFAULT_TRANSFORM_KEY,
):
    """Read any imageio-decodable image file into a single sim.

    Multi-frame files (e.g. animated GIF) map frames onto a ``t``
    dimension; interleaved color maps onto ``c`` with RGB(A) channel
    names.  Physical pixel sizes are taken from the file's resolution
    metadata when present (PNG pHYs / JFIF density), else unit spacing.
    First-party replacement for upstream's aicsimageio catch-all.
    """
    import imageio.v3 as iio

    filepath = Path(filepath)
    try:
        meta = iio.immeta(filepath, exclude_applied=False)
    except Exception:
        meta = {}

    frames = []
    try:
        for frame in iio.imiter(filepath):
            frames.append(np.asarray(frame))
    except Exception:
        frames = []
    if not frames:
        # Some plugins lack iteration support; fall back to one read.
        frames = [np.asarray(iio.imread(filepath))]

    return _frames_to_sim(frames, meta, transform_key)


def read_image_into_sims(filepath, scene_index: int = 0):
    """List-of-sims wrapper so the dispatcher's contract (one sim per
    tile) holds for plain image files: they are a single tile."""
    if scene_index not in (0, None):
        raise ValueError(
            f"plain image files have a single scene (got scene_index="
            f"{scene_index})"
        )
    return [read_image_into_sim(filepath)]
