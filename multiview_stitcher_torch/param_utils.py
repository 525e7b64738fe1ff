"""Affine parameter algebra (copy of ``multiview_stitcher_tpu.param_utils``).

An affine over ndim spatial dims is an ``(ndim+1, ndim+1)`` homogeneous
matrix acting on column vectors ordered ``(z, y, x)`` (or ``(y, x)`` in 2D);
a "transform key" affine maps intrinsic physical coordinates
(origin + spacing * index) into a named world coordinate system.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

SPATIAL_DIMS = ["z", "y", "x"]


@dataclass
class XAffine:
    """Affine transform, optionally varying over time.

    ``data`` has shape ``(ndim+1, ndim+1)`` or ``(nt, ndim+1, ndim+1)``;
    ``t_coords`` is None iff data has no time axis.
    """

    data: np.ndarray
    t_coords: Optional[np.ndarray] = None

    def __post_init__(self):
        self.data = np.asarray(self.data, dtype=float)
        if self.t_coords is not None:
            self.t_coords = np.asarray(self.t_coords)
            if self.data.ndim == 2:
                self.data = np.broadcast_to(
                    self.data, (len(self.t_coords),) + self.data.shape
                ).copy()
            if self.data.ndim != 3 or len(self.data) != len(self.t_coords):
                raise ValueError(
                    f"affine data {self.data.shape} does not match "
                    f"{len(self.t_coords)} t coordinates"
                )
        elif self.data.ndim != 2:
            raise ValueError(
                f"affine without t coordinates must be 2D, got {self.data.shape}"
            )

    @property
    def ndim(self) -> int:
        """Number of spatial dimensions the affine acts on."""
        return self.data.shape[-1] - 1

    @property
    def has_t(self) -> bool:
        return self.t_coords is not None

    def squeeze(self) -> np.ndarray:
        """Drop the time axis if it is a singleton; return plain matrix."""
        if self.has_t and len(self.t_coords) == 1:
            return np.asarray(self.data[0])
        return np.asarray(self.data)

    def matrix(self, t=None) -> np.ndarray:
        """Plain (ndim+1, ndim+1) matrix at time ``t`` (or the only one)."""
        if not self.has_t:
            return np.asarray(self.data)
        if t is None:
            if len(self.t_coords) == 1:
                return np.asarray(self.data[0])
            raise ValueError("time-varying affine: specify t")
        idx = int(np.where(self.t_coords == t)[0][0])
        return np.asarray(self.data[idx])

    def sel_t(self, t) -> "XAffine":
        if not self.has_t:
            return XAffine(self.data.copy())
        idx = int(np.where(self.t_coords == t)[0][0])
        return XAffine(self.data[idx].copy())

    def copy(self) -> "XAffine":
        return XAffine(
            self.data.copy(),
            None if self.t_coords is None else self.t_coords.copy(),
        )


def identity_transform(ndim: int, t_coords=None) -> XAffine:
    return XAffine(np.eye(ndim + 1), t_coords=t_coords)


def affine_to_xaffine(affine, t_coords=None) -> XAffine:
    return XAffine(np.asarray(affine), t_coords=t_coords)


def to_xaffine(value) -> XAffine:
    if isinstance(value, XAffine):
        return value
    value = np.asarray(value, dtype=float)
    if value.ndim == 3:
        return XAffine(value, t_coords=np.arange(len(value)))
    return XAffine(value)


def transform_pts(pts, affine) -> np.ndarray:
    """Apply homogeneous ``affine`` to an (M, N) point array (float64)."""
    pts = np.asarray(pts, dtype=float)
    affine = np.asarray(affine, dtype=float)
    ndim = affine.shape[-1] - 1
    return pts @ affine[:ndim, :ndim].T + affine[:ndim, ndim]
