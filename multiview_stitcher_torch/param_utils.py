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


def affine_from_translation(translation) -> np.ndarray:
    """Homogeneous matrix of a translation."""
    translation = np.asarray(translation, dtype=float)
    ndim = len(translation)
    M = np.eye(ndim + 1)
    M[:ndim, ndim] = translation
    return M


def affine_from_linear_affine(linear_affine) -> np.ndarray:
    """Homogeneous matrix from a flat ``[linear.ravel(), translation]``
    vector of ndim^2 + ndim entries (12 in 3D, 6 in 2D)."""
    linear_affine = np.asarray(linear_affine, dtype=float)
    ndim = 3 if len(linear_affine) == 12 else 2
    M = np.eye(ndim + 1)
    M[:ndim, :ndim] = linear_affine[: ndim**2].reshape((ndim, ndim))
    M[:ndim, ndim] = linear_affine[-ndim:]
    return M


def linear_affine_from_affine(affine) -> np.ndarray:
    """The flat ``[linear.ravel(), translation]`` vector of a homogeneous
    matrix."""
    affine = np.asarray(affine)
    ndim = affine.shape[-1] - 1
    out = np.zeros(ndim**2 + ndim, dtype=float)
    out[: ndim**2] = affine[:ndim, :ndim].flatten()
    out[-ndim:] = affine[:ndim, ndim]
    return out


def translation_from_affine(affine) -> np.ndarray:
    affine = np.asarray(affine)
    ndim = affine.shape[-1] - 1
    return affine[:ndim, ndim]


def affine_from_rotation(angle, direction, point=None) -> np.ndarray:
    """3D rotation by ``angle`` about the axis along ``direction`` through
    ``point`` (the origin by default)."""
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(angle * np.asarray(direction, dtype=float)).as_matrix()
    M = np.identity(4)
    M[:3, :3] = R
    if point is not None:
        point = np.asarray(point[:3], dtype=np.float64)
        M[:3, 3] = point - np.dot(R, point)
    return M


def invert_coordinate_order(affine) -> np.ndarray:
    """The same affine on coordinates in the reverse order ((z, y, x) <->
    (x, y, z))."""
    affine = np.asarray(affine)
    ndim = affine.shape[-1] - 1
    M = np.eye(ndim + 1)
    M[:ndim, :ndim] = affine[:ndim, :ndim][::-1, ::-1]
    M[:ndim, ndim] = affine[:ndim, ndim][::-1]
    return M


def _rotation_matrix_2d(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


# the random_* helpers draw from numpy's global generator, in the reference's
# order, so that a seed gives the reference's values


def random_scale(ndim, scale=0.1):
    return 1 + np.random.random(ndim) * scale - scale / 2


def random_translation(ndim=2, scale=10):
    return np.random.random(ndim) * scale - scale / 2


def random_rotation(ndim=2, scale=0.1):
    rot = np.random.random(ndim - 1) * scale - scale / 2
    return rot[0] if ndim == 2 else rot


def random_affine(ndim=2, translation_scale=10, rotation_scale=0.1, scale_scale=0.1):
    """A random rigid transform after a random scaling, for tests."""
    if ndim == 2:
        M = np.eye(3)
        M[:2, :2] = _rotation_matrix_2d(random_rotation(2, rotation_scale)) @ np.diag(
            random_scale(2, scale_scale)
        )
        M[:2, 2] = random_translation(2, translation_scale)
        return M
    if ndim == 3:
        from scipy.spatial.transform import Rotation

        R = Rotation.from_euler(
            "zyx", np.random.random(3) * rotation_scale - rotation_scale / 2
        ).as_matrix()
        rigid = np.eye(4)
        rigid[:3, :3] = R
        rigid[:3, 3] = random_translation(3, translation_scale)
        return rigid @ np.diag(list(random_scale(3, scale_scale)) + [1])
    raise NotImplementedError("Only 2D and 3D supported.")


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


def expand_affine_dims(xaffine, dims) -> XAffine:
    """Expand an affine by the spatial dims ``dims`` it does not act on
    (2D -> 3D); the added dims are left untransformed."""
    xaffine = to_xaffine(xaffine)
    curr_dims = SPATIAL_DIMS[-xaffine.ndim:]
    expanded_dims = [d for d in SPATIAL_DIMS if d in curr_dims or d in dims]
    n_out = len(expanded_dims)

    def expand_one(mat):
        out = np.eye(n_out + 1)
        idx = [expanded_dims.index(d) for d in curr_dims]
        for i_old, i_new in enumerate(idx):
            for j_old, j_new in enumerate(idx):
                out[i_new, j_new] = mat[i_old, j_old]
            out[i_new, n_out] = mat[i_old, len(curr_dims)]
        return out

    if xaffine.has_t:
        data = np.stack([expand_one(m) for m in xaffine.data])
        return XAffine(data, t_coords=xaffine.t_coords)
    return XAffine(expand_one(xaffine.data))


def _align_t(a: XAffine, b: XAffine, join: str = "inner"):
    """The data of two affines aligned along t: ``(data_a, data_b, t_coords)``.

    An affine without t is broadcast over the other's timepoints. Between two
    time-varying affines, ``join="inner"`` keeps the common timepoints in
    ``a``'s order, ``"outer"`` the sorted union, where a timepoint one of
    them lacks takes the identity."""
    if not a.has_t and not b.has_t:
        return a.data, b.data, None
    if a.has_t and not b.has_t:
        return a.data, np.broadcast_to(b.data, a.data.shape), a.t_coords
    if b.has_t and not a.has_t:
        return np.broadcast_to(a.data, b.data.shape), b.data, b.t_coords
    if join == "inner":
        common = [t for t in a.t_coords if t in set(b.t_coords.tolist())]
    elif join == "outer":
        common = sorted(set(a.t_coords.tolist()) | set(b.t_coords.tolist()))
    else:
        raise ValueError(join)
    common = np.asarray(common)

    def take(x: XAffine):
        pos = {t: i for i, t in enumerate(x.t_coords.tolist())}
        return np.stack([
            x.data[pos[t]] if t in pos else np.eye(x.ndim + 1) for t in common.tolist()
        ])

    return take(a), take(b), common


def matmul_xparams(p1, p2) -> XAffine:
    """``p1 @ p2`` of two (possibly time-varying) affines, over their common
    timepoints."""
    d1, d2, t = _align_t(to_xaffine(p1), to_xaffine(p2), join="inner")
    return XAffine(np.matmul(d1, d2), t_coords=t)


def invert_xparams(p) -> XAffine:
    p = to_xaffine(p)
    return XAffine(np.linalg.inv(p.data), t_coords=p.t_coords)


def rebase_affine(xaffine, base_affine) -> XAffine:
    """``xaffine @ base_affine``, over the outer join of their timepoints
    (a timepoint one of them lacks takes the identity)."""
    a, b = to_xaffine(xaffine), to_xaffine(base_affine)
    d1, d2, t = _align_t(a, b, join="outer")
    return XAffine(np.matmul(d1, d2), t_coords=t)


def transform_pts(pts, affine) -> np.ndarray:
    """Apply homogeneous ``affine`` to an (M, N) point array (float64)."""
    pts = np.asarray(pts, dtype=float)
    affine = np.asarray(affine, dtype=float)
    ndim = affine.shape[-1] - 1
    return pts @ affine[:ndim, :ndim].T + affine[:ndim, ndim]


def get_spatial_dims_from_params(xparams) -> list:
    """The matrix dims of a params object: the reference labels them
    ``x_in`` and ``x_out``; an :class:`XAffine` holds the matrix in its
    last two axes."""
    return ["x_in", "x_out"]


def get_non_spatial_dims_from_params(xparams) -> list:
    """The leading dims of a params object: ``["t"]`` for a time-varying
    affine, else none."""
    return ["t"] if to_xaffine(xparams).has_t else []
