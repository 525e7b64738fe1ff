"""Point-set transform estimators (numpy): least-squares fits between
corresponding point sets, as groupwise resolution and marker registration
use them.

Copy of ``multiview_stitcher_tpu.transforms``'s estimators: translation
(mean displacement), rigid and similarity (Umeyama) and affine (lstsq), as
functions and as estimator classes (``estimate(src, dst)``, ``params``,
``residuals``, ``inverse``), and ``Affine_Fit``, the reference's fit object
over the same affine solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def estimate_translation(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Mean displacement fit."""
    src = np.asarray(src, dtype=float)
    dst = np.asarray(dst, dtype=float)
    ndim = src.shape[1]
    M = np.eye(ndim + 1)
    M[:ndim, ndim] = dst.mean(axis=0) - src.mean(axis=0)
    return M


def _umeyama(src: np.ndarray, dst: np.ndarray, estimate_scale: bool) -> np.ndarray:
    """Umeyama's (1991) closed-form rigid or similarity fit."""
    src = np.asarray(src, dtype=float)
    dst = np.asarray(dst, dtype=float)
    n, ndim = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_d = src - src_mean
    dst_d = dst - dst_mean
    A = dst_d.T @ src_d / n
    d = np.ones(ndim)
    if np.linalg.det(A) < 0:
        d[-1] = -1
    T = np.eye(ndim + 1)
    U, S, V = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return np.full((ndim + 1, ndim + 1), np.nan)
    if rank == ndim - 1:
        if np.linalg.det(U) * np.linalg.det(V) > 0:
            T[:ndim, :ndim] = U @ V
        else:
            s = d[ndim - 1]
            d[ndim - 1] = -1
            T[:ndim, :ndim] = U @ np.diag(d) @ V
            d[ndim - 1] = s
    else:
        T[:ndim, :ndim] = U @ np.diag(d) @ V
    scale = 1.0 / src_d.var(axis=0).sum() * (S @ d) if estimate_scale else 1.0
    T[:ndim, ndim] = dst_mean - scale * (T[:ndim, :ndim] @ src_mean)
    T[:ndim, :ndim] *= scale
    return T


def estimate_rigid(src, dst) -> np.ndarray:
    return _umeyama(src, dst, estimate_scale=False)


def estimate_similarity(src, dst) -> np.ndarray:
    return _umeyama(src, dst, estimate_scale=True)


def estimate_affine(src, dst) -> np.ndarray:
    """Full affine by linear least squares."""
    src = np.asarray(src, dtype=float)
    dst = np.asarray(dst, dtype=float)
    n, ndim = src.shape
    A = np.concatenate([src, np.ones((n, 1))], axis=1)
    coeffs, *_ = np.linalg.lstsq(A, dst, rcond=None)
    M = np.eye(ndim + 1)
    M[:ndim, :ndim] = coeffs[:ndim].T
    M[:ndim, ndim] = coeffs[ndim]
    return M


_ESTIMATORS = {
    "translation": estimate_translation,
    "rigid": estimate_rigid,
    "similarity": estimate_similarity,
    "affine": estimate_affine,
}


def estimate_transform(kind: str, src, dst) -> np.ndarray:
    return _ESTIMATORS[kind](src, dst)


class _BaseTransform:
    kind: str = "affine"

    def __init__(self, dimensionality: int = 2, matrix: Optional[np.ndarray] = None):
        self.dimensionality = dimensionality
        self.params = np.eye(dimensionality + 1) if matrix is None else np.asarray(matrix)

    def estimate(self, src, dst) -> bool:
        """Fit ``params`` to the point pairs; False (``params`` unchanged)
        where the fit is not finite."""
        M = estimate_transform(self.kind, src, dst)
        if not np.all(np.isfinite(M)):
            return False
        self.params = M
        return True

    def __call__(self, coords):
        coords = np.asarray(coords, dtype=float)
        ndim = self.dimensionality
        return coords @ self.params[:ndim, :ndim].T + self.params[:ndim, ndim]

    def residuals(self, src, dst) -> np.ndarray:
        return np.sqrt(np.sum((self(src) - np.asarray(dst)) ** 2, axis=1))

    @property
    def inverse(self):
        return type(self)(dimensionality=self.dimensionality, matrix=np.linalg.inv(self.params))


class TranslationTransform(_BaseTransform):
    kind = "translation"


class EuclideanTransform(_BaseTransform):
    kind = "rigid"


class SimilarityTransform(_BaseTransform):
    kind = "similarity"


class AffineTransform(_BaseTransform):
    kind = "affine"


def Affine_Fit(from_pts, to_pts):  # noqa: N802 (the reference's name)
    """Least-squares affine fit ``p ~ A q + t`` of ``to_pts`` on
    ``from_pts``, through :func:`estimate_affine`. Returns an object with
    ``Matrix()`` (the flat ``[A.ravel(), t]``) and ``Transform(pt)``."""
    q = np.asarray(from_pts, dtype=float)
    p = np.asarray(to_pts, dtype=float)
    if q.shape != p.shape or len(q) < 1:
        raise ValueError("from_pts and to_pts must be of same size.")
    dim = q.shape[1]
    if len(q) < dim:
        raise ValueError("Too few points => under-determined system.")
    homogeneous = estimate_affine(q, p)
    A = homogeneous[:dim, :dim]
    t = homogeneous[:dim, dim]

    class Transformation:
        def Matrix(self):  # noqa: N802
            return np.concatenate([A.flatten(), t])

        def Transform(self, pt):  # noqa: N802
            return list(A @ np.asarray(pt, dtype=float) + t)

    return Transformation()
