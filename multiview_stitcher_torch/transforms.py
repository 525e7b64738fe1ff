"""Point-set transform estimators (numpy): least-squares fits between
corresponding point sets, as groupwise resolution uses them.

Copy of ``multiview_stitcher_tpu.transforms``'s estimators: translation
(mean displacement), rigid and similarity (Umeyama) and affine (lstsq).
"""

from __future__ import annotations

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
    "rigid": lambda src, dst: _umeyama(src, dst, estimate_scale=False),
    "similarity": lambda src, dst: _umeyama(src, dst, estimate_scale=True),
    "affine": estimate_affine,
}


def estimate_transform(kind: str, src, dst) -> np.ndarray:
    return _ESTIMATORS[kind](src, dst)
