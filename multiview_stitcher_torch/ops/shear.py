"""Shear-decomposed affine resampling: the port of
``multiview_stitcher_tpu.ops.shear``, the fusion tier that ``MVS_TPU_SHEAR=1``
puts ahead of the exact-affine kernels.

An affine pixel map ``out(i) = in(M i + o)`` is factored as ``M = P E_1 ...
E_k``: ``P`` permutes the input axes and every ``E_j`` changes one coordinate
as an affine function of itself and at most one other coordinate. Each
elementary pass resamples one axis linearly, so a rotation is interpolated
once per pass (the shear-warp approximation: exact on affine images, O(h^2)
on smooth data), and an axis-aligned map reduces to the exact separable
resample. Out-of-domain outputs are exactly ``cval`` through an analytic mask
of the original map.

The planning (:func:`plan_shear`, :class:`ShearPlan`, :class:`ShearCtx`) is
the reference's numpy in float64, line for line. The passes are torch ops in
float32: where the reference contracts a 2-banded (out, in) lerp matrix with
the data (``Precision.HIGHEST``), each pass here reads the two taps of every
output sample with ``take_along_dim`` and weighs them, the same two products
without the dense matrix; :func:`refine_grid` contracts its small matrices
with TF32 off (``utils.misc.full_f32``). The reference runs these passes as
XLA code, outside any Pallas kernel, so they have no CUDA kernel here. The
batched functions take a leading item axis, each item with its own
coefficients under one shared plan.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from multiview_stitcher_torch.utils import misc as misc_utils

_SKIP_TOL = 1e-12


# ---------------------------------------------------------------------------
# host-side planning (numpy, float64)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShearPlan:
    """Static structure of a shear decomposition.

    ``passes``: tuple of ``(d, e, out_ext)`` innermost-first; ``e`` is the
    dependency axis or -1 for scale/translate-only passes. ``perm`` is the
    input axis permutation applied first. All interval offsets are already
    folded into the per-element coefficient table returned alongside.
    """

    perm: Tuple[int, ...]
    passes: Tuple[Tuple[int, int, int], ...]
    out_shape: Tuple[int, ...]

    @property
    def n_passes(self) -> int:
        return len(self.passes)


def _lu_nopivot_batch(M):
    """Vectorized Doolittle LU (no pivoting) of (N, n, n) matrices.

    Returns (L unit-lower, U upper, ok) where ok is False for elements with
    a near-zero pivot (relative to the matrix scale).
    """
    N, n, _ = M.shape
    U = M.astype(np.float64).copy()
    L = np.broadcast_to(np.eye(n), (N, n, n)).copy()
    scale = np.abs(M).max(axis=(1, 2)) + 1e-30
    ok = np.ones(N, dtype=bool)
    for k in range(n):
        piv = U[:, k, k]
        ok &= np.abs(piv) > 1e-7 * scale
        piv = np.where(np.abs(piv) < 1e-30, 1e-30, piv)
        for i in range(k + 1, n):
            L[:, i, k] = U[:, i, k] / piv
            U[:, i, :] -= L[:, i, k, None] * U[:, k, :]
    return L, U, ok


def _chain_structure(ndim):
    """Canonical elementary chain (innermost-first) for L·U, as
    (d, e, kind) with kind in {'L','Ua','Ub','S'} used for coefficients."""
    if ndim == 2:
        return [
            (1, 0, "L10"),
            (0, 1, "Ua0"),
            (1, -1, "S1"),
        ]
    if ndim == 3:
        return [
            (1, 0, "L10"),
            (2, 0, "L20"),
            (2, 1, "L21"),
            (0, 1, "Ua0"),
            (0, 2, "Ub0"),
            (1, 2, "Ua1"),
            (2, -1, "S2"),
        ]
    raise NotImplementedError(f"ndim={ndim}")


def _chain_coeffs(L, U, ndim):
    """Per-element (a, b) for each structural pass; None on divide trouble.

    3D: L = E10(l10)·E20(l20)·E21(l21) exactly; U = A0a·A0b·A1·A2 with
    A0a=[u00, u01/u11, 0] on axis 0, A0b=[1, 0, (u02-u01·u12/u11)/(u00·u22)],
    A1=[0, u11, u12/u22], A2=diag(1,1,u22) (verified at plan time).
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        if ndim == 2:
            ab = [
                (np.ones_like(L[:, 1, 0]), L[:, 1, 0]),
                (U[:, 0, 0], U[:, 0, 1] / U[:, 1, 1]),
                (U[:, 1, 1], np.zeros_like(U[:, 1, 1])),
            ]
        else:
            u01_11 = U[:, 0, 1] / U[:, 1, 1]
            ab = [
                (np.ones_like(L[:, 1, 0]), L[:, 1, 0]),
                (np.ones_like(L[:, 2, 0]), L[:, 2, 0]),
                (np.ones_like(L[:, 2, 1]), L[:, 2, 1]),
                (U[:, 0, 0], u01_11),
                (
                    np.ones_like(U[:, 0, 0]),
                    (U[:, 0, 2] - u01_11 * U[:, 1, 2]) / (U[:, 0, 0] * U[:, 2, 2]),
                ),
                (U[:, 1, 1], U[:, 1, 2] / U[:, 2, 2]),
                (U[:, 2, 2], np.zeros_like(U[:, 2, 2])),
            ]
    a = np.stack([x[0] for x in ab], axis=1)
    b = np.stack([x[1] for x in ab], axis=1)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return None
    return a, b


def _pass_matrices(structure, a, b, ndim):
    """(N, P, ndim, ndim) linear parts of the elementary passes."""
    N, P = a.shape
    mats = np.broadcast_to(np.eye(ndim), (N, P, ndim, ndim)).copy()
    for p, (d, e, _) in enumerate(structure):
        mats[:, p, d, d] = a[:, p]
        if e >= 0:
            mats[:, p, d, e] = b[:, p]
    return mats


@dataclass
class ShearCtx:
    """Recompute per-element coefficients for a frozen :class:`ShearPlan`.

    Fusion batches pad their view lists with identity maps; the plan is
    built from the real maps only, and :meth:`coeffs` re-derives (a, b, t)
    for any (mats, offs) batch against the frozen structure (padding
    identities always factor cleanly). Elements that fail to factor or
    verify raise.
    """

    perm: Tuple[int, ...]
    structure: tuple
    designated: dict
    out_era: tuple
    e_era: tuple
    in_era: tuple
    ndim: int

    def coeffs(self, mats, offs):
        mats = np.asarray(mats, dtype=np.float64)
        offs = np.asarray(offs, dtype=np.float64)
        batch_shape = offs.shape[:-1]
        mats = mats.reshape((-1,) + mats.shape[-2:])
        offs = offs.reshape((-1, offs.shape[-1]))
        res = _factor(mats, offs, self.perm, self.structure, self.designated, self.ndim)
        if res is None:
            raise ValueError("affine batch does not factor under the frozen shear plan")
        a, b, t = res
        t_loc = t.copy()
        for p in range(len(self.structure)):
            _, e, _ = self.structure[p]
            t_loc[:, p] = (
                t[:, p]
                + a[:, p] * self.out_era[p][0]
                + (b[:, p] * self.e_era[p][0] if e >= 0 else 0.0)
                - self.in_era[p][0]
            )
        out = np.stack([a, b, t_loc], axis=-1).astype(np.float32)
        return out.reshape(batch_shape + out.shape[-2:])


def _factor(mats, offs, perm, structure, designated, ndim):
    """(a, b, t) per element for a fixed perm + kept structure; verified
    by composing the chain back against (mats, offs). None on failure."""
    N = mats.shape[0]
    Mp = mats[:, list(perm), :]
    L, U, ok = _lu_nopivot_batch(Mp)
    if not ok.all():
        return None
    full = _chain_coeffs(L, U, ndim)
    if full is None:
        return None
    a_full, b_full = full
    full_structure = _chain_structure(ndim)
    keep_idx = [full_structure.index(s) for s in structure]
    a, b = a_full[:, keep_idx], b_full[:, keep_idx]
    # any dropped pass must be identity for every element
    dropped = [p for p in range(len(full_structure)) if p not in keep_idx]
    for p in dropped:
        if (np.abs(a_full[:, p] - 1) > 1e-9).any() or (np.abs(b_full[:, p]) > 1e-9).any():
            return None
    P = len(structure)

    pm = _pass_matrices(structure, a, b, ndim)
    perm_mat = np.zeros((ndim, ndim))
    for k in range(ndim):
        perm_mat[perm[k], k] = 1.0
    prefix = np.broadcast_to(perm_mat, (N, ndim, ndim)).copy()
    Bcols = np.zeros((N, ndim, ndim))
    des_order = sorted(designated.items())
    for p in range(P):
        for col, (_axis, dp) in enumerate(des_order):
            if dp == p:
                Bcols[:, :, col] = prefix[:, :, structure[p][0]]
        prefix = prefix @ pm[:, p]
    try:
        t_des = np.linalg.solve(Bcols, offs[..., None])[..., 0]
    except np.linalg.LinAlgError:
        return None
    t = np.zeros((N, P))
    for col, (_axis, dp) in enumerate(des_order):
        t[:, dp] = t_des[:, col]

    comp_m = np.broadcast_to(perm_mat, (N, ndim, ndim)).copy()
    comp_o = np.zeros((N, ndim))
    for p in range(P):
        tv = np.zeros((N, ndim))
        tv[:, structure[p][0]] = t[:, p]
        comp_o = comp_o + (comp_m @ tv[..., None])[..., 0]
        comp_m = comp_m @ pm[:, p]
    scale = np.abs(mats).max() + np.abs(offs).max() + 1.0
    if not (
        np.allclose(comp_m, mats, atol=1e-6 * scale)
        and np.allclose(comp_o, offs, atol=1e-5 * scale)
    ):
        return None
    return a, b, t


def plan_shear(
    mats,
    offs,
    in_shape,
    out_shape,
    max_shear: float = 2.5,
    scale_range=(1e-3, 1e3),
    max_growth: float = 3.0,
):
    """Factor a batch of affine maps into a shared-structure shear chain.

    ``mats`` (N, ndim, ndim) and ``offs`` (N, ndim) map output pixels to
    input pixels; ``in_shape`` / ``out_shape`` are the input (slab) and
    output spatial shapes. Maps outside the quality guards (``max_shear``,
    ``scale_range``, ``max_growth``: large rotations, extreme anisotropy,
    runaway intermediate extents) return None, and fusion takes the gather
    route. Returns (plan, ctx, coeffs): the :class:`ShearPlan`, a
    :class:`ShearCtx` for re-deriving the coefficients of further (padded)
    batches, and the (N, P, 3) float32 coefficients of the given maps.
    """
    mats = np.asarray(mats, dtype=np.float64)
    offs = np.asarray(offs, dtype=np.float64)
    if mats.ndim == 2:
        mats, offs = mats[None], offs[None]
    N, ndim = offs.shape
    if ndim not in (2, 3):
        return None

    structure = _chain_structure(ndim)
    best = None
    for perm in itertools.permutations(range(ndim)):
        # chain innermost pass x = transpose(slab, perm) has matrix
        # P[perm[k], k] = 1, so L·U must equal P^T M = M[perm, :]
        Mp = mats[:, list(perm), :]
        L, U, ok = _lu_nopivot_batch(Mp)
        if not ok.all():
            continue
        coeff = _chain_coeffs(L, U, ndim)
        if coeff is None:
            continue
        a, b = coeff
        if (
            np.abs(b).max() > max_shear
            or np.abs(a).min() < scale_range[0]
            or np.abs(a).max() > scale_range[1]
        ):
            continue
        score = np.abs(b).max()
        if best is None or score < best[0]:
            best = (score, perm, a, b)
    if best is None:
        return None
    _, perm, a, b = best

    # drop passes that are identity for every element; keep, per axis, the
    # outermost non-trivial pass (else the outermost) as its offset-carrier
    candidate_skip = (np.abs(a - 1) < _SKIP_TOL).all(axis=0) & (np.abs(b) < _SKIP_TOL).all(axis=0)
    designated = {}
    for p in range(len(structure) - 1, -1, -1):
        d = structure[p][0]
        if d not in designated or (candidate_skip[designated[d]] and not candidate_skip[p]):
            designated[d] = p
    keep = [
        p for p in range(len(structure))
        if (p in designated.values()) or not candidate_skip[p]
    ]
    structure = [structure[p] for p in keep]
    a, b = a[:, keep], b[:, keep]
    designated = {}
    for p in range(len(structure) - 1, -1, -1):
        d = structure[p][0]
        if d not in designated:
            designated[d] = p
    P = len(structure)
    structure = tuple(structure)

    # offsets assigned to designated passes + compose-and-verify
    res = _factor(mats, offs, perm, structure, designated, ndim)
    if res is None:
        return None
    a, b, t = res

    # interval propagation (outermost -> innermost): an axis's index range
    # only changes at its own modifying passes; dependency reads use the
    # dependency axis's range as frozen by its nearest-outer modifier.
    # Intervals are inclusive integer index hulls.
    slab_perm = tuple(in_shape[perm[k]] for k in range(ndim))
    interval = {dax: (0, out_shape[dax] - 1) for dax in range(ndim)}
    out_era = [None] * P  # (lo, ext) static output era of pass p
    for p in range(P - 1, -1, -1):
        d, e, _ = structure[p]
        out_lo, out_hi = interval[d]
        out_era[p] = (out_lo, out_hi - out_lo + 1)
        i_d_vals = (out_lo, out_hi)
        if e >= 0:
            if any(structure[q][0] == e for q in range(p)):
                i_e_vals = interval[e]
            else:
                i_e_vals = (0, slab_perm[e] - 1)
        else:
            i_e_vals = (0.0,)
        cs = np.stack([
            a[:, p] * i_d + (b[:, p] * i_e if e >= 0 else 0.0) + t[:, p]
            for i_d in i_d_vals
            for i_e in i_e_vals
        ])
        # interpolation support of coordinate c is floor(c)..floor(c)+1
        lo_new = int(np.floor(cs.min()))
        hi_new = int(np.floor(cs.max())) + 1
        interval[d] = (lo_new, hi_new)
        if hi_new - lo_new > max_growth * max(out_shape[d], max(in_shape)) + 16:
            return None

    # forward sweep: each pass's input era and its dependency axis's era are
    # the materialized eras in data-flow order
    cur_era = {dax: (0, slab_perm[dax]) for dax in range(ndim)}
    in_era = [None] * P
    e_era = [None] * P
    for p in range(P):
        d, e, _ = structure[p]
        in_era[p] = cur_era[d]
        if e >= 0:
            e_era[p] = cur_era[e]
        cur_era[d] = out_era[p]

    # fold the static era offsets into per-element local t:
    # c_loc = a*(i_loc + out_lo) + b*(s_loc + e_lo) + t - in_lo
    t_loc = t.copy()
    for p in range(P):
        d, e, _ = structure[p]
        t_loc[:, p] = (
            t[:, p]
            + a[:, p] * out_era[p][0]
            + (b[:, p] * e_era[p][0] if e >= 0 else 0.0)
            - in_era[p][0]
        )

    passes = tuple((structure[p][0], structure[p][1], out_era[p][1]) for p in range(P))
    plan = ShearPlan(perm=tuple(perm), passes=passes, out_shape=tuple(out_shape))
    ctx = ShearCtx(
        perm=tuple(perm),
        structure=structure,
        designated=designated,
        out_era=tuple(out_era),
        e_era=tuple(e_era),
        in_era=tuple(in_era),
        ndim=ndim,
    )
    coeffs = np.stack([a, b, t_loc], axis=-1).astype(np.float32)
    return plan, ctx, coeffs


# ---------------------------------------------------------------------------
# the passes (torch, float32)
# ---------------------------------------------------------------------------


def _banded_matrix(c: torch.Tensor, in_ext: int, dtype) -> torch.Tensor:
    """2-banded lerp matrix rows for sample coordinates ``c`` (..., out):
    (..., out, in); out-of-range coordinates clamp to the edge."""
    f = torch.floor(c)
    w = (c - f).to(dtype)
    fi = f.to(torch.int64)
    j = torch.arange(in_ext, device=c.device)
    low = torch.clamp(fi, 0, in_ext - 1)[..., None]
    high = torch.clamp(fi + 1, 0, in_ext - 1)[..., None]
    zero = torch.zeros((), dtype=dtype, device=c.device)
    return torch.where(j == low, (1.0 - w)[..., None], zero) + torch.where(
        j == high, w[..., None], zero
    )


def _shear_pass(x: torch.Tensor, d: int, e: int, out_ext: int, a, b, t) -> torch.Tensor:
    """One elementary pass over N items ``x`` (N, *dims): resample axis ``d``
    of item n at ``c = a[n] * i_d + b[n] * i_e + t[n]`` (``e`` < 0: no
    dependency axis), each sample the lerp of its two taps, clamped to the
    edge."""
    N = x.shape[0]
    nd = x.dim() - 1
    in_ext = x.shape[1 + d]
    dev = x.device
    i = torch.arange(out_ext, dtype=torch.float32, device=dev)
    shape = [N] + [1] * nd
    shape[1 + d] = out_ext
    if e < 0:
        c = (a[:, None] * i[None, :] + t[:, None]).reshape(shape)
    else:
        m_e = x.shape[1 + e]
        s = torch.arange(m_e, dtype=torch.float32, device=dev)
        c = a[:, None, None] * i[None, None, :] + b[:, None, None] * s[None, :, None]
        c = c + t[:, None, None]  # (N, m_e, out)
        shape[1 + e] = m_e
        c = (c if e < d else c.transpose(1, 2)).reshape(shape)
    f = torch.floor(c)
    w = (c - f).to(x.dtype)
    fi = f.to(torch.int64)
    low = torch.take_along_dim(x, torch.clamp(fi, 0, in_ext - 1), dim=1 + d)
    high = torch.take_along_dim(x, torch.clamp(fi + 1, 0, in_ext - 1), dim=1 + d)
    return (1.0 - w) * low + w * high


def refine_grid(g: torch.Tensor, factor: int, ndim: Optional[int] = None) -> torch.Tensor:
    """Exact piecewise-linear refinement of a small grid by ``factor`` along
    its last ``ndim`` axes (all of them by default; leading axes are items).

    Linear interpolation of the refined grid is the same function as that
    of the original in refined coordinates ``c' = factor * c``, so the shear
    chain on the refined grid divides the multi-pass error by about
    ``factor**2``. Used for the 5^ndim blending-weight proxy grids."""
    g = torch.as_tensor(g)
    ndim = g.dim() if ndim is None else ndim
    with misc_utils.full_f32():
        for axis in range(g.dim() - ndim, g.dim()):
            n = g.shape[axis]
            m = factor * (n - 1) + 1
            i = torch.arange(m, dtype=torch.float32, device=g.device) / factor
            U = _banded_matrix(i, n, g.dtype)  # (m, n), exact at nodes
            g = torch.movedim(torch.tensordot(U, g, dims=([1], [axis])), 0, axis)
    return g


def affine_valid_mask(matrix, offset, extent, out_shape) -> torch.Tensor:
    """Exact domain mask of the original map on the output grid:
    ``valid(i) <=> 0 <= (M i + o)_d <= extent_d - 1`` for every dim, in
    float32, summed as the reference sums it. ``matrix`` (ndim, ndim) or
    (N, ndim, ndim) with ``offset`` and ``extent`` (ndim,) or (N, ndim)."""
    out_shape = tuple(int(s) for s in out_shape)
    ndim = len(out_shape)
    matrix = torch.as_tensor(matrix, dtype=torch.float32)
    dev = matrix.device
    offset = torch.as_tensor(offset, dtype=torch.float32, device=dev)
    extent = torch.as_tensor(extent, dtype=torch.float32, device=dev)
    single = matrix.dim() == 2
    if single:
        matrix, offset, extent = matrix[None], offset[None], extent[None]
    N = matrix.shape[0]
    per_item = (N,) + (1,) * ndim
    idx = [
        torch.arange(out_shape[d], dtype=torch.float32, device=dev).reshape(
            (1,) + (1,) * d + (-1,) + (1,) * (ndim - d - 1)
        )
        for d in range(ndim)
    ]
    valid = torch.ones((N,) + out_shape, dtype=torch.bool, device=dev)
    for d in range(ndim):
        c = offset[:, d].reshape(per_item).expand((N,) + out_shape)
        for j in range(ndim):
            c = c + matrix[:, d, j].reshape(per_item) * idx[j]
        valid &= (c >= 0) & (c <= extent[:, d].reshape(per_item) - 1)
    return valid[0] if single else valid


def shear_resample_batch(data, coeffs, matrices, offsets, extents, plan: ShearPlan,
                         cval=float("nan")) -> torch.Tensor:
    """Resample N items ``data`` (N, *S) through one :class:`ShearPlan`,
    item n with its own ``coeffs[n]`` (P, 3). ``data`` must hold no NaN
    (a lerp would carry it along whole lines: zero-fill first);
    ``extents`` (N, ndim) are the true data extents of the analytic mask
    and (``matrices``, ``offsets``) the original pixel maps, read by the
    mask only. Returns (N, *plan.out_shape) in the data's float dtype
    (float32 for other data)."""
    dev = data.device
    dt = data.dtype if data.is_floating_point() else torch.float32
    x = data.to(dt).permute((0,) + tuple(1 + p for p in plan.perm))
    co = torch.as_tensor(np.asarray(coeffs) if not isinstance(coeffs, torch.Tensor) else coeffs,
                         dtype=torch.float32, device=dev)
    for k, (d, e, out_ext) in enumerate(plan.passes):
        x = _shear_pass(x, d, e, out_ext, co[:, k, 0], co[:, k, 1], co[:, k, 2])
    valid = affine_valid_mask(
        torch.as_tensor(np.asarray(matrices) if not isinstance(matrices, torch.Tensor) else matrices,
                        dtype=torch.float32, device=dev),
        offsets if isinstance(offsets, torch.Tensor) else np.asarray(offsets, np.float32),
        extents if isinstance(extents, torch.Tensor) else np.asarray(extents, np.float32),
        plan.out_shape,
    )
    return torch.where(valid, x, torch.as_tensor(cval, dtype=dt, device=dev))


def shear_resample(data, coeffs, matrix, offset, extent, plan: ShearPlan,
                   cval=float("nan")) -> torch.Tensor:
    """:func:`shear_resample_batch` of one array."""
    def one(x):
        return x[None] if isinstance(x, torch.Tensor) else np.asarray(x)[None]

    return shear_resample_batch(
        torch.as_tensor(data)[None], one(coeffs), one(matrix), one(offset), one(extent),
        plan, cval,
    )[0]
