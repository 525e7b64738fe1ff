"""Plain multi-view fusion: the weighted average of views placed by affines,
under cosine-tapered blending weights, in plain PyTorch and NumPy.

Written from the semantics: the output is the union of the views' voxel
centres under their affines (``fuse(output_stack_mode="union")``) on a grid
of ``out_spacing``; each output voxel is mapped into each view; a view
holds the voxel where the mapped position lies within its first and last
voxel centre on every axis, and gives there the trilinear interpolation of
its voxels; its blending weight is the multilinear interpolation of the 5^3
border-distance grid of ``fusion.py`` over the view (widened by one voxel a
side, each axis at its own spacing) under the cosine taper. The fused value
is the weight-normalised sum, the plain mean of the views that hold the
voxel where every weight is 0, and 0 where none does, cut to the output
dtype (truncated toward 0, saturated).

Where a mapped position lies within float32 rounding of a view's first or
last voxel centre, whether the view holds the voxel depends on how that
position was rounded. The port documents it (``ops/exact_affine.py``): per
output chunk and view, in float32, from the chunk's own voxel index ``i``
as ``((m0 * i0 + m1 * i1) + m2 * i2) + o``, each multiply and add rounded on
its own, in view voxels counted from the first voxel of the window the
chunk reads; the window is the chunk's corners mapped into the view, one
voxel wider a side, clipped to the view, and moved back so that the widest
window of the output fits the view where it would not. This module computes
its positions in that frame, so that it decides those voxels as the port
does, and checks that the frame decides nothing else: where a voxel's
membership in float32 differs from its membership in float64, the float64
position must lie within ``FACE_PX`` of a face (else ValueError).

Values and weights are computed in ``dtype``: float32 for the reference, a
lower precision for the control. Positions are float32 in both.
"""

from __future__ import annotations

import numpy as np
import torch

from .fusion import _hats, _support_grid, _taper

SPATIAL = ("z", "y", "x")
# the largest distance from a view's face, in view voxels, at which the
# float32 frame may decide a voxel's membership otherwise than float64 does
FACE_PX = 1e-3
_CORNERS = np.array(list(np.ndindex(2, 2, 2)), dtype=float)


def output_geometry(shape, spacing, affines, out_spacing: float):
    """(origin, shape) of the union of views of ``shape`` and ``spacing``
    (origin 0) under ``affines`` (V, 4, 4) on a grid of ``out_spacing``: the
    lowest mapped corner voxel centre, and the voxels up to the highest."""
    corners = _CORNERS * (np.array(shape) - 1) * np.array(spacing) + np.zeros(3)
    mapped = np.array([corners @ a[:3, :3].T + a[:3, 3] for a in affines])
    lo, hi = mapped.min(1).min(0), mapped.max(1).max(0)
    sp = np.full(3, float(out_spacing))
    out_shape = np.floor((hi - lo) / sp + 1e-9).astype(np.int64) + 1
    return lo, tuple(int(s) for s in out_shape)


def _chunks(out_shape, chunk: int):
    """Per axis, the (offset, size) of the output chunks."""
    axes = []
    for n in out_shape:
        c = min(chunk, n)
        sizes = [c] * (n // c) + ([n % c] if n % c else [])
        axes.append(list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes)))
    return axes


def _pixel_map(inv, view_spacing, view_origin, out_spacing, out_origin):
    """(m, o) in float64: output voxel index -> view voxel position, of the
    world-to-view map ``inv``, rounded to 10 decimals with offsets within
    1e-6 of a whole voxel snapped to it."""
    lin, off = inv[:3, :3], inv[:3, 3]
    sx, sy = np.diag(out_spacing), np.asarray(view_spacing)
    m = (lin @ sx) / sy[:, None]
    o = ((off + (lin - np.eye(3)) @ out_origin) - (view_origin - out_origin)) / sy
    m, o = np.around(m, decimals=10), np.around(o, decimals=10)
    whole = np.round(o)
    near = np.isclose(o, whole, rtol=0, atol=1e-6)
    o[near] = whole[near]
    return m, o


def _windows(shape, spacing, affines, origin, out_shape, out_spacing, chunk):
    """Per output chunk (offset, size, origin, [(view, start, extent)]): the
    views whose windows reach the chunk, each window's first voxel and its
    extent, in view voxels, in the frame described above; and the views'
    world-to-view maps."""
    shape = np.asarray(shape)
    sp = np.asarray(spacing, dtype=float)
    q_hi = (shape - 1) * sp
    osp = np.full(3, float(out_spacing))
    axes = _chunks(out_shape, chunk)
    invs = [np.linalg.inv(a) for a in affines]
    # chunks within the view's mapped box, widened by a view voxel a side
    reach = []
    for a in affines:
        c = (_CORNERS * (shape - 1) * sp) @ a[:3, :3].T + a[:3, 3]
        lo, hi = c.min(axis=0) - sp, c.max(axis=0) + sp
        cs = osp * np.array([ax[0][1] for ax in axes])
        first = [max(0, int(np.floor((lo[i] - origin[i]) / cs[i]))) for i in range(3)]
        last = [min(len(axes[i]) - 1, int(np.floor((hi[i] - origin[i]) / cs[i])))
                for i in range(3)]
        reach.append((first, last))
    chunks = []
    for idx in np.ndindex(*(len(ax) for ax in axes)):
        off = np.array([axes[i][idx[i]][0] for i in range(3)])
        size = np.array([axes[i][idx[i]][1] for i in range(3)])
        c_origin = origin + osp * off
        views = []
        for v, inv in enumerate(invs):
            first, last = reach[v]
            if any(not first[i] <= idx[i] <= last[i] for i in range(3)):
                continue
            corners = (_CORNERS * (size - 1) * osp + c_origin) @ inv[:3, :3].T + inv[:3, 3]
            cq_lo, cq_hi = corners.min(axis=0), corners.max(axis=0)
            b_lo = cq_lo - sp
            b_n = np.ceil((cq_hi - cq_lo) / sp).astype(np.int64) + 3
            b_hi = b_lo + (b_n - 1) * sp
            if np.any(b_lo - 1e-6 > q_hi) or np.any(b_hi < -1e-6):
                continue
            w_lo = np.maximum(b_lo, 0.0)
            w_n = np.ceil((np.minimum(b_hi, q_hi) - w_lo) / sp).astype(np.int64) + 1
            if np.any(w_n < 1):
                continue
            views.append((v, w_lo, w_n))
        chunks.append((off, size, c_origin, views))
    # the widest window of the output, and each window's first voxel moved
    # back so that a window that wide fits the view
    widest = np.max([w_n for *_, views in chunks for _, _, w_n in views], axis=0)
    room = np.maximum(0, np.maximum(shape, widest) - widest)
    out = []
    for off, size, c_origin, views in chunks:
        frames = []
        for v, w_lo, w_n in views:
            start = np.array([max(0, int(round(w_lo[i] / sp[i]))) for i in range(3)])
            stop = np.minimum(shape, start + w_n)
            start = np.minimum(start, room)
            frames.append((v, start, stop - start))
        if frames:
            out.append((off, size, c_origin, frames))
    return out, invs


def _blend_grid(shape, spacing, device, dtype) -> torch.Tensor:
    """The 5^3 border-distance grid of a view, each axis at its own spacing."""
    axes = [_support_grid((n,), s, (d,), device, dtype)
            for n, s, d in zip(shape, spacing, SPATIAL)]
    return torch.minimum(torch.minimum(axes[0].reshape(5, 1, 1), axes[1].reshape(1, 5, 1)),
                         axes[2].reshape(1, 1, 5))


def _view_sample(view, start, extent, m, o, size, dtype, grid):
    """One view over one chunk: (value, weight, held) in ``dtype``, from the
    float32 frame (m, o) counted from ``start``."""
    dev = view.device
    ii = [torch.arange(int(n), dtype=torch.float32, device=dev).reshape(
        [-1 if k == d else 1 for k in range(3)]) for d, n in enumerate(size)]
    mf = torch.tensor(m, dtype=torch.float32, device=dev)
    of = torch.tensor(o, dtype=torch.float32, device=dev)
    held = None
    pos = []
    for r in range(3):
        c = ((mf[r, 0] * ii[0] + mf[r, 1] * ii[1]) + mf[r, 2] * ii[2]) + of[r]
        inside = (c >= 0) & (c <= float(extent[r]) - 1)
        held = inside if held is None else held & inside
        pos.append(c)
    shape = view.shape
    base = [torch.floor(c) for c in pos]
    frac = [(c - b).to(dtype) for c, b in zip(pos, base)]
    lo = [(b.to(torch.int64) + int(start[r])).clamp(0, shape[r] - 1) for r, b in enumerate(base)]
    hi = [(x + 1).clamp(max=shape[r] - 1) for r, x in enumerate(lo)]
    flat = view.reshape(-1)  # float32: a CUDA gather takes no uint16

    def at(z, y, x):
        return flat[(z * shape[1] + y) * shape[2] + x].to(dtype)

    def lerp(p, q, f):
        return (1 - f) * p + f * q

    planes = []
    for z in (lo[0], hi[0]):
        rows = [lerp(at(z, y, lo[2]), at(z, y, hi[2]), frac[2]) for y in (lo[1], hi[1])]
        planes.append(lerp(rows[0], rows[1], frac[1]))
    value = lerp(planes[0], planes[1], frac[0])
    # the weight grid's coordinate: the view voxel position counted from the
    # grid's first node, one voxel before the view's first
    hats = [_hats(((pos[r] + float(start[r])).reshape(-1) + 1).to(dtype)
                  * (4.0 / (shape[r] + 1))) for r in range(3)]
    raw = torch.zeros_like(hats[0][:, 0])
    for i in range(5):
        for j in range(5):
            raw += hats[0][:, i] * hats[1][:, j] * (hats[2] @ grid[i, j])
    weight = _taper(raw).reshape(value.shape)
    return value, weight, held


def _check_frame(inv, spacing, shape, c_origin, out_spacing, size, held, dev):
    """ValueError unless the float32 frame's membership ``held`` agrees with
    float64 membership wherever the float64 position lies farther than
    FACE_PX from a face; returns how many voxels within FACE_PX it decides
    otherwise."""
    m, o = _pixel_map(inv, spacing, np.zeros(3), np.full(3, float(out_spacing)), c_origin)
    ii = [torch.arange(int(n), dtype=torch.float64, device=dev).reshape(
        [-1 if k == d else 1 for k in range(3)]) for d, n in enumerate(size)]
    exact, near = None, None
    for r in range(3):
        c = m[r, 0] * ii[0] + m[r, 1] * ii[1] + m[r, 2] * ii[2] + o[r]
        inside = (c >= 0) & (c <= shape[r] - 1)
        close = (c.abs() <= FACE_PX) | ((c - (shape[r] - 1)).abs() <= FACE_PX)
        exact = inside if exact is None else exact & inside
        near = close if near is None else near | close
    differ = exact != held
    if bool((differ & ~near).any()):
        raise ValueError("a view's window does not hold its part of the chunk")
    return int(differ.sum())


def fuse(views: torch.Tensor, spacing, affines, out_spacing: float, chunk: int = 256,
         dtype=torch.float32, out_dtype=torch.uint16):
    """Fuse ``views`` ((V, Z, Y, X), on their device) of ``spacing`` (z, y,
    x; origin 0) placed by ``affines`` ((V, 4, 4) view-to-world) onto the
    union's grid of ``out_spacing``, in output chunks of ``chunk`` voxels a
    side. Returns (fused tensor in ``out_dtype`` on the views' device,
    origin, shape, voxels near a face whose membership the float32 frame
    decided)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the weights' products stay in dtype
    try:
        return _fuse(views, spacing, affines, out_spacing, chunk, dtype, out_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _fuse(views, spacing, affines, out_spacing, chunk, dtype, out_dtype):
    affines = np.asarray(affines, dtype=np.float64)
    dev = views.device
    shape = tuple(int(s) for s in views.shape[1:])
    origin, out_shape = output_geometry(shape, spacing, affines, out_spacing)
    chunks, invs = _windows(shape, spacing, affines, origin, out_shape, out_spacing, chunk)
    grid = _blend_grid(shape, spacing, dev, dtype)
    views = views.to(torch.float32)
    out = torch.zeros(out_shape, dtype=out_dtype, device=dev)
    info = torch.iinfo(out_dtype)
    near_faces = 0
    osp = np.full(3, float(out_spacing))
    for off, size, c_origin, frames in chunks:
        acc = wsum = vacc = vcnt = None
        for v, start, extent in frames:
            m, o = _pixel_map(invs[v], spacing, np.asarray(spacing) * start, osp, c_origin)
            value, weight, held = _view_sample(views[v], start, extent, m, o, size, dtype, grid)
            near_faces += _check_frame(invs[v], spacing, shape, c_origin, out_spacing, size,
                                       held, dev)
            keep = held.to(dtype)
            value = torch.where(held, value, torch.zeros((), dtype=dtype, device=dev))
            weight = weight * keep
            if acc is None:
                acc, wsum, vacc, vcnt = weight * value, weight, value, keep
            else:
                acc, wsum = acc + weight * value, wsum + weight
                vacc, vcnt = vacc + value, vcnt + keep
        res = torch.where(wsum > 0, acc / torch.clamp(wsum, min=1e-12),
                          vacc / torch.clamp(vcnt, min=1.0))
        res = torch.nan_to_num(res.to(torch.float32)).clamp(info.min, info.max)
        region = tuple(slice(int(a), int(a + n)) for a, n in zip(off, size))
        out[region] = res.to(torch.int32).to(out_dtype)
    return out, origin, out_shape, near_faces
