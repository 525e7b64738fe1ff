"""Translation-tile fusion kernels: the port of ``ops/pallas_fusion.py``.

``fuse_translation_3d`` replaces the Pallas TPU kernel
``multiview_stitcher_tpu/ops/pallas_fusion.py::_fuse_tile_kernel_3d`` and
``fuse_translation_2d`` replaces ``::_fuse_tile_kernel``. They take the JAX
wrappers' arguments and fuse a whole output from V translation-placed views
with the default weighted-average blending: per output pixel and per view
slot of its output tile, a tri/bilinear sample of the view at
``scale * o + off``, masked by the view's true extents and weighted by the
cosine-tapered hat expansion of its 5^ndim EDT-proxy grid. The output is
``acc / wsum``, or the plain valid mean where ``wsum == 0``, then
``nan_to_num`` and a truncating cast to ``out_dtype``.

For a CUDA tensor a wrapper launches the hand-written CUDA C++ kernel of
``csrc/translation_fusion.cu`` (built for sm_90a at first use) or raises; it
takes the plain PyTorch version ``*_plain`` only for a tensor on the CPU.
Each wrapper counts its launches in its ``launches`` attribute.

What bounds the kernels on the H100 is, on paper, memory (each input voxel is
read about once and each output voxel written once, at a few tens of f32
operations per covering view) and, as measured, their instruction count. The
kernels gather straight from the tile stack in its native dtype (no f32
copy), stage each output tile's view list and weight grids in shared memory,
compute what depends on one index alone once a block into tables, carry a
row's or plane's upper taps to the next and fuse ``nan_to_num`` and the cast
into the store. The 3D kernel gives a block 8 x 32 columns and up to 64
planes of a view-list tile, which is why ``fuse`` lists its views at
``TILE_SHAPE_3D = (64, 8, 32)``, and walks z in runs of 8 planes; the 2D
kernel gives a block 64 rows x 32 columns, a thread one column and a run of
8 rows, so ``fuse`` lists its views at ``TILE_SHAPE_2D = (64, 32)``. The
wrappers take any ``tile_shape``; the source file's header gives the details
and the measurements.

Numerics kept from the reference, in f32 and in this order (named here
because each is a place where a port goes wrong):

- the sample position is split at the tile origin: ``c0 = off + sc * o0``
  becomes ``floor(c0) + f`` and the view is sampled at ``sc * i + f`` inside
  the tile; validity is tested with ``sc * a + off`` and the weight
  coordinates are ``wdiag * a + woff``, both from the absolute index ``a``;
- 3D z has two modes: with uniform ``scale`` the z scale is an integer
  ``SZ`` and plane ``i`` lerps ``floor(c0) + SZ * i`` with the fixed fraction
  ``f``; with per-view ``scales`` z takes any float, like y and x;
- the lerp runs z, then y, then x; the 3D hat expansion is summed as
  ``sum_i hz * (sum_j hy * (sum_k g * hx))``; slots are summed in ascending
  order;
- reads one past a view's last row, column or plane (lerp weight 0) clamp
  the index to the stack, where the reference's atlas read a neighbouring
  view; mixed tile shapes are edge-padded to a common stack and masked by
  the extents;
- the reference's atlas adds an integer atlas origin to ``offs`` in f32; the
  port does not, so with fractional offsets a sample position can differ by
  one ulp of the atlas extent. Integer offsets agree exactly.

The tiles must be finite: ``fusion.fuse`` applies ``nan_to_num`` to float
tiles before the upload, as the reference does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multiview_stitcher_torch import weights
from multiview_stitcher_torch.ops import _build

# tile shapes at which ``fuse`` builds its per-tile view lists: a kernel
# block's, one list a block. 2D: 64 rows x 32 columns, so a list, its
# parameters and its row and column tables are staged once for 2,048 pixels.
# 3D: the block's 8 x 32 columns and the 64 planes a block walks, so a list,
# its parameters and its z tables are staged once for 16,384 voxels
TILE_SHAPE_2D = (64, 32)
TILE_SHAPE_3D = (64, 8, 32)

# dtype codes of csrc/translation_fusion.cu
_DTYPE_CODES = {torch.float32: 0, torch.uint16: 1, torch.uint8: 2}


class _Args(NamedTuple):
    view_idx: torch.Tensor  # (*n_t, K) int32
    params: torch.Tensor    # (V, 5 * ndim) f32: off | extent | wdiag | woff | scale
    wgrids: torch.Tensor    # (V, 5 ** ndim) f32
    origin: Tuple[int, ...]
    per_view: bool


def _check_args(ndim, tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                out_shape, tile_shape, K, origin, scale, scales) -> _Args:
    dev = tiles.device
    if tiles.dim() != ndim + 1:
        raise ValueError(f"tiles must be (V, *{ndim}D tile), got {tuple(tiles.shape)}")
    if len(out_shape) != ndim or len(tile_shape) != ndim:
        raise ValueError("out_shape and tile_shape need one entry per spatial dim")
    V = tiles.shape[0]
    n_t = tuple(-(-int(o) // int(t)) for o, t in zip(out_shape, tile_shape))
    view_idx = torch.as_tensor(view_idx, dtype=torch.int32, device=dev).contiguous()
    if tuple(view_idx.shape) != n_t + (K,):
        raise ValueError(f"view_idx must be {n_t + (K,)}, got {tuple(view_idx.shape)}")
    per_view = scales is not None
    if per_view:
        sc = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    else:
        if ndim == 3 and float(scale[0]) != int(scale[0]):
            raise ValueError("3D translation fusion requires an integer z scale")
        sc = torch.tensor([float(s) for s in scale], dtype=torch.float32, device=dev)
        sc = sc.expand(V, ndim)
    cols = [
        torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(V, ndim)
        for x in (offs, extents, wdiags, woffs)
    ]
    params = torch.cat(cols + [sc.reshape(V, ndim)], dim=1).contiguous()
    grids = torch.as_tensor(wgrids, dtype=torch.float32, device=dev)
    grids = grids.reshape(V, 5**ndim).contiguous()
    origin = (0,) * ndim if origin is None else tuple(
        int(o) for o in torch.as_tensor(origin).tolist()
    )
    return _Args(view_idx, params, grids, origin, per_view)


def _z_stride(scale) -> int:
    """Integer z stride of the 3D uniform mode. Per-view calls pass the
    ceiled maximum z scale in ``scale``, as the reference does; only
    uniform mode reads it."""
    return int(np.ceil(float(scale[0])))


def _cast(res: torch.Tensor, out_dtype) -> torch.Tensor:
    """nan_to_num, then jnp's ``astype``: integer types truncate toward zero
    and saturate at their range, float types round, bool is "not zero"."""
    res = torch.nan_to_num(res)
    if out_dtype.is_floating_point:
        return res.to(out_dtype)
    if out_dtype == torch.bool:
        return res != 0
    info = torch.iinfo(out_dtype)
    if info.bits < 32:
        return res.clamp(info.min, info.max).to(out_dtype)
    # f32 holds none of 2**31 - 1, 2**32 - 1, 2**63 - 1: decide the ends in
    # f64, where 2**bits-ish bounds are exact, and convert only what is inside
    res = res.to(torch.float64)
    top = float(info.max) + 1.0  # 2**31, 2**32, 2**63 or 2**64 exactly
    inside = torch.where((res > info.min) & (res < top), res, 0.0).to(out_dtype)
    full = torch.full_like(inside, info.max)
    return torch.where(res >= top, full, torch.where(res <= info.min, info.min, inside))


def _lerp(a, b, f):
    return (1 - f) * a + f * b


def _hats(g):
    return [torch.clamp(1 - torch.abs(g - i), min=0) for i in range(5)]


def _blocked(ndim, d, x):
    """Place a per-axis tensor of shape (n_t, T) into the blocked layout
    (n_t0, T0, n_t1, T1, ...) of the output."""
    shape = [1] * (2 * ndim)
    shape[2 * d], shape[2 * d + 1] = x.shape
    return x.reshape(shape)


def _plain(ndim, tiles, out_shape, tile_shape, K, out_dtype, a: _Args, SZ=1):
    """Plain PyTorch version of both kernels, on the output in its blocked
    layout (tile index, in-tile index) per axis."""
    dev = tiles.device
    vals = tiles.to(torch.float32)
    sizes = vals.shape[1:]
    T = [int(t) for t in tile_shape]
    n_t = [-(-int(o) // t) for o, t in zip(out_shape, T)]
    V = vals.shape[0]
    grids = a.wgrids.reshape((V,) + (5,) * ndim)

    o0, ii = [], []  # tile-origin absolute index, in-tile index per axis
    for d in range(ndim):
        t_idx = torch.arange(n_t[d], device=dev) * T[d] + a.origin[d]
        o0.append(_blocked(ndim, d, t_idx[:, None]))
        ii.append(_blocked(ndim, d, torch.arange(T[d], device=dev)[None, :]))
    absf = [(o + i).to(torch.float32) for o, i in zip(o0, ii)]

    blocked = []
    for d in range(ndim):
        blocked += [n_t[d], T[d]]
    acc = torch.zeros(blocked, device=dev)
    wsum = torch.zeros_like(acc)
    vacc = torch.zeros_like(acc)
    vcnt = torch.zeros_like(acc)
    # per-tile quantities broadcast as (n_t0, 1, n_t1, 1, ...)
    tile_view = [slice(None), None] * ndim

    for k in range(K):
        slot = a.view_idx[..., k].long()
        present = (slot >= 0)[tuple(tile_view)]
        v = slot.clamp(min=0)[tuple(tile_view)]
        p = a.params[v]  # (..., 5 * ndim)
        g = grids[v]     # (..., 5, ...)

        valid = present
        lo, hi, frac = [], [], []
        for d in range(ndim):
            off, ext, sc = p[..., d], p[..., ndim + d], p[..., 4 * ndim + d]
            c = sc * absf[d] + off
            valid = valid & (c >= 0) & (c <= ext - 1)
            c0 = off + sc * o0[d].to(torch.float32)
            b0 = torch.floor(c0)
            f = c0 - b0
            if ndim == 3 and d == 0 and not a.per_view:
                idx = b0.long() + SZ * ii[0]
                fr = f
            else:
                pos = sc * ii[d].to(torch.float32) + f
                b = torch.floor(pos)
                idx = b0.long() + b.long()
                fr = pos - b
            lo.append(idx.clamp(0, sizes[d] - 1))
            hi.append((idx + 1).clamp(0, sizes[d] - 1))
            frac.append(fr)

        def at(*idx):
            return vals[(v,) + idx]

        if ndim == 3:
            z0, z1 = lo[0], hi[0]
            fz = frac[0]
            zl = [
                [_lerp(at(z0, y, x), at(z1, y, x), fz) for x in (lo[2], hi[2])]
                for y in (lo[1], hi[1])
            ]  # zl[y][x]
            val = _lerp(
                _lerp(zl[0][0], zl[1][0], frac[1]),
                _lerp(zl[0][1], zl[1][1], frac[1]),
                frac[2],
            )
        else:
            val = _lerp(
                _lerp(at(lo[0], lo[1]), at(hi[0], lo[1]), frac[0]),
                _lerp(at(lo[0], hi[1]), at(hi[0], hi[1]), frac[0]),
                frac[1],
            )

        gcoord = [
            p[..., 2 * ndim + d] * absf[d] + p[..., 3 * ndim + d] for d in range(ndim)
        ]
        hats = [_hats(gc) for gc in gcoord]
        if ndim == 3:
            hz, hy, hx = hats
            w = 0
            for i in range(5):
                in_y = 0
                for j in range(5):
                    in_x = 0
                    for kk in range(5):
                        in_x = in_x + g[..., i, j, kk] * hx[kk]
                    in_y = in_y + hy[j] * in_x
                w = w + hz[i] * in_y
        else:
            hy, hx = hats
            w = 0
            for i in range(5):
                for j in range(5):
                    w = w + g[..., i, j] * hy[i] * hx[j]
        w = torch.where(valid, weights.cosine_weights(w), 0.0)
        val = torch.where(valid, val, 0.0)
        acc = acc + w * val
        wsum = wsum + w
        vacc = vacc + val
        vcnt = vcnt + valid.to(torch.float32)

    res = torch.where(
        wsum > 0,
        acc / torch.clamp(wsum, min=1e-12),
        vacc / torch.clamp(vcnt, min=1.0),
    )
    res = res.reshape([n * t for n, t in zip(n_t, T)])
    res = res[tuple(slice(0, int(o)) for o in out_shape)]
    return _cast(res, out_dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("translation_fusion")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mvs_fuse_translation_3d.argtypes = [
        P, I, I, I, I, P, I, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P,
    ]
    lib.mvs_fuse_translation_3d.restype = I
    lib.mvs_fuse_translation_2d.argtypes = [
        P, I, I, I, P, I, P, P, P, I, I, I, I, I, I, I, P,
    ]
    lib.mvs_fuse_translation_2d.restype = I
    return lib


def kernel_input(tiles: torch.Tensor) -> torch.Tensor:
    """``tiles`` in a dtype the kernels read: as they are when uint8, uint16
    or float32, else cast to float32 on their device, as the reference casts
    every input before its kernels."""
    return tiles if tiles.dtype in _DTYPE_CODES else tiles.to(torch.float32)


def _launch(ndim, tiles, out_shape, tile_shape, K, out_dtype, a: _Args, SZ=1):
    """Launch the kernel on the current stream; (output, whether it launched).
    Other input dtypes are read as float32; other output dtypes are written
    as float32 and then cast by :func:`_cast`."""
    if tiles.device.type != "cuda":
        raise ValueError(f"tiles must lie on the CPU or a CUDA device, got {tiles.device}")
    tiles = kernel_input(tiles).contiguous()
    in_code = _DTYPE_CODES[tiles.dtype]
    write_dtype = out_dtype if out_dtype in _DTYPE_CODES else torch.float32
    out_code = _DTYPE_CODES[write_dtype]
    out = torch.empty(tuple(int(o) for o in out_shape), dtype=write_dtype, device=tiles.device)
    if out.numel() == 0:
        return _cast(out, out_dtype), False
    lib = _library()
    with torch.cuda.device(tiles.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        common = (
            a.view_idx.data_ptr(), K, a.params.data_ptr(), a.wgrids.data_ptr(),
            out.data_ptr(), out_code,
        )
        if ndim == 3:
            rc = lib.mvs_fuse_translation_3d(
                tiles.data_ptr(), in_code, *tiles.shape[1:], *common,
                *out.shape, *(int(t) for t in tile_shape), *a.origin,
                int(a.per_view), int(SZ), stream,
            )
        else:
            rc = lib.mvs_fuse_translation_2d(
                tiles.data_ptr(), in_code, *tiles.shape[1:], *common,
                *out.shape, *(int(t) for t in tile_shape), *a.origin, stream,
            )
    _build.check(lib, rc, f"fuse_translation_{ndim}d")
    return (out if write_dtype == out_dtype else _cast(out, out_dtype)), True


def fuse_translation_2d_plain(
    tiles: torch.Tensor,
    view_idx,
    offs,
    extents,
    wdiags,
    woffs,
    wgrids,
    out_shape: Sequence[int],
    tile_shape: Sequence[int] = TILE_SHAPE_2D,
    K: int = 4,
    out_dtype=torch.float32,
    origin=None,
    scale=(1.0, 1.0),
    scales=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fuse_translation_2d`, on any device."""
    a = _check_args(2, tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                    out_shape, tile_shape, K, origin, scale, scales)
    return _plain(2, tiles, out_shape, tile_shape, K, out_dtype, a)


def fuse_translation_2d(
    tiles: torch.Tensor,
    view_idx,
    offs,
    extents,
    wdiags,
    woffs,
    wgrids,
    out_shape: Sequence[int],
    tile_shape: Sequence[int] = TILE_SHAPE_2D,
    K: int = 4,
    out_dtype=torch.float32,
    origin=None,
    scale=(1.0, 1.0),
    scales=None,
) -> torch.Tensor:
    """Fuse a 2D output from translation-placed tiles (weighted average with
    cosine blending) with per-tile view lists.

    ``tiles`` (V, H, W); ``view_idx`` (n_ty, n_tx, K) int32, -1 for empty
    slots, over tiles of ``tile_shape``; ``offs``/``extents``/``wdiags``/
    ``woffs`` (V, 2); ``wgrids`` (V, 5, 5); ``origin`` the integer output
    origin of a banded call; ``scale`` the uniform output-pixel -> view-pixel
    scale, or ``scales`` (V, 2) per view. Returns (OY, OX) in ``out_dtype``.
    """
    a = _check_args(2, tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                    out_shape, tile_shape, K, origin, scale, scales)
    if tiles.device.type == "cpu":
        return _plain(2, tiles, out_shape, tile_shape, K, out_dtype, a)
    out, launched = _launch(2, tiles, out_shape, tile_shape, K, out_dtype, a)
    fuse_translation_2d.launches += launched
    return out


fuse_translation_2d.launches = 0


def fuse_translation_3d_plain(
    tiles: torch.Tensor,
    view_idx,
    offs,
    extents,
    wdiags,
    woffs,
    wgrids,
    out_shape: Sequence[int],
    tile_shape: Sequence[int] = TILE_SHAPE_3D,
    K: int = 4,
    out_dtype=torch.float32,
    origin=None,
    scale=(1, 1.0, 1.0),
    scales=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fuse_translation_3d`, on any device."""
    a = _check_args(3, tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                    out_shape, tile_shape, K, origin, scale, scales)
    return _plain(3, tiles, out_shape, tile_shape, K, out_dtype, a, SZ=_z_stride(scale))


def fuse_translation_3d(
    tiles: torch.Tensor,
    view_idx,
    offs,
    extents,
    wdiags,
    woffs,
    wgrids,
    out_shape: Sequence[int],
    tile_shape: Sequence[int] = TILE_SHAPE_3D,
    K: int = 4,
    out_dtype=torch.float32,
    origin=None,
    scale=(1, 1.0, 1.0),
    scales=None,
) -> torch.Tensor:
    """Fuse a 3D output from translation-placed tiles with per-tile view lists.

    ``tiles`` (V, D, H, W); ``view_idx`` (n_tz, n_ty, n_tx, K) int32;
    tables (V, 3); ``wgrids`` (V, 5, 5, 5). With uniform ``scale`` the z
    component must be an integer; per-view ``scales`` (V, 3) take any float
    z. Returns (OZ, OY, OX) in ``out_dtype``.
    """
    a = _check_args(3, tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                    out_shape, tile_shape, K, origin, scale, scales)
    SZ = _z_stride(scale)
    if tiles.device.type == "cpu":
        return _plain(3, tiles, out_shape, tile_shape, K, out_dtype, a, SZ=SZ)
    out, launched = _launch(3, tiles, out_shape, tile_shape, K, out_dtype, a, SZ=SZ)
    fuse_translation_3d.launches += launched
    return out


fuse_translation_3d.launches = 0
