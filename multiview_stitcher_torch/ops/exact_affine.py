"""Exact affine resampling kernels: the port of ``ops/exact_affine.py``.

``exact_affine_batch_2d`` replaces the Pallas TPU kernel
``multiview_stitcher_tpu/ops/exact_affine.py::_exact2d_kernel``,
``exact_affine_batch_3d_sepy`` replaces ``::_exact3d_sepy_kernel`` and
``exact_affine_batch_3d_general`` replaces ``::_exact3d_general_kernel``.
Each resamples B items with exact bi/trilinear interpolation (scipy
``affine_transform(order=1, mode='constant')`` semantics): output pixel ``n``
of item ``b`` samples input coordinate ``mats[b] @ n + offs[b]``; coordinates
outside ``[0, extents[b] - 1]`` give exactly ``cval``. The arguments keep the
reference's order ``(data, mats, offs, extents, out_shape, cval=nan)``.

For a CUDA tensor a wrapper launches the hand-written CUDA C++ kernel of
``csrc/exact_affine.cu`` (built for sm_90a at first use) or raises; it takes
the plain PyTorch version ``*_plain`` only for a tensor on the CPU. Each
wrapper counts its launches in its ``launches`` attribute. The tables of a
call (``mats``, ``offs``, ``extents``, ``tile_idx``, ``starts``, ``valid``)
are packed into the kernels' two parameter arrays on the host and uploaded in
one copy when all of them are host arrays, and on the device, with no
read-back, when any is a tensor.

What the reference's wrappers take and these do not: ``tile``, ``HW``,
``WW``, ``ZS``, ``XS``, ``YW``, ``YB``, ``interpret`` and the
``plan_windows_*`` planners. They size the window DMAs and the banded-hat
matmuls that stand in for a gather on a machine that has none. Here a
thread computes its sample coordinate, takes ``floor`` and the fraction and
reads its 4 or 8 neighbours. Every kernel first copies the box of source
voxels that a block's output tile can touch into shared memory and
interpolates from there; a block whose box exceeds the shared-memory budget
(a map that downscales by 3 or more, a steep shear) gathers from global
memory instead, so no map is ever too large for a window, and a tile that no
valid sample reaches is filled with ``cval`` at once. :func:`record_routes`
and :func:`read_routes` count which of the three a call's blocks took.

What these take and the reference's do not (all optional): ``tile_idx`` and
``starts`` make item ``b`` read ``data[tile_idx[b]]`` shifted by the integer
``starts[b]``, so that a batch samples straight from a resident ``(V, *tile)``
stack where the reference slices slabs out of it first; ``valid`` marks
padding items, which are filled with ``cval`` without being sampled, as is an
item whose ``tile_idx`` lies outside the stack.

Numerics kept from the reference (each is a place where a port goes wrong):

- the validity mask is computed in f32 from the absolute output index, as
  ``m_r0 * i0 + m_r1 * i1 (+ m_r2 * i2) + off_r``, left to right, each multiply
  and add rounded on its own (no FMA). The y-decoupled kernel uses only the
  five entries of its family: ``m00 * z + m02 * x``, ``m11 * y``,
  ``m20 * z + m22 * x``;
- the value is interpolated at that same coordinate (the reference
  interpolates at window-local coordinates, which differ by f32 ulps of the
  coordinate; its own bound against its gather tier, 5e-3 on data in
  [0, 100), holds here too);
- the source is read in its native dtype; float input gets ``nan_to_num``
  (NaN -> 0, +-inf -> +-largest finite f32) in registers;
- a read one past the last valid row, column or plane (lerp weight exactly
  0) clamps its index to the array, where the reference read its edge
  padding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from multiview_stitcher_torch.ops import _build

# dtype codes of csrc/exact_affine.cu
_DTYPE_CODES = {torch.float32: 0, torch.uint16: 1, torch.uint8: 2}

# matrix columns that enter each coordinate row, in summation order
_TERMS_FULL_2D = ((0, 1), (0, 1))
_TERMS_FULL_3D = ((0, 1, 2), (0, 1, 2), (0, 1, 2))
_TERMS_SEPY = ((0, 2), (1,), (0, 2))


def hat(x: torch.Tensor) -> torch.Tensor:
    """Exact lerp-weight tent: contributes (1-frac, frac) to the two
    neighbouring integer positions and exactly 0 elsewhere."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def is_y_decoupled(mats, atol=1e-9) -> bool:
    """True when every (3, 3) pixel map decouples the middle axis: input y
    depends only on output y, and input z/x do not depend on output y (the
    multi-view rotate-around-y family)."""
    m = np.asarray(mats, dtype=np.float64).reshape(-1, 3, 3)
    return bool(
        np.all(np.abs(m[:, 0, 1]) <= atol)
        & np.all(np.abs(m[:, 2, 1]) <= atol)
        & np.all(np.abs(m[:, 1, 0]) <= atol)
        & np.all(np.abs(m[:, 1, 2]) <= atol)
    )


class _Args(NamedTuple):
    data: torch.Tensor     # (V, *S) contiguous, native dtype
    fparams: torch.Tensor  # (B, ndim * ndim + 2 * ndim) f32: mat | off | extent
    iparams: torch.Tensor  # (B, ndim + 2) int32: source index | start | valid
    out_shape: tuple
    cval: float


def _check_args(ndim, data, mats, offs, extents, out_shape, cval,
                tile_idx, starts, valid) -> _Args:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data).__name__}")
    if data.dim() != ndim + 1:
        raise ValueError(f"data must be (B, *{ndim}D), got {tuple(data.shape)}")
    if len(out_shape) != ndim:
        raise ValueError(f"out_shape needs {ndim} entries, got {tuple(out_shape)}")
    out_shape = tuple(int(o) for o in out_shape)
    tables = [mats, offs, extents] + [x for x in (tile_idx, starts, valid) if x is not None]
    pack = _pack_on_device if any(isinstance(x, torch.Tensor) for x in tables) else _pack_on_host
    fparams, iparams = pack(ndim, data, mats, offs, extents, tile_idx, starts, valid)
    return _Args(data.contiguous(), fparams, iparams, out_shape, float(cval))


def _check_shapes(ndim, data, mats, offs, extents, tile_idx, starts) -> int:
    """The argument checks both packings share; returns B."""
    if mats.ndim != 3 or tuple(mats.shape[1:]) != (ndim, ndim):
        raise ValueError(f"mats must be (B, {ndim}, {ndim}), got {tuple(mats.shape)}")
    B = mats.shape[0]
    for name, x in (("offs", offs), ("extents", extents)):
        if tuple(x.shape) != (B, ndim):
            raise ValueError(f"{name} must be ({B}, {ndim}), got {tuple(x.shape)}")
    if (tile_idx is None) != (starts is None):
        raise ValueError("tile_idx and starts go together")
    if tile_idx is None:
        if data.shape[0] != B:
            raise ValueError(f"data holds {data.shape[0]} items, mats {B}")
    elif not isinstance(tile_idx, torch.Tensor):
        idx = np.asarray(tile_idx)
        if idx.size and (idx.min() < 0 or idx.max() >= data.shape[0]):
            raise ValueError(f"tile_idx must lie in [0, {data.shape[0]}), got {idx.min()}..{idx.max()}")
    return B


def _pack_on_host(ndim, data, mats, offs, extents, tile_idx, starts, valid):
    """``fparams`` and ``iparams`` from host arrays: packed with numpy into
    one buffer, which goes to the device of ``data`` in one copy."""
    mats, offs, extents = (np.asarray(x, dtype=np.float32) for x in (mats, offs, extents))
    B = _check_shapes(ndim, data, mats, offs, extents, tile_idx, starts)
    nf, ni = ndim * ndim + 2 * ndim, ndim + 2
    buf = np.empty(B * (nf + ni), dtype=np.int32)
    f = buf[: B * nf].view(np.float32).reshape(B, nf)
    i = buf[B * nf :].reshape(B, ni)
    f[:, : ndim * ndim] = mats.reshape(B, ndim * ndim)
    f[:, ndim * ndim : ndim * ndim + ndim] = offs
    f[:, ndim * ndim + ndim :] = extents
    if tile_idx is None:
        i[:, 0] = np.arange(B)
        i[:, 1 : 1 + ndim] = 0
    else:
        i[:, 0] = np.asarray(tile_idx).reshape(B)
        i[:, 1 : 1 + ndim] = np.asarray(starts).reshape(B, ndim)
    i[:, ndim + 1] = 1 if valid is None else np.asarray(valid).reshape(B)
    dev_buf = torch.from_numpy(buf).to(data.device)
    return (dev_buf[: B * nf].view(torch.float32).reshape(B, nf),
            dev_buf[B * nf :].reshape(B, ni))


def _pack_on_device(ndim, data, mats, offs, extents, tile_idx, starts, valid):
    """``fparams`` and ``iparams`` when a table is a tensor: converted and
    concatenated on the device of ``data``, with no read-back."""
    dev = data.device
    mats, offs, extents = (
        torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (mats, offs, extents)
    )
    B = _check_shapes(ndim, data, mats, offs, extents, tile_idx, starts)
    if tile_idx is None:
        src = torch.arange(B, dtype=torch.int32, device=dev)
        st = torch.zeros((B, ndim), dtype=torch.int32, device=dev)
    else:
        src = torch.as_tensor(tile_idx, dtype=torch.int32, device=dev).reshape(B)
        st = torch.as_tensor(starts, dtype=torch.int32, device=dev).reshape(B, ndim)
    ok = (
        torch.ones(B, dtype=torch.int32, device=dev)
        if valid is None
        else torch.as_tensor(valid, device=dev).reshape(B).to(torch.int32)
    )
    return (
        torch.cat([mats.reshape(B, ndim * ndim), offs, extents], dim=1).contiguous(),
        torch.cat([src[:, None], st, ok[:, None]], dim=1).contiguous(),
    )


def _plain(ndim, a: _Args, terms) -> torch.Tensor:
    """Plain PyTorch version of the three kernels: index arithmetic and
    gathers, with the mask and lerp order of the kernels."""
    dev = a.data.device
    B = a.fparams.shape[0]
    mats = a.fparams[:, : ndim * ndim].reshape(B, ndim, ndim)
    offs = a.fparams[:, ndim * ndim : ndim * ndim + ndim]
    ext = a.fparams[:, ndim * ndim + ndim :]
    src = a.iparams[:, 0].long()
    sizes = a.data.shape[1:]

    def per_item(x):
        return x.reshape((B,) + (1,) * ndim)

    grid = []
    for d, n in enumerate(a.out_shape):
        shape = [1] * (ndim + 1)
        shape[d + 1] = n
        grid.append(torch.arange(n, dtype=torch.float32, device=dev).reshape(shape))

    # an item is sampled when it is marked valid and names a source of the stack
    in_stack = (a.iparams[:, 0] >= 0) & (a.iparams[:, 0] < a.data.shape[0])
    inside = per_item((a.iparams[:, ndim + 1] != 0) & in_stack)
    src = src.clamp(0, a.data.shape[0] - 1)
    lo, hi, frac = [], [], []
    for r in range(ndim):
        c = None
        for col in terms[r]:
            t = per_item(mats[:, r, col]) * grid[col]
            c = t if c is None else c + t
        c = c + per_item(offs[:, r])
        inside = inside & (c >= 0) & (c <= per_item(ext[:, r]) - 1)
        f = torch.floor(c)
        i0 = f.long() + per_item(a.iparams[:, 1 + r].long())
        lo.append(i0.clamp(0, sizes[r] - 1))
        hi.append((i0 + 1).clamp(0, sizes[r] - 1))
        frac.append(c - f)

    full = (B,) + a.out_shape
    v = per_item(src).expand(full)
    lo = [x.expand(full) for x in lo]
    hi = [x.expand(full) for x in hi]

    # uint16 has no gather on every device: read its bits as int16
    is_u16 = a.data.dtype == torch.uint16
    source = a.data.view(torch.int16) if is_u16 else a.data

    def at(*idx):
        val = source[(v,) + idx]
        if is_u16:
            val = val.to(torch.int32) & 0xFFFF
        val = val.to(torch.float32)
        return torch.nan_to_num(val) if a.data.dtype.is_floating_point else val

    def lerp(p, q, f):
        return (1 - f) * p + f * q

    # the last axis first, then outwards
    if ndim == 2:
        rows = [lerp(at(y, lo[1]), at(y, hi[1]), frac[1]) for y in (lo[0], hi[0])]
        val = lerp(rows[0], rows[1], frac[0])
    else:
        planes = []
        for z in (lo[0], hi[0]):
            rows = [lerp(at(z, y, lo[2]), at(z, y, hi[2]), frac[2]) for y in (lo[1], hi[1])]
            planes.append(lerp(rows[0], rows[1], frac[1]))
        val = lerp(planes[0], planes[1], frac[0])
    return torch.where(inside, val, torch.full((), a.cval, dtype=torch.float32, device=dev))


_ENTRY_POINTS = ("mvs_exact_affine_2d", "mvs_exact_affine_3d_sepy", "mvs_exact_affine_3d_general")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("exact_affine")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mvs_exact_affine_2d.argtypes = [P, I, I, I, I, P, P, I, P, I, I, F, P, P]
    for name in _ENTRY_POINTS[1:]:
        getattr(lib, name).argtypes = [P, I, I, I, I, I, P, P, I, P, I, I, I, F, P, P]
    for name in _ENTRY_POINTS:
        getattr(lib, name).restype = I
    return lib


ROUTES = ("shared", "gather", "fill")
_route_counts = None  # a CUDA int64 tensor of len(ROUTES) while routes are recorded


def record_routes(device) -> None:
    """Start counting, on ``device``, the routes the kernels take: per block
    (2D and general 3D) or run of y rows (y-decoupled), whether it staged its
    source box in shared memory ("shared"), took the per-voxel global gathers
    because the box exceeds the budget ("gather"), or filled a tile that no
    valid sample reaches with ``cval`` ("fill"). Counting costs an atomic add
    a block, so it is off unless asked for."""
    global _route_counts
    _route_counts = torch.zeros(len(ROUTES), dtype=torch.int64, device=device)


def read_routes() -> dict:
    """Stop counting; the counts since :func:`record_routes` by route."""
    global _route_counts
    counts, _route_counts = _route_counts, None
    return dict(zip(ROUTES, counts.tolist()))


def _route_counter(device) -> ctypes.c_void_p:
    if _route_counts is None or _route_counts.device != device:
        return ctypes.c_void_p(0)
    return ctypes.c_void_p(_route_counts.data_ptr())


def kernel_input(data: torch.Tensor) -> torch.Tensor:
    """``data`` in a dtype the kernels read: as it is when uint8, uint16 or
    float32, else cast to float32 on its device, as the reference casts every
    input before its kernels."""
    return data if data.dtype in _DTYPE_CODES else data.to(torch.float32)


def _launch(entry: str, a: _Args) -> tuple:
    """Launch ``entry`` on the current stream; (output, whether it launched)."""
    if a.data.device.type != "cuda":
        raise ValueError(f"data must lie on the CPU or a CUDA device, got {a.data.device}")
    if a.data.dtype not in _DTYPE_CODES:
        # other dtypes are read as float32, cast on the device as the reference does
        a = a._replace(data=kernel_input(a.data))
    B = a.fparams.shape[0]
    out = torch.empty((B,) + a.out_shape, dtype=torch.float32, device=a.data.device)
    if out.numel() == 0:
        return out, False
    lib = _library()
    with torch.cuda.device(a.data.device):
        rc = getattr(lib, entry)(
            a.data.data_ptr(), _DTYPE_CODES[a.data.dtype], *a.data.shape,
            a.fparams.data_ptr(), a.iparams.data_ptr(), B,
            out.data_ptr(), *a.out_shape, ctypes.c_float(a.cval),
            _route_counter(a.data.device),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(lib, rc, entry)
    return out, True


def _make(name: str, ndim: int, entry: str, terms, doc: str):
    """The wrapper and its plain version for one kernel."""

    def plain(data, mats, offs, extents, out_shape: Sequence[int], cval=float("nan"),
              tile_idx=None, starts=None, valid=None) -> torch.Tensor:
        a = _check_args(ndim, data, mats, offs, extents, out_shape, cval,
                        tile_idx, starts, valid)
        return _plain(ndim, a, terms)

    def wrapper(data, mats, offs, extents, out_shape: Sequence[int], cval=float("nan"),
                tile_idx=None, starts=None, valid=None) -> torch.Tensor:
        a = _check_args(ndim, data, mats, offs, extents, out_shape, cval,
                        tile_idx, starts, valid)
        if a.data.device.type == "cpu":
            return _plain(ndim, a, terms)
        out, launched = _launch(entry, a)
        wrapper.launches += launched
        return out

    wrapper.launches = 0
    wrapper.__name__ = wrapper.__qualname__ = name
    plain.__name__ = plain.__qualname__ = name + "_plain"
    wrapper.__doc__ = doc
    plain.__doc__ = f"Plain PyTorch version of :func:`{name}`, on any device.\n\n" + doc
    return wrapper, plain


_COMMON_DOC = """

    ``data`` (B, *S) of any real dtype (the kernels read uint8, uint16 and
    float32; others are cast to float32 on the device first; float input may
    hold NaN or inf: it is read through ``nan_to_num``); ``mats`` (B, ndim, ndim),
    ``offs`` and ``extents`` (B, ndim); ``out_shape`` the output shape of
    every item; ``cval`` the value outside ``[0, extents - 1]``. With
    ``tile_idx`` (B,) and ``starts`` (B, ndim), ``data`` is a (V, *S) stack
    and item ``b`` samples ``data[tile_idx[b]]`` at ``starts[b] + coordinate``.
    Items whose ``valid`` (B,) is false are filled with ``cval``. Returns
    float32 (B, *out_shape) on the device of ``data``."""

exact_affine_batch_2d, exact_affine_batch_2d_plain = _make(
    "exact_affine_batch_2d", 2, _ENTRY_POINTS[0], _TERMS_FULL_2D,
    "Exact batched bilinear resample at any 2D affine." + _COMMON_DOC,
)
exact_affine_batch_3d_sepy, exact_affine_batch_3d_sepy_plain = _make(
    "exact_affine_batch_3d_sepy", 3, _ENTRY_POINTS[1], _TERMS_SEPY,
    "Exact batched trilinear resample for y-decoupled 3D maps (see "
    ":func:`is_y_decoupled`): any affine in (z, x), an independent y scale "
    "and offset. Only ``m00, m02, m11, m20, m22`` of each map are read."
    + _COMMON_DOC,
)
exact_affine_batch_3d_general, exact_affine_batch_3d_general_plain = _make(
    "exact_affine_batch_3d_general", 3, _ENTRY_POINTS[2], _TERMS_FULL_3D,
    "Exact batched trilinear resample at fully coupled 3D affines." + _COMMON_DOC,
)


def wrapper_for(ndim: int, y_decoupled: Optional[bool] = None):
    """The wrapper for ``ndim``; in 3D, the y-decoupled one when every map it
    will be given is (``y_decoupled``), else the general one."""
    if ndim == 2:
        return exact_affine_batch_2d
    return exact_affine_batch_3d_sepy if y_decoupled else exact_affine_batch_3d_general
