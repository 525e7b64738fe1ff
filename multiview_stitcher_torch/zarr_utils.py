"""Virtual array views: lazy expand_dims, concatenate, stack and map over any
array handle, without copying.

The port's copy of ``multiview_stitcher_tpu.zarr_utils``. Sims backed by the
port's zarr arrays (``io.zarr_backend.LazyZarrArray``) combine along ``t`` or
``c`` through these views and stay lazy: a view forwards each
``__getitem__`` window to the sources it overlaps and reads only that.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class NotChunkAlignedError(ValueError):
    """Raised when arrays cannot be combined: their extents off the combine
    axis differ."""


def _norm_idx(idx, ndim):
    if not isinstance(idx, tuple):
        idx = (idx,)
    if Ellipsis in idx:
        i = idx.index(Ellipsis)
        idx = idx[:i] + (slice(None),) * (ndim - (len(idx) - 1)) + idx[i + 1:]
    return idx + (slice(None),) * (ndim - len(idx))


class VirtualExpandDims:
    """Lazy view of ``base`` with a new axis of length 1 at ``axis``."""

    def __init__(self, base, axis: int = 0):
        self.base = base
        self.axis = axis
        self.shape = tuple(base.shape[:axis]) + (1,) + tuple(base.shape[axis:])
        self.dtype = np.dtype(base.dtype)
        self.ndim = len(self.shape)

    def __getitem__(self, idx):
        idx = _norm_idx(idx, self.ndim)
        ax_idx = idx[self.axis]
        rest = idx[: self.axis] + idx[self.axis + 1:]
        out = np.asarray(self.base[rest])
        if isinstance(ax_idx, slice):
            return np.expand_dims(out, self.axis)
        return out

    def __array__(self, dtype=None, copy=None):
        out = np.expand_dims(np.asarray(self.base), self.axis)
        return out.astype(dtype) if dtype is not None else out


class VirtualConcat:
    """Lazy concatenation of arrays (numpy or lazy handles with ``shape``,
    ``dtype`` and ``__getitem__``) along ``axis``: a read goes to the
    sources it overlaps only."""

    def __init__(self, sources: Sequence, axis: int = 0):
        assert len(sources) > 0
        self.sources = list(sources)
        self.axis = axis
        shapes = [tuple(s.shape) for s in self.sources]
        for s in shapes[1:]:
            if s[:axis] != shapes[0][:axis] or s[axis + 1:] != shapes[0][axis + 1:]:
                raise NotChunkAlignedError("Source shapes incompatible for concat.")
        self._offsets = np.cumsum([0] + [s[axis] for s in shapes])
        self.shape = shapes[0][:axis] + (int(self._offsets[-1]),) + shapes[0][axis + 1:]
        self.dtype = np.dtype(self.sources[0].dtype)
        self.ndim = len(self.shape)

    def __getitem__(self, idx):
        idx = _norm_idx(idx, self.ndim)
        ax_idx = idx[self.axis]
        scalar = isinstance(ax_idx, (int, np.integer))
        if scalar:
            ax_idx = slice(int(ax_idx), int(ax_idx) + 1)
        start, stop, step = ax_idx.indices(self.shape[self.axis])
        if step != 1:
            raise NotImplementedError("step != 1 along concat axis")
        parts = []
        for i, src in enumerate(self.sources):
            lo = max(start, self._offsets[i])
            hi = min(stop, self._offsets[i + 1])
            if lo >= hi:
                continue
            local = slice(lo - self._offsets[i], hi - self._offsets[i])
            parts.append(np.asarray(src[idx[: self.axis] + (local,) + idx[self.axis + 1:]]))
        out_axis = self._out_axis(idx)
        out = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=out_axis)
        if scalar:
            out = np.take(out, 0, axis=out_axis)
        return out

    def _out_axis(self, idx):
        # the concat axis's place in the output, after the integer indexes
        # of the axes before it dropped theirs
        return self.axis - sum(
            1 for i in range(self.axis) if isinstance(idx[i], (int, np.integer))
        )

    def __array__(self, dtype=None, copy=None):
        out = self[tuple(slice(None) for _ in range(self.ndim))]
        return out.astype(dtype) if dtype is not None else out


def expand_dims(array, axis: int = 0):
    return VirtualExpandDims(array, axis=axis)


def concatenate(arrays: Sequence, axis: int = 0):
    return VirtualConcat(arrays, axis=axis)


def stack(arrays: Sequence, axis: int = 0):
    """Lazy stack along a new axis."""
    return VirtualConcat([VirtualExpandDims(a, axis=axis) for a in arrays], axis=axis)


class VirtualMap:
    """Lazy shape-preserving map of ``func`` over any array handle: applied
    to each window as it is read. ``dtype`` is the output dtype (by default
    probed on an empty block)."""

    def __init__(self, base, func, *args, dtype=None, **kwargs):
        self.base = base
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.shape = tuple(base.shape)
        self.ndim = len(self.shape)
        if dtype is None:
            probe = np.zeros((0,) * self.ndim, dtype=base.dtype)
            dtype = np.asarray(func(probe, *args, **kwargs)).dtype
        self.dtype = np.dtype(dtype)

    def __getitem__(self, idx):
        block = np.asarray(self.base[idx])
        return np.asarray(self.func(block, *self.args, **self.kwargs))

    def __array__(self, dtype=None, copy=None):
        out = self[tuple(slice(None) for _ in range(self.ndim))]
        return out.astype(dtype) if dtype is not None else np.asarray(out)


def map_blocks(array, func, *args, dtype=None, **kwargs):
    return VirtualMap(array, func, *args, dtype=dtype, **kwargs)


def is_stackable(arrays) -> bool:
    """True when :func:`stack` would succeed: equal shapes and dtypes."""
    arrays = list(arrays)
    if not arrays:
        return False
    first = arrays[0]
    return all(
        tuple(a.shape) == tuple(first.shape) and np.dtype(a.dtype) == np.dtype(first.dtype)
        for a in arrays[1:]
    )


def is_chunk_aligned_concatenate(arrays, axis: int) -> bool:
    """True when :func:`concatenate` along ``axis`` would succeed: equal
    extents off ``axis``. The views read through index mapping, so no
    alignment of chunk grids is needed."""
    arrays = list(arrays)
    if not arrays:
        return False
    shapes = [tuple(a.shape) for a in arrays]
    axis = int(axis)
    return all(
        s[:axis] == shapes[0][:axis] and s[axis + 1:] == shapes[0][axis + 1:]
        for s in shapes[1:]
    )
