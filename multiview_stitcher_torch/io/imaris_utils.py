"""Imaris (.ims) HDF5 reading.

The port of ``multiview_stitcher_tpu.io.imaris_utils``: reads the Imaris
``DataSet/ResolutionLevel i/TimePoint t/Channel c/Data`` pyramid with
spacing/origin from ``DataSetInfo/Image`` extents into a lazy msim (data read
per-window through h5py on access).
"""

from __future__ import annotations

import h5py
import numpy as np

from multiview_stitcher_torch import msi_utils, si_utils
from multiview_stitcher_torch.msi_utils import Msim

_ZYX = ("z", "y", "x")


def _as_text(raw):
    """Imaris stores attributes as byte strings or char arrays."""
    if isinstance(raw, bytes):
        return raw.decode()
    if isinstance(raw, np.ndarray):
        return b"".join(
            c if isinstance(c, bytes) else str(c).encode() for c in raw
        ).decode()
    return str(raw)


def get_group_path(ires=0, itime=0, ichannel=0) -> str:
    return (
        f"DataSet/ResolutionLevel {ires}/TimePoint {itime}/Channel {ichannel}"
    )


def _image_info(filename):
    """World extents, voxel counts and level count in one file open.

    ``DataSetInfo/Image`` carries ExtMin0..2 / ExtMax0..2 (world bounds in
    x,y,z order) and X/Y/Z voxel counts of the full-resolution level.
    """
    with h5py.File(filename, "r") as f:
        a = f["DataSetInfo/Image"].attrs
        xyz_order = ("x", "y", "z")
        lo = {d: float(_as_text(a[f"ExtMin{i}"])) for i, d in enumerate(xyz_order)}
        hi = {d: float(_as_text(a[f"ExtMax{i}"])) for i, d in enumerate(xyz_order)}
        size = {d: int(float(_as_text(a[d.upper()]))) for d in xyz_order}
        n_levels = len(f["DataSet"].keys())
    return lo, hi, size, n_levels


def get_spacing_from_ims(filename):
    lo, hi, size, _ = _image_info(filename)
    return {d: (hi[d] - lo[d]) / size[d] for d in _ZYX}


def get_origin_from_ims(filename):
    lo, _, _, _ = _image_info(filename)
    return {d: lo[d] for d in _ZYX}


def get_shape_from_group(filename, group_path):
    with h5py.File(filename, "r") as f:
        a = f[group_path].attrs
        return {d: int(float(_as_text(a[f"ImageSize{d.upper()}"]))) for d in _ZYX}


class LazyHDF5Array:
    """Lazy window-read array over an HDF5 dataset."""

    def __init__(self, filename, dataset, shape=None, dtype=None):
        self.filename = str(filename)
        self.dataset = dataset
        if shape is None or dtype is None:
            with h5py.File(self.filename, "r") as f:
                ds = f[self.dataset]
                shape = ds.shape
                dtype = ds.dtype
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.ndim = len(self.shape)

    def __getitem__(self, idx):
        with h5py.File(self.filename, "r", locking=False) as f:
            return np.asarray(f[self.dataset][idx])

    def __array__(self, dtype=None):
        out = self[tuple(slice(None) for _ in self.shape)]
        return out.astype(dtype) if dtype is not None else out


class _SlicedLazy:
    """Lazy view applying a base slice to a lazy array, indexed as numpy
    indexes the cropped array (the JAX package's drops a slice's step and
    reads a negative index before the crop: F4, ROADMAP.md queue 3)."""

    def __init__(self, base, slices):
        self.base = base
        self.slices = slices
        self.shape = tuple(
            len(range(*sl.indices(s))) for sl, s in zip(slices, base.shape)
        )
        self.dtype = base.dtype
        self.ndim = len(self.shape)

    def _compose(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if Ellipsis in idx:
            i = idx.index(Ellipsis)
            idx = (
                idx[:i]
                + (slice(None),) * (self.ndim - (len(idx) - 1))
                + idx[i + 1:]
            )
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        out, flips = [], []
        for ax, (sl, i) in enumerate(zip(self.slices, idx)):
            start, n = sl.start or 0, self.shape[ax]
            if isinstance(i, slice):
                # the step is kept; a negative step is read forwards (h5py
                # takes no negative steps) and flipped after
                r = range(*i.indices(n))
                if r.step < 0:
                    r = r[::-1]
                    flips.append(len(out) - sum(isinstance(o, int) for o in out))
                out.append(slice(start + r[0], start + r[-1] + 1, r.step) if len(r)
                           else slice(start, start))
            else:
                ii = int(i) + (n if int(i) < 0 else 0)
                if not 0 <= ii < n:
                    raise IndexError(f"index {i} out of bounds for axis {ax} ({n})")
                out.append(start + ii)
        return tuple(out), flips

    def __getitem__(self, idx):
        sel, flips = self._compose(idx)
        out = self.base[sel]
        for ax in flips:
            out = np.flip(out, ax)
        return out

    def __array__(self, dtype=None):
        out = self.base[self.slices]
        return out.astype(dtype) if dtype is not None else np.asarray(out)


def _level_sims_for_channel(filename, itime, ichannel):
    """One lazy sim per resolution level of a (time, channel) field."""
    lo, hi, size0_xyz, n_levels = _image_info(filename)
    origin = {d: lo[d] for d in _ZYX}
    base_spacing = {d: (hi[d] - lo[d]) / size0_xyz[d] for d in _ZYX}
    base_shape = get_shape_from_group(
        filename, get_group_path(0, itime, ichannel)
    )

    level_sims = []
    for lvl in range(n_levels):
        gp = get_group_path(lvl, itime, ichannel)
        lvl_shape = get_shape_from_group(filename, gp)
        lvl_spacing = {
            d: base_spacing[d] * base_shape[d] / lvl_shape[d] for d in _ZYX
        }
        stored = LazyHDF5Array(filename, f"{gp}/Data")
        # Imaris pads stored datasets beyond the image size: crop lazily
        cropped = _SlicedLazy(
            stored, tuple(slice(0, lvl_shape[d]) for d in _ZYX)
        )
        level_sims.append(
            si_utils.get_sim_from_array(
                cropped, dims=list(_ZYX), scale=lvl_spacing,
                translation=origin,
            )
        )
    return level_sims


def read_imaris_into_msim(filename, itime: int = 0, channels=None) -> Msim:
    """Read an Imaris .ims file into a (lazy) msim."""
    with h5py.File(filename, "r") as f:
        available = len(f[f"DataSet/ResolutionLevel 0/TimePoint {itime}"].keys())
    channels = list(range(available) if channels is None else channels)
    if not channels:
        raise ValueError("channels must contain at least one channel.")

    per_channel = [
        msi_utils.get_msim_from_sims(
            _level_sims_for_channel(filename, itime, ich)
        )
        for ich in channels
    ]
    if len(per_channel) == 1:
        return per_channel[0]
    # concat channels at each scale (materializes data)
    return Msim(
        sims=[
            si_utils.stack(
                [m.sims[lvl] for m in per_channel], "c",
                coords=[str(c) for c in channels],
            )
            for lvl in range(len(per_channel[0].sims))
        ]
    )