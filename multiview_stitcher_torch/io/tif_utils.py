"""Minimal TIFF reading and writing (no tifffile dependency).

The port of ``multiview_stitcher_tpu.io.tif_utils``, on numpy and the
standard library: a self-contained TIFF codec for grayscale multi-page files
with 8/16/32-bit integer and 32/64-bit float samples; compression
none/LZW/Deflate/PackBits (+ TIFF predictor 2) through the native codec
layer in :mod:`.codecs`; plane-chunked lazy reads, ImageJ hyperstacks, a
read-only virtual zarr-v3 store of the pages and ``save_sim_as_tif``. Pages
are parsed up-front, pixel data is read on demand per page.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from multiview_stitcher_torch import msi_utils, si_utils
from multiview_stitcher_torch.io import codecs
from multiview_stitcher_torch.si_utils import Sim

# TIFF tag ids
_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_BYTE_COUNTS = 279
_TAG_PREDICTOR = 317
_TAG_SAMPLE_FORMAT = 339

_COMPRESSION_NAMES = {
    "none": codecs.TIFF_COMPRESSION_NONE,
    "lzw": codecs.TIFF_COMPRESSION_LZW,
    "deflate": codecs.TIFF_COMPRESSION_DEFLATE,
    "zlib": codecs.TIFF_COMPRESSION_DEFLATE,
    "packbits": codecs.TIFF_COMPRESSION_PACKBITS,
}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 11: 4, 12: 8}
_TYPE_FMT = {3: "H", 4: "I"}


def _dtype_for(bits: int, sample_format: int) -> np.dtype:
    if sample_format == 3:
        return np.dtype({32: "<f4", 64: "<f8"}[bits])
    if sample_format == 2:
        return np.dtype(f"<i{bits // 8}")
    return np.dtype(f"<u{bits // 8}")


class TiffPage:
    def __init__(self, shape, dtype, strip_offsets, strip_byte_counts,
                 rows_per_strip, compression=1, predictor=1):
        self.shape = shape
        self.dtype = dtype
        self.strip_offsets = strip_offsets
        self.strip_byte_counts = strip_byte_counts
        self.rows_per_strip = rows_per_strip
        self.compression = compression
        self.predictor = predictor


class TiffFile:
    """Parse a baseline TIFF; read pages lazily.

    Page reads go through a per-thread cached file handle so that repeated
    page reads (one per virtual-zarr chunk request, potentially from a
    thread pool) don't pay an open() each. ``close()`` releases every
    handle opened across threads.
    """

    def __init__(self, path):
        self.path = str(path)
        self.pages: List[TiffPage] = []
        self.description: str = ""
        self._local = threading.local()
        self._handles: List[object] = []
        self._handles_lock = threading.Lock()
        with open(self.path, "rb") as f:
            header = f.read(8)
            if header[:2] == b"II":
                self._e = "<"
            elif header[:2] == b"MM":
                self._e = ">"
            else:
                raise ValueError(f"Not a TIFF file: {path}")
            magic, offset = struct.unpack(self._e + "HI", header[2:8])
            if magic != 42:
                raise ValueError("Only classic (non-Big) TIFF supported.")
            while offset:
                offset = self._parse_ifd(f, offset)

    def _read_tag_values(self, f, ttype, count, value_bytes):
        size = _TYPE_SIZES.get(ttype, 1) * count
        if size <= 4:
            data = value_bytes[:size]
        else:
            (ptr,) = struct.unpack(self._e + "I", value_bytes)
            pos = f.tell()
            f.seek(ptr)
            data = f.read(size)
            f.seek(pos)
        if ttype == 3:
            return list(struct.unpack(self._e + "H" * count, data))
        if ttype == 4:
            return list(struct.unpack(self._e + "I" * count, data))
        if ttype == 1:
            return list(data)
        return [data]

    def _parse_ifd(self, f, offset):
        f.seek(offset)
        (n_entries,) = struct.unpack(self._e + "H", f.read(2))
        tags = {}
        for _ in range(n_entries):
            entry = f.read(12)
            tag, ttype, count = struct.unpack(self._e + "HHI", entry[:8])
            tags[tag] = self._read_tag_values(f, ttype, count, entry[8:12])
        (next_offset,) = struct.unpack(self._e + "I", f.read(4))

        width = tags[_TAG_WIDTH][0]
        length = tags[_TAG_LENGTH][0]
        bits = tags.get(_TAG_BITS, [8])[0]
        compression = tags.get(_TAG_COMPRESSION, [1])[0]
        spp = tags.get(_TAG_SAMPLES_PER_PIXEL, [1])[0]
        if spp != 1:
            raise NotImplementedError("Only single-sample TIFFs supported.")
        sample_format = tags.get(_TAG_SAMPLE_FORMAT, [1])[0]
        if _TAG_DESCRIPTION in tags and not self.description:
            raw_desc = tags[_TAG_DESCRIPTION][0]
            if isinstance(raw_desc, (bytes, bytearray)):
                self.description = (
                    bytes(raw_desc).split(b"\0", 1)[0].decode("latin-1")
                )
        self.pages.append(
            TiffPage(
                shape=(length, width),
                dtype=_dtype_for(bits, sample_format),
                strip_offsets=tags[_TAG_STRIP_OFFSETS],
                strip_byte_counts=tags[_TAG_STRIP_BYTE_COUNTS],
                rows_per_strip=tags.get(_TAG_ROWS_PER_STRIP, [length])[0],
                compression=compression,
                predictor=tags.get(_TAG_PREDICTOR, [1])[0],
            )
        )
        return next_offset

    def _handle(self):
        f = getattr(self._local, "f", None)
        if f is None or f.closed:
            f = open(self.path, "rb")
            self._local.f = f
            with self._handles_lock:
                self._handles.append(f)
        return f

    def close(self):
        """Close every cached per-thread handle (threading.local only
        exposes the calling thread's slot, so handles are tracked in a
        shared list)."""
        with self._handles_lock:
            for f in self._handles:
                try:
                    f.close()
                except OSError:
                    pass
            self._handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_page(self, index: int) -> np.ndarray:
        page = self.pages[index]
        length, width = page.shape
        itemsize = page.dtype.itemsize
        rps = max(1, int(page.rows_per_strip))
        f = self._handle()
        chunks = []
        for si, (off, cnt) in enumerate(
            zip(page.strip_offsets, page.strip_byte_counts)
        ):
            f.seek(off)
            raw = f.read(cnt)
            rows = min(rps, length - si * rps)
            chunks.append(
                codecs.decode_tiff_data(
                    raw, page.compression, rows * width * itemsize
                )
            )
        data = b"".join(chunks)
        arr = np.frombuffer(data, dtype=page.dtype).reshape(page.shape)
        if self._e == ">":
            arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
        if page.predictor == 2:
            arr = codecs.undo_predictor2(arr)
        elif page.predictor != 1:
            raise NotImplementedError(
                f"TIFF predictor {page.predictor} not supported."
            )
        return arr

    def asarray(self) -> np.ndarray:
        return np.stack([self.read_page(i) for i in range(len(self.pages))])


class LazyTiffPages:
    """Lazy (n_pages, H, W) array over a multi-page TIFF.

    The plane-chunk analogue of :class:`TiffPagesZarrV3Store`: whole planes
    are the chunk unit.
    """

    def __init__(self, path):
        self._tif = TiffFile(path)
        p0 = self._tif.pages[0]
        self.shape = (len(self._tif.pages),) + p0.shape
        self.dtype = p0.dtype
        self.ndim = 3

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if Ellipsis in idx:
            i = idx.index(Ellipsis)
            idx = (
                idx[:i]
                + (slice(None),) * (3 - (len(idx) - 1))
                + idx[i + 1:]
            )
        idx = idx + (slice(None),) * (3 - len(idx))
        page_idx, rest = idx[0], idx[1:]
        if isinstance(page_idx, (int, np.integer)):
            return self._tif.read_page(int(page_idx))[rest]
        pages = range(*page_idx.indices(self.shape[0]))
        return np.stack([self._tif.read_page(i)[rest] for i in pages])

    def __array__(self, dtype=None):
        out = self._tif.asarray()
        return out.astype(dtype) if dtype is not None else out


def _parse_imagej_description(description: str) -> dict:
    """key=value lines of an ImageJ ImageDescription tag -> dict (ints where
    possible). Returns {} for non-ImageJ descriptions."""
    if not description.startswith("ImageJ"):
        return {}
    meta = {}
    for line in description.splitlines():
        if "=" not in line:
            continue
        k, v = line.split("=", 1)
        try:
            meta[k.strip()] = int(v)
        except ValueError:
            meta[k.strip()] = v.strip()
    return meta


def get_tiff_layout(tif: TiffFile) -> Tuple[tuple, tuple, np.dtype, int]:
    """Split a TIFF's page sequence into (non_spatial_shape, page_shape,
    dtype, n_pages).

    Pages are stored in row-major order over the non-spatial axes; for
    ImageJ hyperstacks that order is t-slowest / c-fastest (XYCZT storage),
    so the non-spatial shape is (frames, slices, channels) with singleton
    axes dropped, as tifffile splits a series, with the series shape taken
    from the ImageJ ImageDescription.
    """
    n_pages = len(tif.pages)
    if n_pages == 0:
        raise ValueError("TIFF contains no pages")
    page_shape = tuple(tif.pages[0].shape)
    dtype = np.dtype(tif.pages[0].dtype)
    for page in tif.pages:
        if tuple(page.shape) != page_shape:
            raise ValueError("All TIFF pages must have the same shape")
        if np.dtype(page.dtype) != dtype:
            raise ValueError("All TIFF pages must have the same dtype")

    meta = _parse_imagej_description(tif.description)
    if meta:
        sizes = [
            meta.get("frames", 1),
            meta.get("slices", 1),
            meta.get("channels", 1),
        ]
        declared = meta.get("images", int(np.prod(sizes)))
        if int(np.prod(sizes)) != n_pages or declared != n_pages:
            raise ValueError(
                "TIFF series shape is inconsistent with the number of pages"
            )
        non_spatial_shape = tuple(s for s in sizes if s > 1)
    else:
        non_spatial_shape = () if n_pages == 1 else (n_pages,)
    return non_spatial_shape, page_shape, dtype, n_pages


def get_tiff_axes(tif: TiffFile) -> tuple:
    """Dim labels for :func:`get_tiff_layout`'s non-spatial axes: ImageJ
    hyperstacks label (t, z, c) for (frames, slices, channels); a plain
    multi-page stack labels its page axis "z"."""
    meta = _parse_imagej_description(tif.description)
    if meta:
        sizes = {
            "t": meta.get("frames", 1),
            "z": meta.get("slices", 1),
            "c": meta.get("channels", 1),
        }
        return tuple(d for d in ("t", "z", "c") if sizes[d] > 1)
    return () if len(tif.pages) == 1 else ("z",)


class LazyTiffPagesND:
    """Lazy ``non_spatial_shape + page_shape`` array over a multi-page TIFF.

    The N-d generalization of :class:`LazyTiffPages`: non-spatial axes
    (e.g. t/z/c of an ImageJ hyperstack) index into the flat page sequence
    row-major, whole pages are the read unit. Supports basic indexing
    (ints drop axes, slices keep them), which is what lazy sims and the
    streaming fusion slab reads use.
    """

    def __init__(self, path_or_tif):
        self._tif = (
            path_or_tif
            if isinstance(path_or_tif, TiffFile)
            else TiffFile(path_or_tif)
        )
        non_spatial, page_shape, dtype, _ = get_tiff_layout(self._tif)
        self._non_spatial = non_spatial
        self._page_shape = page_shape
        self.shape = non_spatial + page_shape
        self.dtype = dtype
        self.ndim = len(self.shape)
        # row-major strides over the flat page index
        self._strides = tuple(
            int(np.prod(non_spatial[i + 1:], initial=1))
            for i in range(len(non_spatial))
        )

    def close(self):
        self._tif.close()

    def __getitem__(self, idx):
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
        if len(idx) != self.ndim:
            raise IndexError(f"too many indices for {self.ndim}-d array")
        n_ns = len(self._non_spatial)
        ns_idx, page_idx = idx[:n_ns], idx[n_ns:]

        # each non-spatial axis -> (selected flat indices, keep axis?)
        selections, keep = [], []
        for ax, ix in enumerate(ns_idx):
            size = self._non_spatial[ax]
            if isinstance(ix, (int, np.integer)):
                ii = int(ix) + (size if ix < 0 else 0)
                if not 0 <= ii < size:
                    raise IndexError(
                        f"index {ix} out of bounds for axis {ax} ({size})"
                    )
                selections.append([ii])
                keep.append(False)
            elif isinstance(ix, slice):
                selections.append(list(range(*ix.indices(size))))
                keep.append(True)
            else:
                raise TypeError(
                    "LazyTiffPagesND supports int/slice indexing only"
                )

        out_ns_shape = tuple(
            len(sel) for sel, k in zip(selections, keep) if k
        )
        pages = []
        for combo in np.ndindex(*[len(s) for s in selections]):
            flat = sum(
                selections[ax][ci] * self._strides[ax]
                for ax, ci in enumerate(combo)
            )
            pages.append(self._tif.read_page(int(flat))[page_idx])
        if not pages:
            page_out_shape = np.empty(
                self._page_shape, dtype=np.bool_
            )[page_idx].shape
            return np.empty(out_ns_shape + page_out_shape, dtype=self.dtype)
        stacked = np.stack(pages) if len(pages) > 1 else pages[0][None]
        return stacked.reshape(out_ns_shape + pages[0].shape)

    def __array__(self, dtype=None):
        out = self[(slice(None),) * self.ndim]
        return out.astype(dtype) if dtype is not None else out


class TiffPagesZarrV3Store:
    """Read-only virtual zarr-v3 array over a multi-page TIFF, whole pages
    as chunks.

    Speaks the ``get(key) -> bytes | None`` protocol of the virtual
    OME-Zarr stores of ``io.virtual_ngff``, whose server serves it: no
    store is written; chunk requests decode single pages on
    demand through per-thread cached handles. Non-spatial axes chunk at 1; edge padding never occurs since
    pages are exactly one chunk.
    """

    def __init__(self, path):
        self.path = str(path)
        self._tif = TiffFile(path)
        non_spatial, page_shape, dtype, _ = get_tiff_layout(self._tif)
        self._lazy = LazyTiffPagesND(self._tif)
        self.shape = non_spatial + page_shape
        self.chunks = (1,) * len(non_spatial) + page_shape
        self.dtype = dtype
        self.ndim = len(self.shape)
        self._strides = self._lazy._strides
        self.metadata = {
            "zarr_format": 3,
            "node_type": "array",
            "shape": list(self.shape),
            "data_type": dtype.name,
            "chunk_grid": {
                "name": "regular",
                "configuration": {"chunk_shape": list(self.chunks)},
            },
            "chunk_key_encoding": {
                "name": "default",
                "configuration": {"separator": "/"},
            },
            "codecs": [
                {"name": "bytes", "configuration": {"endian": "little"}}
            ],
            "fill_value": 0,
            "attributes": {},
        }

    def close(self):
        self._tif.close()

    def get(self, key: str) -> Optional[bytes]:
        key = key.strip("/")
        if key == "zarr.json":
            return json.dumps(self.metadata).encode()
        if not key.startswith("c/") and key != "c":
            return None
        parts = key.split("/")[1:]
        if len(parts) != self.ndim:
            return None
        try:
            chunk_idx = [int(p) for p in parts]
        except ValueError:
            return None
        n_ns = len(self._strides)
        ns, page = chunk_idx[:n_ns], chunk_idx[n_ns:]
        if any(p != 0 for p in page):
            return None
        if any(
            not 0 <= i < s for i, s in zip(ns, self.shape[:n_ns])
        ):
            return None
        flat = sum(i * st for i, st in zip(ns, self._strides))
        arr = self._tif.read_page(int(flat))
        return np.ascontiguousarray(
            arr, dtype=self.dtype.newbyteorder("<")
        ).tobytes()


def tif_to_virtual_zarr_v3_plane_chunks(path) -> TiffPagesZarrV3Store:
    """Expose a TIFF as a virtual zarr-v3 array with per-page chunks
    (read chunks through :meth:`TiffPagesZarrV3Store.get`)."""
    return TiffPagesZarrV3Store(path)


def tif_to_dask_plane_chunks(path) -> LazyTiffPagesND:
    """Lazy plane-chunked array over a TIFF: the lazy N-d view that stands
    for a dask array here (same chunking, on-demand page reads,
    numpy-compatible basic indexing)."""
    return LazyTiffPagesND(path)


def write_tiff(
    path,
    data: np.ndarray,
    compression: str = "none",
    description: Optional[str] = None,
):
    """Write a (pages, H, W) or (H, W) array as a TIFF.

    ``compression``: "none" (default), "lzw", "deflate"/"zlib", "packbits".
    ``description`` is written as the first page's ImageDescription tag —
    pass an ImageJ-style "ImageJ=...\\nimages=N\\nchannels=..." block to
    declare hyperstack (t/z/c) axes over the flat page sequence.
    """
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError("write_tiff expects (pages, H, W) or (H, W) data.")
    dtype = data.dtype
    if dtype.kind == "f":
        sample_format = 3
    elif dtype.kind == "i":
        sample_format = 2
    elif dtype.kind == "u":
        sample_format = 1
    else:
        raise ValueError(f"Unsupported dtype {dtype}")
    bits = dtype.itemsize * 8
    comp_id = _COMPRESSION_NAMES.get(str(compression).lower())
    if comp_id is None:
        raise ValueError(f"Unknown compression {compression!r}")

    n_pages, length, width = data.shape
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8))
        ifd_offset = 8
        for ip in range(n_pages):
            plane = np.ascontiguousarray(data[ip]).astype(
                dtype.newbyteorder("<")
            )
            raw = codecs.encode_tiff_data(plane.tobytes(), comp_id)
            desc = (
                description.encode("latin-1") + b"\0"
                if description is not None and ip == 0
                else b""
            )
            if len(desc) % 2:
                desc += b"\0"
            n_entries = 10 + (1 if desc else 0)
            data_offset = ifd_offset + 2 + n_entries * 12 + 4
            desc_offset = data_offset + len(raw)

            def entry(tag, ttype, count, value):
                return struct.pack("<HHII", tag, ttype, count, value)

            entries = [
                entry(_TAG_WIDTH, 4, 1, width),
                entry(_TAG_LENGTH, 4, 1, length),
                entry(_TAG_BITS, 3, 1, bits),
                entry(_TAG_COMPRESSION, 3, 1, comp_id),
                entry(_TAG_PHOTOMETRIC, 3, 1, 1),
                entry(_TAG_STRIP_OFFSETS, 4, 1, data_offset),
                entry(_TAG_SAMPLES_PER_PIXEL, 3, 1, 1),
                entry(_TAG_ROWS_PER_STRIP, 4, 1, length),
                entry(_TAG_STRIP_BYTE_COUNTS, 4, 1, len(raw)),
                entry(_TAG_SAMPLE_FORMAT, 3, 1, sample_format),
            ]
            if desc:
                # IFD entries must stay sorted by tag id: 270 goes after
                # PHOTOMETRIC (262) and before STRIP_OFFSETS (273)
                entries.insert(
                    5, entry(_TAG_DESCRIPTION, 2, len(desc), desc_offset)
                )
            next_ifd = (
                desc_offset + len(desc) if ip < n_pages - 1 else 0
            )
            f.seek(ifd_offset)
            f.write(struct.pack("<H", n_entries))
            f.write(b"".join(entries))
            f.write(struct.pack("<I", next_ifd))
            f.write(raw)
            f.write(desc)
            ifd_offset = next_ifd


def read_tiff_into_sim(
    path,
    dims=None,
    scale=None,
    translation=None,
    transform_key: str = si_utils.DEFAULT_TRANSFORM_KEY,
    lazy: bool = True,
) -> Sim:
    """Read a (multi-page) TIFF into a sim.

    Plain multi-page stacks map the page axis to z (z/y/x); ImageJ
    hyperstacks (ImageDescription frames/slices/channels) expose their
    declared non-spatial axes in page order (t/z/c, c fastest)."""
    nd = LazyTiffPagesND(path)
    axes = get_tiff_axes(nd._tif)
    if nd.ndim == 2:
        data = np.asarray(nd)  # single plane: nothing to defer
        dims = dims or ("y", "x")
    else:
        data = nd if lazy else np.asarray(nd)
        dims = dims or axes + ("y", "x")
    return si_utils.get_sim_from_array(
        data, dims=dims, scale=scale, translation=translation,
        transform_key=transform_key,
    )


def read_tif_into_msim(path, **kwargs):
    sim = read_tiff_into_sim(path, **kwargs)
    return msi_utils.get_msim_from_sim(sim, scale_factors=[])


def save_sim_as_tif(path, sim: Sim):
    """Write a sim's (z-)stack to an uncompressed TIFF."""
    data = sim.to_numpy()
    # flatten leading non-spatial dims into pages
    sdims = sim.spatial_dims
    if len(sdims) == 2 and data.ndim > 2:
        data = data.reshape((-1,) + data.shape[-2:])
    elif len(sdims) == 3 and data.ndim > 3:
        data = data.reshape((-1,) + data.shape[-2:])
    write_tiff(path, data)
