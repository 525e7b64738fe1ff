"""Zarr v2 arrays on numpy, ``json``, ``os`` and the standard library's ``zlib``.

The port's counterpart of ``multiview_stitcher_tpu.io.zarr_backend``, which
reads and writes through tensorstore, under the same function names. The
card's machine has neither tensorstore nor zarr-python, so the format is
written out here:

- zarr v2 only: a ``.zarray`` JSON document beside one file per chunk, chunks
  in C (or, read only, F) order, the ``"."`` and ``"/"`` dimension separators,
  ``fill_value`` for chunks that do not exist, edge chunks stored at full
  size. Zarr v3 raises ``NotImplementedError`` (ROADMAP.md, queue 1, item 21).
- compressors: ``null`` and ``{"id": "zlib", "level": n}`` are read and
  written; blosc (tensorstore's default for an array created without a
  compressor) only where ``numcodecs`` or the ``blosc`` module imports; any
  other compressor, and any filter, raises ``NotImplementedError`` naming it.
  The port writes ``compressor: null`` unless asked otherwise.
- a region write that covers a chunk's whole extent writes the chunk without
  reading it; any other reads, modifies and writes it. Chunk files are
  replaced atomically, so readers never see half a chunk; two writers of one
  chunk must not overlap in time (the streaming tier aligns its bands to
  whole output chunks for that reason).

Each array's ``.zarray`` is parsed once, when it is opened; a
:class:`LazyZarrArray` and every view sliced from it share that parse.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import uuid
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

_V3 = "zarr v3 and NGFF 0.5 are not ported yet (ROADMAP.md, queue 1: item 21)"


def _local_path(url) -> str:
    url = str(url)
    if url.startswith("file://"):
        return url[len("file://"):]
    if "://" in url:
        raise NotImplementedError(
            f"only zarr stores on a local file system are ported, got {url!r}"
        )
    return url


class _Zlib:
    def __init__(self, level: int = 1):
        self.level = int(level)

    def encode(self, chunk: np.ndarray) -> bytes:
        return zlib.compress(chunk.tobytes(), self.level)

    def decode(self, raw: bytes) -> bytes:
        return zlib.decompress(raw)


class _BloscModule:
    """blosc through the ``blosc`` module (python-blosc)."""

    def __init__(self, blosc, config: dict):
        self.blosc, self.config = blosc, config

    def encode(self, chunk: np.ndarray) -> bytes:
        c = self.config
        shuffle = int(c.get("shuffle", 1))
        if shuffle == -1:  # numcodecs' AUTOSHUFFLE
            shuffle = 2 if chunk.dtype.itemsize == 1 else 1
        return self.blosc.compress(
            chunk.tobytes(), typesize=chunk.dtype.itemsize, clevel=int(c.get("clevel", 5)),
            shuffle=shuffle, cname=c.get("cname", "lz4"),
        )

    def decode(self, raw: bytes) -> bytes:
        return self.blosc.decompress(raw)


def _blosc_codec(config: dict):
    """blosc through ``numcodecs`` or the ``blosc`` module, whichever imports;
    neither is needed anywhere else in the port."""
    try:
        import numcodecs
    except ImportError:
        numcodecs = None
    if numcodecs is not None:
        codec = numcodecs.get_codec(dict(config))

        class _Numcodecs:
            def encode(self, chunk):
                return bytes(codec.encode(np.ascontiguousarray(chunk)))

            def decode(self, raw):
                return codec.decode(raw)

        return _Numcodecs()
    try:
        import blosc
    except ImportError:
        raise NotImplementedError(
            f"zarr compressor 'blosc' ({config}) needs numcodecs or the blosc "
            "module, and neither imports here; write the array with "
            "compressor None or zlib"
        ) from None
    return _BloscModule(blosc, config)


def _codec(config: Optional[dict]):
    """The chunk codec of a ``.zarray`` compressor entry (None: raw bytes)."""
    if config is None:
        return None
    cid = config.get("id")
    if cid == "zlib":
        return _Zlib(config.get("level", 1))
    if cid == "blosc":
        return _blosc_codec(config)
    raise NotImplementedError(
        f"zarr compressor {cid!r} ({config}) is not supported: the port reads "
        "and writes null and zlib, and blosc where numcodecs or blosc imports"
    )


_FILL_NAMES = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


def _decode_fill(value, dtype: np.dtype):
    if value is None:
        return dtype.type(0)
    return dtype.type(_FILL_NAMES.get(value, value))


def _encode_fill(value, dtype: np.dtype):
    if value is None:
        return None
    if dtype.kind == "f":
        v = float(value)
        if np.isnan(v):
            return "NaN"
        if np.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    if dtype.kind == "b":
        return bool(value)
    return int(value)


def _write_atomically(path: str, data: bytes) -> None:
    tmp = f"{path}.{uuid.uuid4().hex}.partial"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class ZarrV2:
    """One zarr v2 array on disk: its parsed ``.zarray`` and chunk IO over
    boxes of ``(start, stop)`` per dim."""

    def __init__(self, path: str, meta: dict):
        if meta.get("filters"):
            raise NotImplementedError(f"zarr filters {meta['filters']} are not supported")
        self.path = path
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        self.fill = _decode_fill(meta.get("fill_value"), self.dtype)
        self.codec = _codec(meta.get("compressor"))
        self.sep = meta.get("dimension_separator", ".")

    def _chunk_path(self, idx) -> str:
        key = self.sep.join(str(i) for i in idx) if idx else "0"
        return os.path.join(self.path, key)

    def _read_chunk(self, idx) -> Optional[np.ndarray]:
        try:
            with open(self._chunk_path(idx), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        if self.codec is not None:
            raw = self.codec.decode(raw)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks, order=self.order)

    def _write_chunk(self, idx, chunk: np.ndarray) -> None:
        if self.order != "C":
            raise NotImplementedError("writing F-order zarr chunks is not supported")
        chunk = np.ascontiguousarray(chunk)
        path = self._chunk_path(idx)
        if self.sep == "/":
            os.makedirs(os.path.dirname(path), exist_ok=True)
        data = self.codec.encode(chunk) if self.codec is not None else chunk.tobytes()
        _write_atomically(path, data)

    def _chunk_ranges(self, box):
        return [
            range(b0 // c, -(-b1 // c)) if b1 > b0 else range(0)
            for (b0, b1), c in zip(box, self.chunks)
        ]

    def _overlap(self, idx, box):
        """(chunk-local, box-local) slices of a chunk's part of ``box``, and
        whether that part is the chunk's whole extent inside the array."""
        in_chunk, in_box, whole = [], [], True
        for i, (b0, b1), c, n in zip(idx, box, self.chunks, self.shape):
            c0, c1 = i * c, min((i + 1) * c, n)
            lo, hi = max(c0, b0), min(c1, b1)
            in_chunk.append(slice(lo - c0, hi - c0))
            in_box.append(slice(lo - b0, hi - b0))
            whole &= lo == c0 and hi == c1
        return tuple(in_chunk), tuple(in_box), whole

    def read(self, box) -> np.ndarray:
        out = np.empty(tuple(b1 - b0 for b0, b1 in box), dtype=self.dtype)
        for idx in itertools.product(*self._chunk_ranges(box)):
            in_chunk, in_box, _ = self._overlap(idx, box)
            chunk = self._read_chunk(idx)
            out[in_box] = self.fill if chunk is None else chunk[in_chunk]
        return out

    def write(self, box, value: np.ndarray) -> None:
        for idx in itertools.product(*self._chunk_ranges(box)):
            in_chunk, in_box, whole = self._overlap(idx, box)
            chunk = None if whole else self._read_chunk(idx)
            if chunk is None:
                chunk = np.full(self.chunks, self.fill, dtype=self.dtype)
            else:
                chunk = chunk.copy()
            chunk[in_chunk] = value[in_box]
            self._write_chunk(idx, chunk)


class _Fancy(Exception):
    """An index a lazy view does not compose (arrays, negative steps)."""


class LazyZarrArray:
    """Lazy view over a zarr v2 array: the counterpart of the reference's
    ``LazyTSArray``.

    ``shape``, ``dtype``, ``__getitem__`` (integers, slices with a positive
    step and ``...`` give another lazy view; nothing is read until
    ``read`` / ``np.asarray``; other indexes read the view and index the
    result), ``__setitem__`` (a region write with unit steps)."""

    def __init__(self, array: ZarrV2, sel=None):
        self._array = array
        # per dim of the array: an int (the dim is dropped) or (start, stop, step)
        self._sel = tuple((0, n, 1) for n in array.shape) if sel is None else tuple(sel)

    @property
    def shape(self) -> tuple:
        return tuple(len(range(*s)) for s in self._sel if not isinstance(s, int))

    @property
    def dtype(self) -> np.dtype:
        return self._array.dtype

    @property
    def chunks(self) -> tuple:
        return self._array.chunks

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return f"LazyZarrArray({self._array.path!r}, shape={self.shape}, dtype={self.dtype})"

    def spec(self) -> dict:
        """A JSON-able description from which :meth:`from_spec` reopens the
        view: the array's path and the view's selection per dim of the
        array (an index, or start, stop and step)."""
        return {
            "path": self._array.path,
            "sel": [s if isinstance(s, int) else list(s) for s in self._sel],
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "LazyZarrArray":
        array = open_zarr_array(spec["path"])._array
        sel = [s if isinstance(s, int) else tuple(s) for s in spec["sel"]]
        if len(sel) != len(array.shape):
            raise ValueError(f"selection {spec['sel']} does not match {array.path}'s {array.shape}")
        return cls(array, sel)

    def _compose(self, idx) -> tuple:
        idx = idx if isinstance(idx, tuple) else (idx,)
        if any(i is Ellipsis for i in idx):
            at = next(k for k, i in enumerate(idx) if i is Ellipsis)
            fill = (slice(None),) * (self.ndim - len(idx) + 1)
            idx = idx[:at] + fill + idx[at + 1:]
        if len(idx) > self.ndim:
            raise IndexError(f"too many indices for an array of shape {self.shape}")
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        sel = list(self._sel)
        view_dims = [d for d, s in enumerate(sel) if not isinstance(s, int)]
        for d, ix in zip(view_dims, idx):
            r = range(*sel[d])
            if isinstance(ix, (int, np.integer)):
                sel[d] = r[int(ix)]
            elif isinstance(ix, slice) and (ix.step is None or ix.step > 0):
                rr = r[ix]
                sel[d] = (rr.start, rr.stop, rr.step)
            else:
                raise _Fancy
        return tuple(sel)

    def _box(self):
        box = []
        for s in self._sel:
            if isinstance(s, int):
                box.append((s, s + 1))
            else:
                r = range(*s)
                box.append((r[0], r[-1] + 1) if len(r) else (r.start, r.start))
        return box

    def __getitem__(self, idx):
        try:
            sel = self._compose(idx)
        except _Fancy:
            return self.read()[idx]
        view = LazyZarrArray(self._array, sel)
        return view.read()[()] if view.ndim == 0 else view

    def __setitem__(self, idx, value):
        sel = self._compose(idx)
        if any(not isinstance(s, int) and s[2] != 1 for s in sel):
            raise NotImplementedError("region writes with a step are not supported")
        view = LazyZarrArray(self._array, sel)
        box = view._box()
        value = np.broadcast_to(np.asarray(value), view.shape)
        self._array.write(box, value.reshape(tuple(b1 - b0 for b0, b1 in box)))

    def read(self) -> np.ndarray:
        data = self._array.read(self._box())
        return data[tuple(
            0 if isinstance(s, int) else slice(None, None, s[2]) for s in self._sel
        )]

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out.astype(dtype) if dtype is not None else out


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def open_zarr_array(url: str, zarr_format: Optional[int] = None) -> LazyZarrArray:
    """Open an existing zarr v2 array."""
    path = _local_path(url)
    if zarr_format == 3 or (
        not os.path.exists(os.path.join(path, ".zarray"))
        and os.path.exists(os.path.join(path, "zarr.json"))
    ):
        raise NotImplementedError(f"{url}: {_V3}")
    try:
        meta = _read_json(os.path.join(path, ".zarray"))
    except FileNotFoundError:
        raise FileNotFoundError(f"Could not open zarr array at {url}: no .zarray") from None
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{url}: zarr_format {meta.get('zarr_format')}: {_V3}")
    return LazyZarrArray(ZarrV2(path, meta))


def create_zarr_array(
    url: str,
    shape: Sequence[int],
    chunks: Sequence[int],
    dtype,
    fill_value=0,
    zarr_format: int = 2,
    overwrite: bool = True,
    compressor: Optional[dict] = None,
    shards: Optional[Sequence[int]] = None,
    dimension_separator: str = ".",
) -> LazyZarrArray:
    """Create a zarr v2 array for region writes (with ``overwrite``, after
    removing whatever is at ``url``), or open the one there when
    ``overwrite`` is False and its shape, chunks and dtype agree."""
    if zarr_format != 2 or shards is not None:
        raise NotImplementedError(_V3)
    if dimension_separator not in (".", "/"):
        raise ValueError(f"dimension_separator must be '.' or '/', got {dimension_separator!r}")
    path = _local_path(url)
    dtype = np.dtype(dtype)
    shape = [int(s) for s in shape]
    chunks = [int(c) for c in chunks]
    if overwrite and os.path.exists(path):
        shutil.rmtree(path)
    elif not overwrite and os.path.exists(os.path.join(path, ".zarray")):
        arr = open_zarr_array(url)
        if (list(arr.shape), list(arr.chunks), arr.dtype) != (shape, chunks, dtype):
            raise ValueError(
                f"{url} holds a {arr.shape} {arr.dtype} array in chunks of "
                f"{arr.chunks}, not {tuple(shape)} {dtype} in chunks of {tuple(chunks)}"
            )
        return arr
    meta = {
        "zarr_format": 2,
        "shape": shape,
        "chunks": chunks,
        "dtype": dtype.str,
        "compressor": compressor,
        "fill_value": _encode_fill(fill_value, dtype),
        "order": "C",
        "filters": None,
        "dimension_separator": dimension_separator,
    }
    array = ZarrV2(path, meta)  # checks the compressor before anything is written
    os.makedirs(path, exist_ok=True)
    _write_atomically(os.path.join(path, ".zarray"), json.dumps(meta, indent=2).encode())
    return LazyZarrArray(array)


def attach_zarr_array(url: str, zarr_format: Optional[int] = None) -> LazyZarrArray:
    """Open an existing array for writing. Several writers may attach and
    write disjoint sets of chunks: one file per chunk."""
    return open_zarr_array(url, zarr_format=zarr_format)


# ---------------------------------------------------------------------------
# group metadata (plain JSON files)
# ---------------------------------------------------------------------------


def write_group_metadata(path: str, attrs: dict, zarr_format: int = 2):
    if zarr_format != 2:
        raise NotImplementedError(_V3)
    path = _local_path(path)
    os.makedirs(path, exist_ok=True)
    _write_atomically(os.path.join(path, ".zgroup"), json.dumps({"zarr_format": 2}).encode())
    _write_atomically(os.path.join(path, ".zattrs"), json.dumps(attrs, indent=2).encode())


def read_group_metadata(path: str) -> Tuple[dict, int]:
    """Returns (attrs, zarr_format)."""
    path = _local_path(path)
    zattrs = os.path.join(path, ".zattrs")
    zjson = os.path.join(path, "zarr.json")
    if os.path.exists(zattrs):
        return _read_json(zattrs), 2
    if os.path.exists(zjson):
        return _read_json(zjson).get("attributes", {}), 3
    raise FileNotFoundError(f"No zarr group metadata at {path}")
