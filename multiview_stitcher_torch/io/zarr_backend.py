"""Zarr v2 and v3 arrays on numpy, ``json``, ``os`` and the standard library.

The port's counterpart of ``multiview_stitcher_tpu.io.zarr_backend``, which
reads and writes through tensorstore, under the same function names. The
card's machine has neither tensorstore nor zarr-python, so the formats are
written out here:

- zarr v2: a ``.zarray`` JSON document beside one file per chunk, chunks in
  C (or, read only, F) order, the ``"."`` and ``"/"`` dimension separators,
  ``fill_value`` for chunks that do not exist, edge chunks stored at full
  size. Compressors: ``null`` and ``{"id": "zlib", "level": n}`` are read and
  written; blosc (tensorstore's default for an array created without a
  compressor) only where ``numcodecs`` or the ``blosc`` module imports; any
  other compressor, and any filter, raises ``NotImplementedError`` naming it.
  The port writes ``compressor: null`` unless asked otherwise.
- zarr v3 (NGFF 0.5): a ``zarr.json`` document as tensorstore writes it,
  chunk keys ``c/i/j`` (the ``"default"`` key encoding; ``"v2"`` keys are
  read too), the ``bytes`` codec in either endianness, ``gzip`` and ``zstd``
  where the standard library or the ``zstandard`` module decodes them,
  ``crc32c`` (the Castagnoli CRC, table-driven here), and the
  ``sharding_indexed`` codec: one file per shard holding its inner chunks
  and, at its end (or start), an index of one (offset, nbytes) uint64 pair
  per inner chunk, 2^64 - 1 for a chunk that is not stored, followed by its
  CRC32C. Inner chunks that hold only the fill value are not stored, and a
  shard that holds none is not written, as tensorstore does. Any other codec
  raises ``NotImplementedError`` naming it.
- a region write that covers a chunk's (or shard's) whole extent writes it
  without reading it; any other reads, modifies and writes it. A sharded
  array's region writes go shard by shard under a lock per shard within the
  process. Chunk and shard files are replaced atomically, so readers never
  see half of one; two processes must not write one chunk or shard at once
  (the streaming tier aligns its bands to whole output chunks, or shards,
  for that reason).

Each array's metadata document is parsed once, when it is opened; a
:class:`LazyZarrArray` and every view sliced from it share that parse.

``open_zarr_array`` also reads an array served over ``http://`` or
``https://`` (a virtual OME-Zarr of ``io.virtual_ngff``, any static zarr
server), as tensorstore's ``http`` driver does for the JAX package: one GET a
metadata document or chunk through ``urllib``, a 404 read as a chunk of the
fill value, any other HTTP error raised. Such arrays are read only.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
import uuid
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np


# seconds a GET of a metadata document or chunk may wait for the server
HTTP_TIMEOUT_S = 60


def _is_http(path) -> bool:
    return str(path).startswith(("http://", "https://"))


def _read_bytes(path: str) -> Optional[bytes]:
    """The bytes of a file or of an HTTP(S) URL, None where there is none
    (no such file, a 404)."""
    if _is_http(path):
        try:
            with urllib.request.urlopen(path, timeout=HTTP_TIMEOUT_S) as r:
                return r.read()
        except urllib.error.HTTPError as err:
            if err.code == 404:
                return None
            raise
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


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


def _decode_fill_v3(value, dtype: np.dtype):
    """A v3 ``fill_value``: a number, a boolean, ``"NaN"`` / ``"Infinity"`` /
    ``"-Infinity"``, or a float's bits as a ``"0x..."`` string."""
    if isinstance(value, str) and value.startswith("0x"):
        bits = np.array(int(value, 16), dtype=f"u{dtype.itemsize}")
        return bits.view(dtype)[()]
    return _decode_fill(value, dtype)


def _encode_fill_v3(value, dtype: np.dtype):
    if dtype.kind == "f" and value is not None:
        v = _encode_fill(value, dtype)
        return v if isinstance(v, str) else float(v)
    return _encode_fill(0 if value is None else value, dtype)


def _write_atomically(path: str, data: bytes) -> None:
    if _is_http(path):
        raise NotImplementedError(f"zarr arrays over HTTP are read only: {path}")
    tmp = f"{path}.{uuid.uuid4().hex}.partial"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class _ChunkGrid:
    """Reads and writes of boxes, ``(start, stop)`` per dim, over a regular
    grid of cells of shape ``self.grid`` (a v2 or plain v3 array's chunks, a
    sharded v3 array's shards), through ``_read_cell(idx)`` (None where the
    cell is not stored) and ``_write_cell(idx, cell)``."""

    shape: tuple
    grid: tuple
    dtype: np.dtype
    fill: object

    def _cell_ranges(self, box):
        return [
            range(b0 // c, -(-b1 // c)) if b1 > b0 else range(0)
            for (b0, b1), c in zip(box, self.grid)
        ]

    def _overlap(self, idx, box):
        """(cell-local, box-local) slices of a cell's part of ``box``, and
        whether that part is the cell's whole extent inside the array."""
        in_cell, in_box, whole = [], [], True
        for i, (b0, b1), c, n in zip(idx, box, self.grid, self.shape):
            c0, c1 = i * c, min((i + 1) * c, n)
            lo, hi = max(c0, b0), min(c1, b1)
            in_cell.append(slice(lo - c0, hi - c0))
            in_box.append(slice(lo - b0, hi - b0))
            whole &= lo == c0 and hi == c1
        return tuple(in_cell), tuple(in_box), whole

    def read(self, box, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The box's values, into ``out`` when given (an array of the box's
        shape, which may be a view)."""
        if out is None:
            out = np.empty(tuple(b1 - b0 for b0, b1 in box), dtype=self.dtype)
        for idx in itertools.product(*self._cell_ranges(box)):
            in_cell, in_box, _ = self._overlap(idx, box)
            cell = self._read_cell(idx)
            out[in_box] = self.fill if cell is None else cell[in_cell]
        return out

    def _update_cell(self, idx, box, value) -> None:
        in_cell, in_box, whole = self._overlap(idx, box)
        cell = None if whole else self._read_cell(idx)
        if cell is None:
            cell = np.full(self.grid, self.fill, dtype=self.dtype)
        else:
            cell = cell.copy()
        cell[in_cell] = value[in_box]
        self._write_cell(idx, cell)

    def write(self, box, value: np.ndarray) -> None:
        for idx in itertools.product(*self._cell_ranges(box)):
            self._update_cell(idx, box, value)


class ZarrV2(_ChunkGrid):
    """One zarr v2 array on disk: its parsed ``.zarray`` and chunk IO over
    boxes of ``(start, stop)`` per dim."""

    zarr_format = 2
    shards = None

    def __init__(self, path: str, meta: dict):
        if meta.get("filters"):
            raise NotImplementedError(f"zarr filters {meta['filters']} are not supported")
        self.path = path
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = self.grid = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        self.fill = _decode_fill(meta.get("fill_value"), self.dtype)
        self.codec = _codec(meta.get("compressor"))
        self.sep = meta.get("dimension_separator", ".")

    def _chunk_path(self, idx) -> str:
        key = self.sep.join(str(i) for i in idx) if idx else "0"
        return os.path.join(self.path, key)

    def _read_cell(self, idx) -> Optional[np.ndarray]:
        raw = _read_bytes(self._chunk_path(idx))
        if raw is None:
            return None
        if self.codec is not None:
            raw = self.codec.decode(raw)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks, order=self.order)

    def _write_cell(self, idx, chunk: np.ndarray) -> None:
        if self.order != "C":
            raise NotImplementedError("writing F-order zarr chunks is not supported")
        chunk = np.ascontiguousarray(chunk)
        path = self._chunk_path(idx)
        if self.sep == "/":
            os.makedirs(os.path.dirname(path), exist_ok=True)
        data = self.codec.encode(chunk) if self.codec is not None else chunk.tobytes()
        _write_atomically(path, data)


# ---------------------------------------------------------------------------
# zarr v3
# ---------------------------------------------------------------------------


def _crc32c_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[n] = c
    return table


_CRC32C_TABLE = [int(x) for x in _crc32c_table()]


def crc32c(data: bytes) -> int:
    """The CRC-32C (Castagnoli polynomial, reflected 0x82F63B78) of
    ``data``, table-driven; ``zlib.crc32`` is the other polynomial."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Crc32c:
    def encode(self, raw: bytes) -> bytes:
        return raw + crc32c(raw).to_bytes(4, "little")

    def decode(self, raw: bytes) -> bytes:
        body, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
        if crc32c(body) != stored:
            raise ValueError("zarr v3 crc32c checksum mismatch")
        return body


class _Gzip:
    def __init__(self, level: int = 5):
        self.level = int(level)

    def encode(self, raw: bytes) -> bytes:
        return gzip.compress(raw, compresslevel=self.level, mtime=0)

    def decode(self, raw: bytes) -> bytes:
        return gzip.decompress(raw)


class _Zstd:
    def __init__(self, level: int = 0):
        try:
            import zstandard
        except ImportError:
            raise NotImplementedError(
                "zarr v3 codec 'zstd' needs the zstandard module, which does not import here"
            ) from None
        self.zstandard, self.level = zstandard, int(level)

    def encode(self, raw: bytes) -> bytes:
        return self.zstandard.ZstdCompressor(level=self.level).compress(raw)

    def decode(self, raw: bytes) -> bytes:
        return self.zstandard.ZstdDecompressor().stream_reader(raw).read()


def _bytes_to_bytes(codec: dict):
    name, conf = codec["name"], codec.get("configuration") or {}
    if name == "gzip":
        return _Gzip(conf.get("level", 5))
    if name == "zstd":
        return _Zstd(conf.get("level", 0))
    if name == "crc32c":
        return _Crc32c()
    raise NotImplementedError(
        f"zarr v3 codec {name!r} ({codec}) is not supported: the port reads and writes "
        "bytes, sharding_indexed, gzip, zstd (where zstandard imports) and crc32c"
    )


class _Pipeline:
    """A v3 codec chain: ``bytes`` (array to bytes, either endianness, C
    order) and bytes-to-bytes codecs after it."""

    def __init__(self, codecs, dtype: np.dtype, shape):
        codecs = list(codecs)
        if not codecs or codecs[0]["name"] != "bytes":
            names = [c["name"] for c in codecs]
            raise NotImplementedError(
                f"zarr v3 codecs {names}: the port reads chains that start with 'bytes' "
                "(or a single sharding_indexed codec)"
            )
        endian = (codecs[0].get("configuration") or {}).get("endian", "little")
        self.dtype = dtype.newbyteorder("<" if endian == "little" else ">")
        self.native = dtype
        self.shape = tuple(shape)
        self.b2b = [_bytes_to_bytes(c) for c in codecs[1:]]

    def encode(self, chunk: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(chunk, dtype=self.dtype).tobytes()
        for c in self.b2b:
            raw = c.encode(raw)
        return raw

    def decode(self, raw: bytes) -> np.ndarray:
        for c in reversed(self.b2b):
            raw = c.decode(raw)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.shape).astype(
            self.native, copy=False)


_EMPTY = np.uint64(2**64 - 1)
_DEFAULT_INDEX_CODECS = [{"name": "bytes", "configuration": {"endian": "little"}},
                         {"name": "crc32c"}]


class ZarrV3(_ChunkGrid):
    """One zarr v3 array on disk: its parsed ``zarr.json`` and chunk or
    shard IO over boxes of ``(start, stop)`` per dim. ``chunks`` is the read
    granularity (a sharded array's inner chunks), ``shards`` the shard shape
    (None unsharded) and ``grid`` the file granularity."""

    zarr_format = 3
    _locks_guard = threading.Lock()
    _locks: dict = {}

    def __init__(self, path: str, meta: dict):
        if meta.get("node_type", "array") != "array":
            raise ValueError(f"{path}: zarr.json describes a {meta.get('node_type')}, not an array")
        if meta.get("storage_transformers"):
            raise NotImplementedError(
                f"zarr v3 storage transformers {meta['storage_transformers']} are not supported")
        grid = meta["chunk_grid"]
        if grid.get("name") != "regular":
            raise NotImplementedError(f"zarr v3 chunk grid {grid.get('name')!r} is not supported")
        self.path = path
        self.shape = tuple(int(s) for s in meta["shape"])
        self.grid = tuple(int(c) for c in grid["configuration"]["chunk_shape"])
        self.dtype = np.dtype(meta["data_type"])
        self.fill = _decode_fill_v3(meta.get("fill_value"), self.dtype)
        enc = meta.get("chunk_key_encoding", {"name": "default"})
        conf = enc.get("configuration") or {}
        if enc["name"] == "default":
            self._prefix, self._sep = "c", conf.get("separator", "/")
        elif enc["name"] == "v2":
            self._prefix, self._sep = None, conf.get("separator", ".")
        else:
            raise NotImplementedError(f"zarr v3 chunk key encoding {enc['name']!r} is not supported")
        codecs = meta.get("codecs") or [{"name": "bytes"}]
        if codecs[0]["name"] == "sharding_indexed":
            if len(codecs) != 1:
                raise NotImplementedError(f"zarr v3 codecs after sharding_indexed: {codecs[1:]}")
            sconf = codecs[0]["configuration"]
            self.chunks = tuple(int(c) for c in sconf["chunk_shape"])
            self.shards = self.grid
            if any(s % c for s, c in zip(self.shards, self.chunks)):
                raise ValueError(f"shard shape {self.shards} is no multiple of the inner "
                                 f"chunk shape {self.chunks}")
            self.inner = _Pipeline(sconf.get("codecs") or [{"name": "bytes"}], self.dtype,
                                   self.chunks)
            self.n_inner = tuple(s // c for s, c in zip(self.shards, self.chunks))
            self.index = _Pipeline(sconf.get("index_codecs") or _DEFAULT_INDEX_CODECS,
                                   np.dtype(np.uint64), self.n_inner + (2,))
            self.index_nbytes = len(self.index.encode(np.zeros(self.n_inner + (2,), np.uint64)))
            self.index_at_end = sconf.get("index_location", "end") == "end"
        else:
            self.chunks, self.shards = self.grid, None
            self.inner = _Pipeline(codecs, self.dtype, self.chunks)

    def _cell_path(self, idx) -> str:
        parts = [str(i) for i in idx]
        if self._prefix is not None:
            parts = [self._prefix] + parts
        key = self._sep.join(parts) if parts else "0"
        return os.path.join(self.path, *key.split("/"))

    def _read_file(self, idx) -> Optional[bytes]:
        return _read_bytes(self._cell_path(idx))

    def _is_fill(self, chunk: np.ndarray) -> bool:
        if self.dtype.kind == "f" and np.isnan(self.fill):
            return bool(np.isnan(chunk).all())
        return bool((chunk == self.fill).all())

    def _store(self, idx, data: Optional[bytes]) -> None:
        path = self._cell_path(idx)
        if data is None:
            if os.path.exists(path):
                os.remove(path)
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_atomically(path, data)

    # -- sharded: one file a shard, inner chunks behind an index --------------

    def _shard_index(self, raw: bytes) -> np.ndarray:
        n = self.index_nbytes
        part = raw[-n:] if self.index_at_end else raw[:n]
        return self.index.decode(part).reshape(-1, 2)

    def _inner_chunks(self, raw: bytes, wanted=None):
        """(inner index, chunk) of the stored inner chunks of a shard,
        those in ``wanted`` (a set of inner indexes) when given."""
        table = self._shard_index(raw)
        for k, inner in enumerate(np.ndindex(*self.n_inner)):
            offset, nbytes = table[k]
            if offset == _EMPTY and nbytes == _EMPTY:
                continue
            if wanted is not None and inner not in wanted:
                continue
            yield inner, self.inner.decode(raw[int(offset):int(offset) + int(nbytes)])

    def _read_cell(self, idx) -> Optional[np.ndarray]:
        raw = self._read_file(idx)
        if raw is None:
            return None
        if self.shards is None:
            return self.inner.decode(raw)
        shard = np.full(self.shards, self.fill, dtype=self.dtype)
        for inner, chunk in self._inner_chunks(raw):
            shard[tuple(slice(i * c, (i + 1) * c) for i, c in zip(inner, self.chunks))] = chunk
        return shard

    def _write_cell(self, idx, cell: np.ndarray) -> None:
        if self.shards is None:
            self._store(idx, None if self._is_fill(cell) else self.inner.encode(cell))
            return
        table = np.full(self.n_inner + (2,), _EMPTY, dtype=np.uint64)
        parts, offset = [], 0 if self.index_at_end else self.index_nbytes
        for inner in np.ndindex(*self.n_inner):
            lo = [(s * g) + i * c for s, g, i, c in zip(idx, self.grid, inner, self.chunks)]
            if any(a >= n for a, n in zip(lo, self.shape)):
                continue  # wholly outside the array
            chunk = cell[tuple(slice(i * c, (i + 1) * c) for i, c in zip(inner, self.chunks))]
            if self._is_fill(chunk):
                continue
            data = self.inner.encode(chunk)
            table[inner] = (offset, len(data))
            parts.append(data)
            offset += len(data)
        if not parts:
            self._store(idx, None)
            return
        index = self.index.encode(table)
        self._store(idx, b"".join(parts + [index]) if self.index_at_end
                    else b"".join([index] + parts))

    def _lock(self, idx) -> threading.Lock:
        key = (self.path, tuple(idx))
        with self._locks_guard:
            return self._locks.setdefault(key, threading.Lock())

    def read(self, box, out: Optional[np.ndarray] = None) -> np.ndarray:
        if self.shards is None:
            return super().read(box, out)
        # decode only the inner chunks the box meets
        if out is None:
            out = np.empty(tuple(b1 - b0 for b0, b1 in box), dtype=self.dtype)
        out[...] = self.fill
        for idx in itertools.product(*self._cell_ranges(box)):
            raw = self._read_file(idx)
            if raw is None:
                continue
            origin = [i * g for i, g in zip(idx, self.grid)]
            wanted = set(itertools.product(*[
                range(max(b0 - o, 0) // c, -(-min(b1 - o, g) // c))
                for (b0, b1), o, g, c in zip(box, origin, self.grid, self.chunks)
            ]))
            for inner, chunk in self._inner_chunks(raw, wanted):
                c0 = [o + i * c for o, i, c in zip(origin, inner, self.chunks)]
                src, dst = [], []
                for (b0, b1), a, c in zip(box, c0, self.chunks):
                    lo, hi = max(a, b0), min(a + c, b1)
                    src.append(slice(lo - a, hi - a))
                    dst.append(slice(lo - b0, hi - b0))
                out[tuple(dst)] = chunk[tuple(src)]
        return out

    def _update_cell(self, idx, box, value) -> None:
        if self.shards is None:
            return super()._update_cell(idx, box, value)
        with self._lock(idx):
            return super()._update_cell(idx, box, value)


class _Fancy(Exception):
    """An index a lazy view does not compose (arrays, negative steps)."""


class LazyZarrArray:
    """Lazy view over a zarr v2 or v3 array: the counterpart of the
    reference's ``LazyTSArray``.

    ``shape``, ``dtype``, ``__getitem__`` (integers, slices with a positive
    step and ``...`` give another lazy view; nothing is read until
    ``read`` / ``np.asarray``; other indexes read the view and index the
    result), ``__setitem__`` (a region write with unit steps)."""

    def __init__(self, array, sel=None):
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
        """The array's chunk shape (a sharded array's inner chunks)."""
        return self._array.chunks

    @property
    def shards(self) -> Optional[tuple]:
        """The shard shape of a sharded v3 array, else None."""
        return self._array.shards

    @property
    def write_chunks(self) -> tuple:
        """The extent that concurrent region writes must not share: the
        shards of a sharded array, else its chunks."""
        return self._array.grid

    @property
    def zarr_format(self) -> int:
        return self._array.zarr_format

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
            "zarr_format": self._array.zarr_format,
            "sel": [s if isinstance(s, int) else list(s) for s in self._sel],
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "LazyZarrArray":
        array = open_zarr_array(spec["path"], spec.get("zarr_format"))._array
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

    def read(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The view's values, read into ``out`` when given (an array of the
        view's shape; a view with steps or dropped dims reads as usual and
        copies)."""
        plain = all(not isinstance(s, int) and s[2] == 1 for s in self._sel)
        if out is not None and plain:
            return self._array.read(self._box(), out)
        data = self._array.read(self._box())
        data = data[tuple(
            0 if isinstance(s, int) else slice(None, None, s[2]) for s in self._sel
        )]
        if out is not None:
            out[...] = data
            return out
        return data

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out.astype(dtype) if dtype is not None else out


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def open_zarr_array(url: str, zarr_format: Optional[int] = None) -> LazyZarrArray:
    """Open an existing zarr v2 (``.zarray``) or v3 (``zarr.json``) array,
    whichever is there unless ``zarr_format`` names one: on the local file
    system, or read only over HTTP(S)."""
    path = str(url).rstrip("/") if _is_http(url) else _local_path(url)
    formats = (2, 3) if zarr_format is None else (int(zarr_format),)
    for fmt in formats:
        name = ".zarray" if fmt == 2 else "zarr.json"
        raw = _read_bytes(os.path.join(path, name))
        if raw is None:
            continue
        meta = json.loads(raw)
        if meta.get("zarr_format") != fmt:
            raise ValueError(f"{url}/{name}: zarr_format {meta.get('zarr_format')}, not {fmt}")
        return LazyZarrArray(ZarrV2(path, meta) if fmt == 2 else ZarrV3(path, meta))
    raise FileNotFoundError(
        f"Could not open zarr array at {url}: no "
        + " or ".join(".zarray" if f == 2 else "zarr.json" for f in formats)
    )


def _v3_metadata(shape, chunks, dtype: np.dtype, fill_value, shards) -> dict:
    """A v3 array's ``zarr.json`` as tensorstore writes it: the ``bytes``
    codec (little-endian), or ``sharding_indexed`` of the inner ``chunks``
    with its default index codecs (``bytes``, ``crc32c``)."""
    bytes_codec = {"configuration": {"endian": "little"}, "name": "bytes"}
    if shards is None:
        grid, codecs = chunks, [bytes_codec]
    else:
        for sh, c in zip(shards, chunks):
            if sh % c:
                raise ValueError(
                    f"shard shape {tuple(shards)} must be a multiple "
                    f"of the inner chunk shape {tuple(chunks)}"
                )
        grid = shards
        codecs = [{
            "configuration": {
                "chunk_shape": list(chunks),
                "codecs": [bytes_codec],
                "index_codecs": [bytes_codec, {"name": "crc32c"}],
            },
            "name": "sharding_indexed",
        }]
    return {
        "chunk_grid": {"configuration": {"chunk_shape": list(grid)}, "name": "regular"},
        "chunk_key_encoding": {"name": "default"},
        "codecs": codecs,
        "data_type": dtype.name,
        "fill_value": _encode_fill_v3(fill_value, dtype),
        "node_type": "array",
        "shape": list(shape),
        "zarr_format": 3,
    }


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
    """Create a zarr array for region writes (with ``overwrite``, after
    removing whatever is at ``url``), or open the one there when
    ``overwrite`` is False and its shape, chunks, shards and dtype agree.

    ``zarr_format=2``: a ``.zarray`` with ``compressor`` and
    ``dimension_separator``. ``zarr_format=3`` (NGFF 0.5): a ``zarr.json``
    as tensorstore writes it; ``shards`` makes it sharded
    (``sharding_indexed``), ``chunks`` then the inner chunks, each shard a
    multiple of them and one file, the granularity of concurrent writes.
    As in the reference, a v3 array takes no ``compressor``: it is left
    uncompressed."""
    if dimension_separator not in (".", "/"):
        raise ValueError(f"dimension_separator must be '.' or '/', got {dimension_separator!r}")
    if zarr_format not in (2, 3):
        raise ValueError(f"zarr_format must be 2 or 3, got {zarr_format!r}")
    if zarr_format == 2 and shards is not None:
        raise ValueError("sharding requires zarr_format=3 (NGFF 0.5)")
    path = _local_path(url)
    dtype = np.dtype(dtype)
    shape = [int(s) for s in shape]
    chunks = [int(c) for c in chunks]
    shards = None if shards is None else [int(s) for s in shards]
    if zarr_format == 2:
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
        name, array = ".zarray", ZarrV2(path, meta)  # checks the compressor first
    else:
        meta = _v3_metadata(shape, chunks, dtype, fill_value, shards)
        name, array = "zarr.json", ZarrV3(path, meta)
    if overwrite and os.path.exists(path):
        shutil.rmtree(path)
    elif not overwrite and os.path.exists(os.path.join(path, name)):
        arr = open_zarr_array(url, zarr_format)
        if (list(arr.shape), list(arr.chunks), arr.dtype) != (shape, chunks, dtype) or (
            arr.shards != (None if shards is None else tuple(shards))
        ):
            raise ValueError(
                f"{url} holds a {arr.shape} {arr.dtype} array in chunks of "
                f"{arr.chunks} (shards {arr.shards}), not {tuple(shape)} {dtype} in chunks "
                f"of {tuple(chunks)} (shards {None if shards is None else tuple(shards)})"
            )
        return arr
    os.makedirs(path, exist_ok=True)
    text = (json.dumps(meta, indent=2) if zarr_format == 2
            else json.dumps(meta, sort_keys=True, separators=(",", ":")))
    _write_atomically(os.path.join(path, name), text.encode())
    return LazyZarrArray(array)


def attach_zarr_array(url: str, zarr_format: Optional[int] = None) -> LazyZarrArray:
    """Open an existing array for writing. Several writers may attach and
    write disjoint sets of chunks (of shards, for a sharded array): one file
    each."""
    return open_zarr_array(url, zarr_format=zarr_format)


# ---------------------------------------------------------------------------
# group metadata (plain JSON files)
# ---------------------------------------------------------------------------


def write_group_metadata(path: str, attrs: dict, zarr_format: int = 2):
    """A group's attributes: ``.zgroup`` and ``.zattrs`` (v2), or a
    ``zarr.json`` of ``node_type`` group (v3)."""
    path = _local_path(path)
    os.makedirs(path, exist_ok=True)
    if zarr_format == 2:
        _write_atomically(os.path.join(path, ".zgroup"), json.dumps({"zarr_format": 2}).encode())
        _write_atomically(os.path.join(path, ".zattrs"), json.dumps(attrs, indent=2).encode())
    else:
        doc = {"zarr_format": 3, "node_type": "group", "attributes": attrs}
        _write_atomically(os.path.join(path, "zarr.json"), json.dumps(doc, indent=2).encode())


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
