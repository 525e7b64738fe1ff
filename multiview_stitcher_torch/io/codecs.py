"""TIFF codec layer: native (C) decoders with pure-Python plain versions.

The port of ``multiview_stitcher_tpu.io.codecs``. The decoders of
``_codecs.c`` (PackBits, TIFF LZW, predictor 2) are compiled at first use
with the system's C compiler (``cc -O2 -shared -fPIC``) into
``_build/libcodecs_<digest>.so`` inside the package, where ``<digest>``
hashes the source and the flags, and called through ctypes. Where no
compiler builds it, the pure-Python decoders take over with the same
output, as in the reference, and a WARNING says so; :func:`native_route`
tells which route was taken. Supported TIFF compression schemes:

- 1     none
- 5     LZW (TIFF variant: MSB-first, early change)
- 8 / 32946  Deflate (stdlib zlib)
- 32773 PackBits

plus TIFF predictor 2 (horizontal differencing). Encoders (LZW, PackBits)
are pure Python: writing is not a hot path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "_codecs.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
_COMPILERS = ("cc", "gcc", "clang")
_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def compiler() -> Optional[str]:
    """Path of the C compiler the native build uses, or None."""
    for name in _COMPILERS:
        found = shutil.which(name)
        if found:
            return found
    return None


def library_path() -> Path:
    """Path of the built native library (built or not)."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcodecs_{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cc = compiler()
    if cc is None:
        raise RuntimeError(f"no C compiler found (tried {', '.join(_COMPILERS)})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed to build {_SRC.name}: {proc.stderr.strip()}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def _load_native():
    """Build (once) and load the native codec library; None, with a
    WARNING, when it cannot be built or loaded."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
            for name in ("mvs_packbits_decode", "mvs_lzw_decode"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_long
                fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
            for name in ("mvs_predictor2_rows_u8", "mvs_predictor2_rows_u16"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
            _lib = lib
        except Exception as e:  # noqa: BLE001
            logger.warning("native codecs unavailable (%s); decoding in Python", e)
            _lib = None
        _lib_tried = True
    return _lib


def native_route() -> str:
    """``"native"`` when the C decoders are loaded (building them at first
    call), else ``"python"``."""
    return "native" if _load_native() is not None else "python"


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


def _native_decode(fn, data: bytes, expected_size: int, what: str) -> bytes:
    out = bytearray(expected_size)
    buf = (ctypes.c_uint8 * expected_size).from_buffer(out) if expected_size else None
    n = fn(bytes(data), len(data), buf, expected_size)
    del buf  # releases the export of ``out``
    if n < 0:
        raise ValueError(f"malformed {what} stream")
    return bytes(out) if n == expected_size else bytes(out[:n])


def packbits_decode(data: bytes, expected_size: int) -> bytes:
    lib = _load_native()
    if lib is not None:
        return _native_decode(lib.mvs_packbits_decode, data, expected_size, "PackBits")
    return _packbits_decode_py(data, expected_size)


def _packbits_decode_py(data: bytes, expected_size: int) -> bytes:
    out_b = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out_b += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out_b += bytes([data[i]]) * (257 - h)
            i += 1
    return bytes(out_b)


def lzw_decode(data: bytes, expected_size: int) -> bytes:
    lib = _load_native()
    if lib is not None:
        return _native_decode(lib.mvs_lzw_decode, data, expected_size, "LZW")
    return _lzw_decode_py(data, expected_size)


def _lzw_decode_py(data: bytes, expected_size: int) -> bytes:
    CLEAR, EOI, FIRST = 256, 257, 258
    entries = [bytes([c]) for c in range(256)] + [b"", b""]
    width = 9
    bitbuf = bits = 0
    out = bytearray()
    prev = None
    i, n = 0, len(data)
    while True:
        while bits < width:
            if i >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[i]
            i += 1
            bits += 8
        code = (bitbuf >> (bits - width)) & ((1 << width) - 1)
        bits -= width
        # keep only the unread bits: the JAX package's decoder lets the buffer
        # grow with the input, which makes its decode quadratic
        bitbuf &= (1 << bits) - 1
        if code == EOI:
            return bytes(out)
        if code == CLEAR:
            del entries[FIRST:]
            width = 9
            prev = None
            continue
        if prev is None:
            out += entries[code]
            prev = code
            continue
        if code < len(entries):
            s = entries[code]
        elif code == len(entries):
            s = entries[prev] + entries[prev][:1]
        else:
            raise ValueError("malformed LZW stream")
        out += s
        if len(entries) < 4096:
            entries.append(entries[prev] + s[:1])
        if len(entries) == (1 << width) - 1 and width < 12:
            width += 1
        prev = code
        if len(out) > expected_size:
            raise ValueError("LZW output exceeds expected size")


def deflate_decode(data: bytes, expected_size: int) -> bytes:
    return zlib.decompress(data)


# ---------------------------------------------------------------------------
# encoders (pure Python; writer-side only)
# ---------------------------------------------------------------------------


def packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # run of identical bytes?
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        # literal run until the next >=3 repeat
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, width: int):
        self.acc = (self.acc << width) | code
        self.nbits += width
        while self.nbits >= 8:
            self.buf.append((self.acc >> (self.nbits - 8)) & 0xFF)
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            self.buf.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = self.nbits = 0
        return bytes(self.buf)


def lzw_encode(data: bytes) -> bytes:
    """TIFF-flavor LZW encoder (MSB-first, early change)."""
    CLEAR, EOI, FIRST = 256, 257, 258
    bw = _BitWriter()

    table = {bytes([c]): c for c in range(256)}
    next_code = FIRST
    width = 9
    bw.write(CLEAR, width)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        bw.write(table[w], width)
        table[wc] = next_code
        next_code += 1
        # the encoder's table counter leads the decoder's by one entry, so
        # the early-change width switch lands at 2^w here (== the decoder's
        # 2^w - 1)
        if next_code == (1 << width) and width < 12:
            width += 1
        if next_code == 4094:
            bw.write(CLEAR, width)
            table = {bytes([c]): c for c in range(256)}
            next_code = FIRST
            width = 9
        w = bytes([b])
    if w:
        bw.write(table[w], width)
    bw.write(EOI, width)
    return bw.flush()


def deflate_encode(data: bytes) -> bytes:
    return zlib.compress(data)


# ---------------------------------------------------------------------------
# TIFF dispatch
# ---------------------------------------------------------------------------

TIFF_COMPRESSION_NONE = 1
TIFF_COMPRESSION_LZW = 5
TIFF_COMPRESSION_DEFLATE = 8
TIFF_COMPRESSION_DEFLATE_OLD = 32946
TIFF_COMPRESSION_PACKBITS = 32773


def decode_tiff_data(data: bytes, compression: int, expected_size: int) -> bytes:
    if compression == TIFF_COMPRESSION_NONE:
        return data
    if compression == TIFF_COMPRESSION_LZW:
        return lzw_decode(data, expected_size)
    if compression in (TIFF_COMPRESSION_DEFLATE, TIFF_COMPRESSION_DEFLATE_OLD):
        return deflate_decode(data, expected_size)
    if compression == TIFF_COMPRESSION_PACKBITS:
        return packbits_decode(data, expected_size)
    raise NotImplementedError(f"TIFF compression {compression} not supported.")


def encode_tiff_data(data: bytes, compression: int) -> bytes:
    if compression == TIFF_COMPRESSION_NONE:
        return data
    if compression == TIFF_COMPRESSION_LZW:
        return lzw_encode(data)
    if compression in (TIFF_COMPRESSION_DEFLATE, TIFF_COMPRESSION_DEFLATE_OLD):
        return deflate_encode(data)
    if compression == TIFF_COMPRESSION_PACKBITS:
        return packbits_encode(data)
    raise NotImplementedError(f"TIFF compression {compression} not supported.")


def undo_predictor2(arr: np.ndarray) -> np.ndarray:
    """Undo TIFF predictor 2 (horizontal differencing) row-wise: a running
    sum along the last axis that wraps at the dtype's width. 8- and 16-bit
    integer samples take the native route, others numpy's."""
    small_int = arr.dtype.kind in "ui" and arr.dtype.itemsize in (1, 2) and arr.dtype.isnative
    lib = _load_native() if small_int else None
    if lib is None or arr.ndim == 0 or arr.size == 0:
        return _undo_predictor2_py(arr)
    out = np.array(arr, order="C")
    fn = lib.mvs_predictor2_rows_u8 if arr.dtype.itemsize == 1 else lib.mvs_predictor2_rows_u16
    fn(out.ctypes.data, out.size // out.shape[-1], out.shape[-1])
    return out


def _undo_predictor2_py(arr: np.ndarray) -> np.ndarray:
    return np.cumsum(arr.astype(np.int64), axis=-1, dtype=np.int64).astype(arr.dtype)
