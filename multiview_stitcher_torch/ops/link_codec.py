"""The link codec: lossless bit packing of integer image data that crosses
the link between host and device, the port of
``multiview_stitcher_tpu.ops.link_codec`` with its wire format byte for byte.

Microscopy data ships 10-16 bit camera counts in uint16 containers; on a
narrow link the unused high bits are wasted bytes. The codec packs ``n``-bit
values into a dense byte stream, and ships only ``n/16`` of the bytes.

Packing layout (byte-planar, every step a whole-array shift, mask or cast):
``packed = [low_bytes | packed_high_bits]``, where ``low_bytes`` is
``v & 0xFF`` as uint8 and the ``nbits - 8`` high bits of each value are
packed ``8/(nbits-8)`` to a byte. Widths under 8 bits pack groups of G
values into B little-endian bytes (``_SUB_BYTE_GROUP``).

A transfer can instead ship the zigzag residuals of first-order row deltas
(rows of ``_DELTA_ROW`` values), of second-order differences (along x, then
y) or of third-order ones (then z), plus a sparse list of out-of-width
exceptions, whichever packs smallest; the first value of every row travels
raw. The choice is exact: each candidate's wire bytes are counted before
anything is sent.

Host half: numpy and the C loops of ``io/_codecs.c`` (built at first use,
run without the GIL). Device half: torch ops on any device, the
counterparts of the reference's jitted XLA functions. Torch has no shifts on
uint16, so the device half works in int32 (int64 for the wide sub-byte
groups and the cumsums, masked to 16 bits at the end) and views uint16 as
int16 at its edges.

Transfers (:func:`put_packed`, :func:`fetch_packed`) cut the packed stream
into up to :data:`STREAMS` bands: host threads pack or unpack one band
each, and on a CUDA device each band crosses through pinned memory on a copy
stream of its own, ordered after the caller's stream by events. On the CPU
the same code runs with plain copies.

The codec is a library: neither fusion nor registration sends data through
it. On an H100, PCIe moves pinned tiles to the card far faster than the host
packs them (PERF.md, ``link:`` lines of chip_smoke.py).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the candidates of the self-deciding choice; each ships only when it packs
# smaller (the reference's MVS_TPU_LINK_DELTA, _DELTA2 and _DELTA3)
DELTA = True
DELTA2 = True
DELTA3 = True
# parallel bands of a transfer (the reference's MVS_TPU_LINK_STREAMS)
STREAMS = 32

# a small set of widths (16 = passthrough); the sub-byte ones carry the delta
# residuals of smooth content
ALLOWED_NBITS = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16)

# sub-byte widths pack groups of G values into B bytes (G*nbits == 8*B); odd
# widths use groups of 8 (up to 56 bits)
_SUB_BYTE_GROUP = {
    2: (4, 1), 3: (8, 3), 4: (2, 1), 5: (8, 5), 6: (4, 3), 7: (8, 7),
}
_SUB16 = [n for n in ALLOWED_NBITS if n < 16]

_PACKABLE_DTYPES = (np.uint16, np.int16)


def nbits_for_max(max_value: int) -> int:
    """Smallest allowed bit width holding values in [0, max_value]."""
    need = max(1, int(max_value).bit_length())
    for n in ALLOWED_NBITS:
        if n >= need:
            return n
    return 16


def _extra_bits(nbits: int) -> int:
    if nbits not in ALLOWED_NBITS or nbits < 8:
        raise ValueError(
            f"nbits must be one of {[n for n in ALLOWED_NBITS if n >= 8]}, got {nbits}"
        )
    return nbits - 8


def packed_byte_count(count: int, nbits: int) -> int:
    if nbits >= 16:
        return count * 2
    if nbits < 8:
        g, b = _SUB_BYTE_GROUP[nbits]
        return -(-count // g) * b
    e = _extra_bits(nbits)
    if e == 0:
        return count
    per = 8 // e  # high-bit fields per byte
    return count + -(-count // per)


def is_packable(dtype) -> bool:
    return np.dtype(dtype) in [np.dtype(d) for d in _PACKABLE_DTYPES]


# ---------------------------------------------------------------------------
# host half (numpy and the native C loops)
# ---------------------------------------------------------------------------


def _native_codecs():
    """The port's native codec library (``io/codecs.py`` builds it from
    ``io/_codecs.c``) with the link codec's four functions declared, or
    None where it cannot be built."""
    from multiview_stitcher_torch.io import codecs

    lib = codecs._load_native()
    if lib is not None and not getattr(lib, "_bitpack_ready", False):
        import ctypes

        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.mvs_bitpack.restype = ctypes.c_long
        lib.mvs_bitpack.argtypes = [u16p, ctypes.c_long, ctypes.c_int, u8p]
        lib.mvs_bitunpack.restype = ctypes.c_long
        lib.mvs_bitunpack.argtypes = [u8p, ctypes.c_long, ctypes.c_int, ctypes.c_long, u16p]
        lib.mvs_delta_encode.restype = ctypes.c_long
        lib.mvs_delta_encode.argtypes = [u16p, ctypes.c_long, ctypes.c_int, u16p, u16p]
        lib.mvs_delta_decode.restype = ctypes.c_long
        lib.mvs_delta_decode.argtypes = [u16p, u16p, ctypes.c_long, ctypes.c_int, u16p]
        lib._bitpack_ready = True
    return lib


def _pack_wide_group(m, nbits, g, nb):
    """(n_groups, g) uint32 fields -> list of nb uint8 byte columns, with
    two 32-bit accumulators (bits 0-31 and 32-63)."""
    lo = hi = None
    for i in range(g):
        o = i * nbits
        f = m[:, i]
        if o + nbits <= 32:
            t = (f << np.uint32(o)) if o else f
            lo = t if lo is None else (lo | t)
        elif o < 32:
            lo = lo | (f << np.uint32(o))
            t = f >> np.uint32(32 - o)
            hi = t if hi is None else (hi | t)
        else:
            t = f << np.uint32(o - 32)
            hi = t if hi is None else (hi | t)
    cols = []
    for b in range(nb):
        acc = lo if b < 4 else hi
        cols.append(((acc >> np.uint32(8 * (b % 4))) & np.uint32(0xFF)).astype(np.uint8))
    return cols


def _unpack_wide_group(bb, nbits, g, nb):
    """Inverse of :func:`_pack_wide_group`: (n_groups, nb) uint32 byte
    columns -> list of g uint32 field columns."""
    lo = bb[:, 0]
    for b in range(1, min(nb, 4)):
        lo = lo | (bb[:, b] << np.uint32(8 * b))
    hi = None
    for b in range(4, nb):
        t = bb[:, b] << np.uint32(8 * (b - 4))
        hi = t if hi is None else (hi | t)
    mask = np.uint32((1 << nbits) - 1)
    fields = []
    for i in range(g):
        o = i * nbits
        if o + nbits <= 32:
            f = (lo >> np.uint32(o)) & mask
        elif o < 32:
            f = ((lo >> np.uint32(o)) | (hi << np.uint32(32 - o))) & mask
        else:
            f = (hi >> np.uint32(o - 32)) & mask
        fields.append(f)
    return fields


def pack_np(values: np.ndarray, nbits: int) -> np.ndarray:
    """Pack a flat integer array into a flat uint8 byte stream."""
    v = values.reshape(-1)
    if nbits >= 16:
        return np.ascontiguousarray(v).view(np.uint8)
    v = v.astype(np.uint16, copy=False)
    lib = _native_codecs()
    if lib is not None and v.size:
        v = np.ascontiguousarray(v)
        out = np.empty(packed_byte_count(v.size, nbits), np.uint8)
        n = lib.mvs_bitpack(v, v.size, nbits, out)
        if n == out.size:
            return out
    if nbits < 8:
        g, nb = _SUB_BYTE_GROUP[nbits]
        n_pad = -(-v.size // g) * g
        if n_pad != v.size:
            v = np.concatenate([v, np.zeros(n_pad - v.size, np.uint16)])
        m = v.reshape(-1, g).astype(np.uint32)
        if g * nbits > 32:
            return np.stack(_pack_wide_group(m, nbits, g, nb), axis=1).reshape(-1)
        acc = m[:, 0].copy()
        for i in range(1, g):
            acc |= m[:, i] << np.uint32(i * nbits)
        cols = [((acc >> np.uint32(8 * b)) & np.uint32(0xFF)).astype(np.uint8) for b in range(nb)]
        return np.stack(cols, axis=1).reshape(-1)
    lo = (v & np.uint16(0xFF)).astype(np.uint8)
    e = _extra_bits(nbits)
    if e == 0:
        return lo
    per = 8 // e
    hi = (v >> np.uint16(8)).astype(np.uint8)
    n_pad = -(-hi.size // per) * per
    if n_pad != hi.size:
        hi = np.concatenate([hi, np.zeros(n_pad - hi.size, np.uint8)])
    h = hi.reshape(-1, per)
    packed_hi = h[:, 0].copy()
    for i in range(1, per):
        packed_hi |= h[:, i] << np.uint8(i * e)
    return np.concatenate([lo, packed_hi])


def _pack_into(values: np.ndarray, nbits: int, out: np.ndarray) -> None:
    """``pack_np(values, nbits)`` written into ``out``, a C-contiguous uint8
    array of its size (a pinned host buffer: no copy in between)."""
    if nbits < 16:
        v = np.ascontiguousarray(values.reshape(-1).astype(np.uint16, copy=False))
        lib = _native_codecs()
        if lib is not None and v.size and lib.mvs_bitpack(v, v.size, nbits, out) == out.size:
            return
    out[:] = pack_np(values, nbits)


def unpack_np(buf: np.ndarray, nbits: int, count: int, dtype=np.uint16) -> np.ndarray:
    """Inverse of :func:`pack_np`; returns a flat array of ``count`` values."""
    buf = buf.reshape(-1)
    if nbits >= 16:
        return buf.view(np.uint16)[:count].astype(dtype, copy=False)
    lib = _native_codecs()
    if lib is not None and count:
        cbuf = np.ascontiguousarray(buf)
        out = np.empty(count, np.uint16)
        n = lib.mvs_bitunpack(cbuf, cbuf.size, nbits, count, out)
        if n == count:
            return out.view(dtype) if dtype != np.uint16 else out
    if nbits < 8:
        g, nb = _SUB_BYTE_GROUP[nbits]
        bb = buf[: -(-count // g) * nb].reshape(-1, nb).astype(np.uint32)
        if g * nbits > 32:
            fields = np.stack(_unpack_wide_group(bb, nbits, g, nb), axis=1).reshape(-1)[:count]
            return fields.astype(np.uint16).view(dtype)
        acc = bb[:, 0].copy()
        for b in range(1, nb):
            acc |= bb[:, b] << np.uint32(8 * b)
        mask = np.uint32((1 << nbits) - 1)
        fields = np.stack(
            [((acc >> np.uint32(i * nbits)) & mask) for i in range(g)], axis=1
        ).reshape(-1)[:count]
        return fields.astype(np.uint16).view(dtype)
    lo = buf[:count]
    e = _extra_bits(nbits)
    if e == 0:
        return lo.astype(dtype)
    per = 8 // e
    packed_hi = buf[count:]
    mask = np.uint8((1 << e) - 1)
    hi = np.empty((packed_hi.size, per), np.uint8)
    for i in range(per):
        hi[:, i] = (packed_hi >> np.uint8(i * e)) & mask
    hi = hi.reshape(-1)[:count]
    return (lo.astype(np.uint16) | (hi.astype(np.uint16) << np.uint16(8))).astype(
        dtype, copy=False
    )


# ---------------------------------------------------------------------------
# delta transforms, host half
# ---------------------------------------------------------------------------
#
# Rows make reconstruction one segmented cumsum (parallel on host and device)
# instead of one serial chain over the whole stream. First-order: values
# padded (edge mode) to rows of _DELTA_ROW, the first value of each row raw,
# the other R-1 as zigzag-coded wrapped differences. Second order ("delta2"):
# the difference along the array's last axis, then between consecutive true
# rows; third order ("delta3"): then between consecutive planes. The first
# column of every true row travels raw; everything wraps mod 2^16, so
# reconstruction is exact for any uint16 content.

_DELTA_ROW = 2048


def _delta_rows(count: int) -> int:
    return -(-count // _DELTA_ROW)


def delta_byte_count(count: int, nbits_resid: int) -> int:
    """Wire bytes for the delta encoding of ``count`` values."""
    n_rows = _delta_rows(count)
    return 2 * n_rows + packed_byte_count(n_rows * (_DELTA_ROW - 1), nbits_resid)


def delta_encode_np(flat: np.ndarray):
    """uint16 stream -> (firsts, zigzag residuals), both uint16."""
    flat = flat.reshape(-1).astype(np.uint16, copy=False)
    n_rows = _delta_rows(flat.size)
    lib = _native_codecs()
    if lib is not None and flat.size:
        flat_c = np.ascontiguousarray(flat)
        firsts = np.empty(n_rows, np.uint16)
        resid = np.empty(n_rows * (_DELTA_ROW - 1), np.uint16)
        n = lib.mvs_delta_encode(flat_c, flat_c.size, _DELTA_ROW, firsts, resid)
        if n == n_rows:
            return firsts, resid
    pad = n_rows * _DELTA_ROW - flat.size
    m = np.pad(flat, (0, pad), mode="edge").reshape(n_rows, _DELTA_ROW)
    firsts = m[:, 0].copy()
    d = m[:, 1:] - m[:, :-1]  # uint16 wraparound
    di = d.view(np.int16).astype(np.int32)
    z = (((di << 1) ^ (di >> 15)) & 0xFFFF).astype(np.uint16)
    return firsts, z.reshape(-1)


def delta_decode_np(firsts: np.ndarray, resid_z: np.ndarray, count: int):
    """Inverse of :func:`delta_encode_np`."""
    n_rows = firsts.size
    lib = _native_codecs()
    if lib is not None and count:
        firsts_c = np.ascontiguousarray(firsts, dtype=np.uint16)
        resid_c = np.ascontiguousarray(resid_z, dtype=np.uint16)
        out = np.empty(count, np.uint16)
        n = lib.mvs_delta_decode(firsts_c, resid_c, count, _DELTA_ROW, out)
        if n == count:
            return out
    zi = resid_z.reshape(n_rows, _DELTA_ROW - 1).astype(np.int32)
    d = (zi >> 1) ^ -(zi & 1)
    m = np.concatenate([firsts[:, None].astype(np.int32), d], axis=1)
    vals = (np.cumsum(m, axis=1, dtype=np.int64) & 0xFFFF).astype(np.uint16)
    return vals.reshape(-1)[:count]


def delta2_eligible(shape) -> bool:
    """delta2 needs >= 2 true rows and >= 2 columns."""
    if len(shape) < 2:
        return False
    X = int(shape[-1])
    R = 1
    for s in shape[:-1]:
        R *= int(s)
    return X >= 2 and R >= 2


def delta2_byte_count(count: int, X: int, nbits_resid: int) -> int:
    """Wire bytes for the delta2 encoding of ``count`` values in rows of
    ``X``."""
    R = count // X
    return 2 * R + packed_byte_count(R * (X - 1), nbits_resid)


def delta2_encode_np(flat: np.ndarray, X: int):
    """uint16 stream (rows of X) -> (raw first column, zigzag 2nd-order
    residuals)."""
    m = flat.reshape(-1, X).astype(np.uint16, copy=False)
    firsts = m[:, 0].copy()
    d1 = m[:, 1:] - m[:, :-1]  # uint16 wraparound
    r2 = d1.copy()
    r2[1:] -= d1[:-1]
    di = r2.view(np.int16).astype(np.int32)
    z = (((di << 1) ^ (di >> 15)) & 0xFFFF).astype(np.uint16)
    return firsts, z.reshape(-1)


def delta2_decode_np(firsts: np.ndarray, resid_z: np.ndarray, X: int, count: int):
    """Inverse of :func:`delta2_encode_np` (two wraparound cumsums)."""
    R = firsts.size
    zi = resid_z.reshape(R, X - 1).astype(np.int32)
    d = (zi >> 1) ^ -(zi & 1)
    # uint32 cumsum wraps mod 2^32; & 0xFFFF recovers the mod-2^16 value
    d1 = np.cumsum(d.astype(np.uint32), axis=0, dtype=np.uint32)
    m = np.concatenate([firsts[:, None].astype(np.uint32), d1], axis=1)
    vals = (np.cumsum(m, axis=1, dtype=np.uint32) & 0xFFFF).astype(np.uint16)
    return vals.reshape(-1)[:count]


def delta3_eligible(shape) -> bool:
    """delta3 needs a >=3-D layout with >=2 planes, >=2 rows per plane and
    >=2 columns."""
    if len(shape) < 3:
        return False
    X, Y = int(shape[-1]), int(shape[-2])
    Z = 1
    for s in shape[:-2]:
        Z *= int(s)
    return X >= 2 and Y >= 2 and Z >= 2


def delta3_byte_count(count: int, X: int, nbits_resid: int) -> int:
    """Wire bytes for the delta3 encoding (the layout of delta2: R raw
    first-column values + R*(X-1) packed residuals)."""
    return delta2_byte_count(count, X, nbits_resid)


def delta3_encode_np(flat: np.ndarray, X: int, Y: int):
    """uint16 stream (planes of Y rows of X) -> (raw first column, zigzag
    3rd-order residuals: d/dx then d/dy then d/dz)."""
    m = flat.reshape(-1, X).astype(np.uint16, copy=False)
    firsts = m[:, 0].copy()
    d1 = m[:, 1:] - m[:, :-1]  # uint16 wraparound
    r2 = d1.copy()
    r2[1:] -= d1[:-1]
    r3 = r2.copy()
    r3[Y:] -= r2[:-Y]
    di = r3.view(np.int16).astype(np.int32)
    z = (((di << 1) ^ (di >> 15)) & 0xFFFF).astype(np.uint16)
    return firsts, z.reshape(-1)


def delta3_decode_np(firsts: np.ndarray, resid_z: np.ndarray, X: int, Y: int, count: int):
    """Inverse of :func:`delta3_encode_np` (three wraparound cumsums)."""
    R = firsts.size
    zi = resid_z.reshape(R, X - 1).astype(np.int32)
    d = (zi >> 1) ^ -(zi & 1)
    du = d.astype(np.uint32)
    r2 = np.cumsum(du.reshape(-1, Y, X - 1), axis=0, dtype=np.uint32).reshape(R, X - 1)
    d1 = np.cumsum(r2, axis=0, dtype=np.uint32)
    m = np.concatenate([firsts[:, None].astype(np.uint32), d1], axis=1)
    vals = (np.cumsum(m, axis=1, dtype=np.uint32) & 0xFFFF).astype(np.uint16)
    return vals.reshape(-1)[:count]


# sparse residual exceptions: a few large jumps (batch padding seams, hot
# pixels, tile borders) must not force the whole residual width up a tier.
# Residuals above the chosen width travel as (int32 index, uint16 value)
# pairs and are scattered back in before the reconstruction cumsum.
_EXC_BYTES = 6  # int32 index + uint16 true residual


def _exc_capacity(n_exc: int) -> int:
    """Quantized exception-buffer capacity (16, 32, 64, ...)."""
    if n_exc <= 0:
        return 0
    cap = 16
    while cap < n_exc:
        cap *= 2
    return cap


def _choose_delta_width_np(resid: np.ndarray):
    """Pick the cheapest (nbits, exception list) for a residual stream.

    Returns (nbits, exc_idx | None, exc_val | None); the wire cost is
    ``packed_byte_count(resid.size, nbits) + 6 * _exc_capacity(n_exceptions)``.
    """
    if resid.size >= 2**31:  # int32 exception indices
        return nbits_for_max(int(resid.max(initial=0))), None, None
    # one histogram gives every width's exceedance count
    csum = np.cumsum(np.bincount(resid, minlength=1 << 16))
    best = None
    for nb in ALLOWED_NBITS:
        lim = (1 << nb) - 1
        n_exc = int(resid.size - csum[lim]) if nb < 16 else 0
        cost = packed_byte_count(resid.size, nb) + _EXC_BYTES * _exc_capacity(n_exc)
        if best is None or cost < best[0]:
            best = (cost, nb, n_exc)
    _, nb, n_exc = best
    if n_exc == 0:
        return nb, None, None
    idx = np.flatnonzero(resid > ((1 << nb) - 1)).astype(np.int32)
    return nb, idx, resid[idx]


def _pad_exceptions(exc_idx: np.ndarray, exc_val: np.ndarray):
    """Pad exception arrays to their quantized capacity by repeating the
    first pair (the scatter writes the same value twice)."""
    n = exc_idx.size
    cap = _exc_capacity(n)
    if cap != n:
        exc_idx = np.concatenate([exc_idx, np.full(cap - n, exc_idx[0], exc_idx.dtype)])
        exc_val = np.concatenate([exc_val, np.full(cap - n, exc_val[0], exc_val.dtype)])
    return exc_idx, exc_val


# ---------------------------------------------------------------------------
# device half: torch ops on any device
# ---------------------------------------------------------------------------

# dtypes a device does not copy or compute on, moved on their signed twins' bits
_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _i32(t: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values mod 2^16 as int32 in [0, 65535] (the
    reference's ``astype(uint16)``)."""
    if t.dtype in (torch.uint16, torch.int16):
        t = t.view(torch.int16)
    return t.to(torch.int32) & 0xFFFF


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """Values in [0, 65535] (int32 or int64) as ``dtype``: uint16 and int16
    by their 16 bits, anything else by value."""
    dtype = _torch_dtype(dtype)
    if dtype in (torch.uint16, torch.int16):
        y = ((x.to(torch.int32) + 32768) & 0xFFFF) - 32768
        y = y.to(torch.int16)
        return y if dtype == torch.int16 else y.view(torch.uint16)
    return x.to(dtype)


def pack_torch(values: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack a flat integer tensor into a flat uint8 byte stream on its
    device: the bytes of :func:`pack_np`."""
    v = values.reshape(-1)
    if nbits >= 16:
        v = v if v.dtype in (torch.uint16, torch.int16) else _as(_i32(v), torch.int16)
        return v.view(torch.int16).contiguous().view(torch.uint8)
    x = _i32(v)
    if nbits < 8:
        g, nb = _SUB_BYTE_GROUP[nbits]
        if g * nbits > 31:  # the groups of 5 and 7 bits fill 40 and 56 bits
            x = x.to(torch.int64)
        n_pad = -(-x.numel() // g) * g
        if n_pad != x.numel():
            x = torch.cat([x, x.new_zeros(n_pad - x.numel())])
        m = x.reshape(-1, g)
        acc = m[:, 0].clone()
        for i in range(1, g):
            acc |= m[:, i] << (i * nbits)
        cols = [(acc >> (8 * b)) & 0xFF for b in range(nb)]
        return torch.stack(cols, dim=1).reshape(-1).to(torch.uint8)
    lo = (x & 0xFF).to(torch.uint8)
    e = _extra_bits(nbits)
    if e == 0:
        return lo
    per = 8 // e
    hi = x >> 8
    n_pad = -(-hi.numel() // per) * per
    if n_pad != hi.numel():
        hi = torch.cat([hi, hi.new_zeros(n_pad - hi.numel())])
    h = hi.reshape(-1, per)
    packed_hi = h[:, 0].clone()
    for i in range(1, per):
        packed_hi |= h[:, i] << (i * e)
    return torch.cat([lo, (packed_hi & 0xFF).to(torch.uint8)])


def _unpack_i32(buf: torch.Tensor, nbits: int, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_torch`: ``count`` values as int32 in
    [0, 65535]."""
    buf = buf.reshape(-1)
    if nbits >= 16:
        return buf[: 2 * count].contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    if nbits < 8:
        g, nb = _SUB_BYTE_GROUP[nbits]
        acc_dtype = torch.int64 if g * nbits > 31 else torch.int32
        bb = buf[: -(-count // g) * nb].reshape(-1, nb).to(acc_dtype)
        acc = bb[:, 0].clone()
        for b in range(1, nb):
            acc |= bb[:, b] << (8 * b)
        mask = (1 << nbits) - 1
        fields = torch.stack([(acc >> (i * nbits)) & mask for i in range(g)], dim=1)
        return fields.reshape(-1)[:count].to(torch.int32)
    lo = buf[:count].to(torch.int32)
    e = _extra_bits(nbits)
    if e == 0:
        return lo
    per = 8 // e
    packed_hi = buf[count:].to(torch.int32)
    mask = (1 << e) - 1
    hi = torch.stack([(packed_hi >> (i * e)) & mask for i in range(per)], dim=1)
    return lo | (hi.reshape(-1)[:count] << 8)


def unpack_torch(buf: torch.Tensor, nbits: int, count: int, dtype=torch.uint16) -> torch.Tensor:
    """Inverse of :func:`pack_torch` on the buffer's device (flat output of
    ``count`` values in ``dtype``)."""
    return _as(_unpack_i32(buf, nbits, count), dtype)


def _zigzag(d: torch.Tensor) -> torch.Tensor:
    """int32 differences, wrapped to int16, as zigzag codes in [0, 65535]."""
    d = ((d + 32768) & 0xFFFF) - 32768
    return ((d << 1) ^ (d >> 15)) & 0xFFFF


def _unzigzag(z: torch.Tensor) -> torch.Tensor:
    return (z >> 1) ^ -(z & 1)


def _encode(x: torch.Tensor, mode: str, X: int = 0, Y: int = 0):
    """(firsts, zigzag residuals), both int32, of the int32 values ``x`` in
    ``mode`` ("delta", "delta2" or "delta3"). Differences are taken in
    int32 without wrapping; the zigzag wraps them to 16 bits, which gives
    the reference's mod-2^16 residuals."""
    if mode == "delta":
        n_rows = _delta_rows(x.numel())
        pad = n_rows * _DELTA_ROW - x.numel()
        if pad:
            x = torch.cat([x, x[-1:].expand(pad)])
        m = x.reshape(n_rows, _DELTA_ROW)
        return m[:, 0], _zigzag(m[:, 1:] - m[:, :-1]).reshape(-1)
    m = x.reshape(-1, X)
    d1 = m[:, 1:] - m[:, :-1]
    r = d1.clone()
    r[1:] -= d1[:-1]
    if mode == "delta3":
        r2 = r
        r = r2.clone()
        r[Y:] -= r2[:-Y]
    return m[:, 0], _zigzag(r).reshape(-1)


def _cumsum_outer(d: torch.Tensor) -> torch.Tensor:
    """cumsum along dim 0 of a 2-D int64 tensor, as one flat scan of its
    transpose less each column's running total before it. A scan along an
    outer dim with few columns (63 for rows of 64) runs nearly serially on a
    CUDA device (27 ms for one 8 MB batch on an H100); a flat scan is one
    parallel pass. Exact: int64 sums of 16-bit values do not overflow."""
    n, w = d.shape
    c = torch.cumsum(d.t().reshape(-1), dim=0).reshape(w, n)
    before = torch.cat([c.new_zeros(1), c[:-1, -1]])
    return (c - before[:, None]).t()


def _decode(firsts: torch.Tensor, z: torch.Tensor, mode: str, count: int, X: int = 0,
            Y: int = 0) -> torch.Tensor:
    """Inverse of :func:`_encode`: int64 values in [0, 65535]. The cumsums
    run in int64 and are masked to 16 bits, which gives the low 16 bits of
    the reference's wrapping uint32 cumsums on every device."""
    R = firsts.numel()
    width = (_DELTA_ROW if mode == "delta" else X) - 1
    d = _unzigzag(z.reshape(R, width)).to(torch.int64)
    if mode == "delta3":
        # along the planes: each (row in plane, column) is a column
        d = _cumsum_outer(d.reshape(-1, Y * width)).reshape(R, width) & 0xFFFF
    if mode in ("delta2", "delta3"):
        d = _cumsum_outer(d) & 0xFFFF
    m = torch.cat([firsts.to(torch.int64)[:, None], d], dim=1)
    return (torch.cumsum(m, dim=1) & 0xFFFF).reshape(-1)[:count]


def delta_encode_torch(flat: torch.Tensor):
    """Device-side :func:`delta_encode_np` (the same wire values, uint16)."""
    firsts, z = _encode(_i32(flat.reshape(-1)), "delta")
    return _as(firsts, torch.uint16), _as(z, torch.uint16)


def delta_decode_torch(firsts: torch.Tensor, resid_z: torch.Tensor, count: int):
    """Device-side inverse of the delta transform (uint16)."""
    return _as(_decode(_i32(firsts), _i32(resid_z), "delta", count), torch.uint16)


def delta2_encode_torch(flat: torch.Tensor, X: int):
    """Device-side :func:`delta2_encode_np` (the same wire values, uint16)."""
    firsts, z = _encode(_i32(flat.reshape(-1)), "delta2", X)
    return _as(firsts, torch.uint16), _as(z, torch.uint16)


def delta2_decode_torch(firsts: torch.Tensor, resid_z: torch.Tensor, X: int, count: int):
    """Device-side inverse of the delta2 transform (uint16)."""
    return _as(_decode(_i32(firsts), _i32(resid_z), "delta2", count, X), torch.uint16)


def delta3_encode_torch(flat: torch.Tensor, X: int, Y: int):
    """Device-side :func:`delta3_encode_np` (the same wire values, uint16)."""
    firsts, z = _encode(_i32(flat.reshape(-1)), "delta3", X, Y)
    return _as(firsts, torch.uint16), _as(z, torch.uint16)


def delta3_decode_torch(firsts: torch.Tensor, resid_z: torch.Tensor, X: int, Y: int,
                        count: int):
    """Device-side inverse of the delta3 transform (uint16)."""
    return _as(_decode(_i32(firsts), _i32(resid_z), "delta3", count, X, Y), torch.uint16)


def _over_counts(z: torch.Tensor) -> list:
    """[max code, #codes over each sub-16 width's limit] as 0-d tensors."""
    return [z.max().to(torch.int64)] + [(z > (1 << nb) - 1).sum() for nb in _SUB16]


def _delta_probe(flat: torch.Tensor) -> torch.Tensor:
    """(plain max, resid max, #resid over each sub-16 width limit) on the
    device: what the host needs to choose the residual width and exception
    capacity, in one small fetch. Counts follow ``_SUB16``'s order."""
    x = _i32(flat.reshape(-1))
    return torch.stack([x.max().to(torch.int64)] + _over_counts(_encode(x, "delta")[1]))


def _delta_probe_both(flat: torch.Tensor, X: int) -> torch.Tensor:
    """:func:`_delta_probe` followed by the delta2 residuals' (max, counts)."""
    x = _i32(flat.reshape(-1))
    return torch.cat([_delta_probe(flat), torch.stack(_over_counts(_encode(x, "delta2", X)[1]))])


def _delta_probe_all(flat: torch.Tensor, X: int, Y: int) -> torch.Tensor:
    """:func:`_delta_probe_both` followed by the delta3 residuals' (max,
    counts)."""
    x = _i32(flat.reshape(-1))
    return torch.cat([_delta_probe_both(flat, X),
                      torch.stack(_over_counts(_encode(x, "delta3", X, Y)[1]))])


def _compact_exceptions(resid: torch.Tensor, nbits: int, E: int):
    """(resid with its out-of-width codes zeroed, (E,) int32 indices, (E,)
    int32 raw codes): a scatter compaction of the codes above ``nbits``
    bits on the device; ``E`` must be at least their count (the host knows
    it from the probe). Unused slots hold index 0 with the RAW code 0, so
    the host's last-write-wins scatter writes code 0's true value again,
    also when code 0 is itself an exception (initialising them with the
    zeroed code corrupts row 0 then)."""
    mask = resid > (1 << nbits) - 1
    pos = torch.cumsum(mask, dim=0) - 1
    slot = torch.where(mask & (pos < E), pos, torch.full_like(pos, E))  # E: a trash slot
    idx = torch.zeros(E + 1, dtype=torch.int32, device=resid.device).scatter_(
        0, slot, torch.arange(resid.numel(), dtype=torch.int32, device=resid.device))
    val = resid[:1].repeat(E + 1).scatter_(0, slot, resid)
    return torch.where(mask, torch.zeros_like(resid), resid), idx[:E], val[:E]


def _pack_bands(resid: torch.Tensor, nbits: int, counts) -> list:
    """Pack consecutive bands of ``counts`` values of a flat tensor, each
    into a byte stream of its own (a slice of one packed stream would mix
    the low and high planes of neighbouring bands)."""
    parts, o = [], 0
    for c in counts:
        parts.append(pack_torch(resid[o:o + c], nbits))
        o += c
    return parts


def _assemble(parts, nbits, counts, mode, count, X, Y, shape, dtype, firsts=None, exc_idx=None,
              exc_val=None) -> torch.Tensor:
    """Unpack uploaded bands and rebuild the array on their device."""
    vals = torch.cat([_unpack_i32(p, nbits, c) for p, c in zip(parts, counts)])
    if mode != "plain":
        if exc_idx is not None:
            vals.index_put_((exc_idx.to(torch.int64),), _i32(exc_val))
        vals = _decode(_i32(firsts), vals, mode, count, X, Y)
    return _as(vals, dtype).reshape(tuple(shape))


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------


def _split_bounds(n: int, parts: int) -> np.ndarray:
    return np.linspace(0, n, parts + 1).astype(np.int64)


# bytes a band carries at least before a transfer takes more bands, and the
# size under which a transfer is not packed
_STREAM_MIN_BYTES = 1 << 20
_MIN_PACK_SIZE = 1 << 20


def _stream_bounds(count: int, n_streams: int, grain: int) -> np.ndarray:
    bounds = _split_bounds(-(-count // grain), n_streams) * grain
    bounds[-1] = count
    return np.unique(bounds)


def _wire_bytes(mode: str, count: int, X: int, nbits: int) -> int:
    """Wire bytes of ``count`` values in ``mode`` at ``nbits``, exceptions
    aside."""
    if mode == "plain":
        return packed_byte_count(count, nbits)
    if mode == "delta":
        return delta_byte_count(count, nbits)
    return delta2_byte_count(count, X, nbits)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (unsigned 16-64 bit arrays on their
    signed twins' bits)."""
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a)
    twin = _SIGNED_TWIN.get(t.dtype)
    if twin is None:
        return t.to(device, copy=True)
    return t.view(twin).to(device, copy=True).view(t.dtype)


def _to_host(tensors, device: torch.device) -> list:
    """(numpy array, event or None) for each tensor: on a CUDA device a
    pinned host copy made on a copy stream after the caller's stream, with
    the event to wait for before reading it; on the CPU the tensor's own
    memory."""
    if device.type != "cuda":
        return [(t.numpy(), None) for t in tensors]
    current = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    copy.wait_stream(current)
    out = []
    with torch.cuda.stream(copy):
        for t in tensors:
            src = t.view(_SIGNED_TWIN.get(t.dtype, t.dtype))
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            t.record_stream(copy)
            ev = torch.cuda.Event()
            ev.record(copy)
            out.append((host.numpy().view(_numpy_dtype(t.dtype)), ev))
    return out


def _landed(pair) -> np.ndarray:
    arr, ev = pair
    if ev is not None:
        ev.synchronize()
    return arr


def _upload_bands(send: np.ndarray, bounds, nbits: int, device: torch.device) -> list:
    """Pack each band of ``send`` on a host thread straight into a host
    buffer (pinned on a CUDA device) and copy it to the device on a copy
    stream; the caller's stream waits for the copies."""
    n = len(bounds) - 1
    sizes = [packed_byte_count(int(bounds[i + 1] - bounds[i]), nbits) for i in range(n)]
    cuda = device.type == "cuda"
    parts = [None] * n
    if cuda:
        current = torch.cuda.current_stream(device)
        parts = [torch.empty(s, dtype=torch.uint8, device=device) for s in sizes]
        copy = torch.cuda.Stream(device)
        copy.wait_stream(current)

    def pack_part(i):
        host = torch.empty(sizes[i], dtype=torch.uint8, pin_memory=cuda)
        _pack_into(send[int(bounds[i]):int(bounds[i + 1])], nbits, host.numpy())
        if not cuda:
            parts[i] = host
            return
        with torch.cuda.stream(copy):
            parts[i].copy_(host, non_blocking=True)

    with ThreadPoolExecutor(n) as ex:
        list(ex.map(pack_part, range(n)))
    if cuda:
        current.wait_stream(copy)
    return parts


def put_packed(
    arr: np.ndarray,
    nbits: int = None,
    n_streams: int = None,
    delta: bool = None,
    info: dict = None,
    keep_packed: dict = None,
    device=None,
) -> torch.Tensor:
    """Host -> device transfer of an integer array as packed parallel bands.

    Packs on host threads (one band each), copies the bands to ``device``
    (the CUDA device unless the caller names another), and unpacks and
    reshapes there. A dtype that does not pack, or an array under 1 MiB,
    is copied as it is.

    ``delta`` (default :data:`DELTA`) also tries the delta transforms
    (:data:`DELTA2` and :data:`DELTA3` allowing) and sends whichever
    representation packs smallest. ``info`` (optional dict) receives the
    choice: ``{"nbits", "delta", "mode", "bytes"}``, ``bytes`` being the
    bytes on the wire.

    ``keep_packed`` (optional dict) receives the uploaded PACKED device
    buffers and the assembly metadata, enough for :func:`reassemble_packed`
    to rebuild the array on the device with no further transfer (the
    reference's record, key for key). Left empty when the array was copied
    as it is.
    """
    from multiview_stitcher_torch.utils import misc

    device = misc.resolve_device(device)
    arr = np.asarray(arr)
    if n_streams is None:
        n_streams = STREAMS
    if delta is None:
        delta = DELTA
    if not is_packable(arr.dtype) or arr.size * arr.dtype.itemsize < _MIN_PACK_SIZE:
        if info is not None:
            info.update(nbits=None, delta=False, bytes=arr.nbytes)
        return _to_device(arr, device)
    if nbits is None:
        nbits = nbits_for_max(int(arr.max(initial=0)))
        if np.issubdtype(arr.dtype, np.signedinteger) and int(arr.min(initial=0)) < 0:
            nbits = 16
    count = arr.size
    flat = arr.reshape(-1)
    X2 = int(arr.shape[-1]) if arr.ndim else 0
    Y2 = int(arr.shape[-2]) if arr.ndim >= 2 else 0

    # the cheapest representation, exceptions at the padded capacity shipped;
    # a candidate replaces the best so far only when strictly cheaper. Delta
    # transforms only for uint16 (the wraparound is the unsigned container's)
    mode, nbits_send, cost = "plain", nbits, packed_byte_count(count, nbits)
    firsts = resid = exc_idx = exc_val = None
    if delta and arr.dtype == np.uint16:
        for m, wanted, encode in (
            ("delta", True, lambda: delta_encode_np(flat)),
            ("delta2", DELTA2 and delta2_eligible(arr.shape), lambda: delta2_encode_np(flat, X2)),
            ("delta3", DELTA3 and delta3_eligible(arr.shape),
             lambda: delta3_encode_np(flat, X2, Y2)),
        ):
            if not wanted:
                continue
            f, r = encode()
            nb, ei, ev = _choose_delta_width_np(r)
            c = _wire_bytes(m, count, X2, nb) + _EXC_BYTES * _exc_capacity(
                0 if ei is None else ei.size)
            if c < cost:
                mode, nbits_send, cost = m, nb, c
                firsts, resid, exc_idx, exc_val = f, r, ei, ev
        if exc_idx is not None:
            # out-of-width residuals travel as zeros in the packed stream
            # (their high bits would spill into the neighbouring fields);
            # the exception scatter restores them on the device
            resid[exc_idx] = 0
    any_delta = mode != "plain"
    send = resid if any_delta else flat
    if info is not None:
        info.update(nbits=nbits_send, delta=any_delta, mode=mode, bytes=cost)

    count_send = send.size
    n_streams = max(1, min(n_streams, count_send * 2 // _STREAM_MIN_BYTES))
    # band boundaries on the high-bit packing granularity
    grain = 8 if nbits_send < 16 else 1
    bounds = _stream_bounds(count_send, n_streams, grain)
    n_streams = len(bounds) - 1
    parts = _upload_bands(send, bounds, nbits_send, device)

    rec = {
        "mode": mode,
        "parts": parts,
        "nbits": nbits_send,
        "counts": tuple(int(bounds[i + 1] - bounds[i]) for i in range(n_streams)),
        "count": count,
        "X": X2,
        "Y": Y2,
        "shape": arr.shape,
        "dtype": np.dtype(arr.dtype).name,
        "firsts": None,
        "exc_idx": None,
        "exc_val": None,
    }
    if any_delta:
        rec["firsts"] = _to_device(firsts, device)
        if exc_idx is not None:
            pidx, pval = _pad_exceptions(exc_idx, exc_val)
            rec["exc_idx"] = _to_device(pidx, device)
            rec["exc_val"] = _to_device(pval, device)
    rec["packed_bytes"] = sum(int(p.numel()) for p in parts) + sum(
        int(rec[k].numel() * rec[k].element_size())
        for k in ("firsts", "exc_idx", "exc_val")
        if rec[k] is not None
    )
    if keep_packed is not None:
        keep_packed.update(rec)
    return reassemble_packed(rec)


def reassemble_packed(rec: dict) -> torch.Tensor:
    """Rebuild the unpacked array on the device from a ``keep_packed``
    record (its ``parts``' device): device work only, no transfer. Takes
    the reference's records too, with their arrays as tensors."""
    return _assemble(
        rec["parts"], rec["nbits"], rec["counts"], rec["mode"], rec["count"], rec["X"],
        rec["Y"], rec["shape"], rec["dtype"], rec["firsts"], rec["exc_idx"], rec["exc_val"],
    )


def _best_width(counts_over: dict, cost_of) -> tuple:
    """(cost, nbits, n_exc) of the cheapest width, exceptions at their
    padded capacity; ``counts_over`` maps each width to its exceedances."""
    best = None
    for nb in ALLOWED_NBITS:
        ne = counts_over[nb]
        cost = cost_of(nb) + _EXC_BYTES * _exc_capacity(ne)
        if best is None or cost < best[0]:
            best = (cost, nb, ne)
    return best


def fetch_packed(
    arr: torch.Tensor,
    out: np.ndarray = None,
    nbits: int = None,
    n_streams: int = None,
    delta: bool = None,
    info: dict = None,
) -> np.ndarray:
    """Device -> host transfer of an integer tensor as packed parallel bands.

    Packs on the tensor's device, copies the byte bands to the host
    concurrently and unpacks each band on a host thread as it lands.
    ``out`` (optional) receives the result in place (C-contiguous, of the
    tensor's shape and dtype). ``nbits`` defaults to the maximum, found on
    the device (one small fetch).

    ``delta`` (default :data:`DELTA`) probes the residuals on the device
    (one small fetch, the delta2 and delta3 candidates too where
    :data:`DELTA2` / :data:`DELTA3` and the shape allow) and ships a delta
    transform where it packs smaller. ``info`` receives the choice.
    """
    dtype = _numpy_dtype(arr.dtype)
    device = arr.device
    if n_streams is None:
        n_streams = STREAMS
    if delta is None:
        delta = DELTA
    if info is not None:
        info.update(nbits=None, delta=False, bytes=arr.numel() * dtype.itemsize)
    if arr.numel() * dtype.itemsize < _MIN_PACK_SIZE:
        res = _landed(_to_host([arr.contiguous()], device)[0])
        if out is not None:
            out[...] = res
            return out
        return res if device.type == "cuda" else res.copy()
    if not is_packable(dtype):
        if out is None:
            out = np.empty(tuple(arr.shape), dtype=dtype)
        _fetch_bands_raw(arr, out, n_streams)
        return out

    count = arr.numel()
    flat = arr.reshape(-1)
    X2 = int(arr.shape[-1]) if arr.dim() else 0
    Y2 = int(arr.shape[-2]) if arr.dim() >= 2 else 0
    mode, nbits_send, n_exc = "plain", nbits, 0
    if delta and dtype == np.uint16:
        try_d2 = DELTA2 and delta2_eligible(arr.shape)
        try_d3 = try_d2 and DELTA3 and delta3_eligible(arr.shape)
        if try_d3:
            probe = _delta_probe_all(flat, X2, Y2)
        elif try_d2:
            probe = _delta_probe_both(flat, X2)
        else:
            probe = _delta_probe(flat)
        probe = [int(v) for v in probe.cpu().tolist()]
        if nbits is None:
            nbits = nbits_for_max(probe[0])
        # a candidate replaces the best so far only when strictly cheaper
        cost, nbits_send = packed_byte_count(count, nbits), nbits
        # the probe: plain max, then per candidate its max code and its
        # counts over each sub-16 width
        k = len(_SUB16)
        candidates = [("delta", 2), ("delta2", 3 + k), ("delta3", 4 + 2 * k)]
        for m, at in candidates[:1 + try_d2 + try_d3]:
            counts_over = {**dict(zip(_SUB16, probe[at:at + k])), 16: 0}
            c, nb, ne = _best_width(counts_over, lambda nb: _wire_bytes(m, count, X2, nb))
            if c < cost:
                mode, nbits_send, n_exc, cost = m, nb, ne, c
    elif nbits is None:
        nbits = nbits_for_max(int(_i32(flat).max()) if dtype == np.uint16 else int(flat.max()))
        if np.issubdtype(dtype, np.signedinteger) and int(flat.min()) < 0:
            nbits = 16
        nbits_send = nbits
    any_delta = mode != "plain"
    if nbits_send >= 16 and not any_delta:
        if out is None:
            out = np.empty(tuple(arr.shape), dtype=dtype)
        _fetch_bands_raw(arr, out, n_streams)
        return out

    if mode in ("delta2", "delta3"):
        count_send = (count // X2) * (X2 - 1)
    elif mode == "delta":
        count_send = _delta_rows(count) * (_DELTA_ROW - 1)
    else:
        count_send = count
    n_streams = max(1, min(n_streams, count_send * 2 // _STREAM_MIN_BYTES))
    bounds = _stream_bounds(count_send, n_streams, 8)
    n_streams = len(bounds) - 1
    part_counts = tuple(int(bounds[i + 1] - bounds[i]) for i in range(n_streams))
    if info is not None:
        info.update(nbits=nbits_send, delta=any_delta, mode=mode,
                    bytes=_wire_bytes(mode, count, X2, nbits_send)
                    + _EXC_BYTES * _exc_capacity(n_exc))

    if out is None:
        out = np.empty(tuple(arr.shape), dtype=dtype)
    flat_out = out.reshape(-1)

    if not any_delta:
        landing = _to_host(_pack_bands(flat, nbits_send, part_counts), device)

        def fetch_part(i):
            v0, v1 = int(bounds[i]), int(bounds[i + 1])
            flat_out[v0:v1] = unpack_np(_landed(landing[i]), nbits_send, v1 - v0, dtype)

        with ThreadPoolExecutor(n_streams) as ex:
            list(ex.map(fetch_part, range(n_streams)))
        return out

    firsts, resid = _encode(_i32(flat), mode, X2, Y2)
    extra = [firsts]
    if n_exc > 0:
        resid, exc_idx, exc_val = _compact_exceptions(resid, nbits_send, _exc_capacity(n_exc))
        extra += [exc_idx, exc_val]
    landing = _to_host(_pack_bands(resid, nbits_send, part_counts) + extra, device)
    host_resid = np.empty(count_send, np.uint16)

    def fetch_resid(i):
        v0, v1 = int(bounds[i]), int(bounds[i + 1])
        host_resid[v0:v1] = unpack_np(_landed(landing[i]), nbits_send, v1 - v0, np.uint16)

    with ThreadPoolExecutor(n_streams) as ex:
        list(ex.map(fetch_resid, range(n_streams)))
    firsts = _landed(landing[n_streams]).astype(np.uint16)
    if n_exc > 0:
        idx = _landed(landing[n_streams + 1])
        # restore the out-of-width residuals before the cumsum
        host_resid[idx] = _landed(landing[n_streams + 2]).astype(np.uint16)
    flat_out[:] = (
        delta3_decode_np(firsts, host_resid, X2, Y2, count) if mode == "delta3"
        else delta2_decode_np(firsts, host_resid, X2, count) if mode == "delta2"
        else delta_decode_np(firsts, host_resid, count)
    )
    return out


def _fetch_bands_raw(arr: torch.Tensor, out: np.ndarray, n_streams: int = None):
    """Parallel banded fetch without packing (for 16-bit-entropy data and
    dtypes that do not pack)."""
    flat = arr.reshape(-1)
    flat_out = out.reshape(-1)
    if n_streams is None:
        n_streams = STREAMS
    n_streams = max(1, min(n_streams, arr.numel() * out.itemsize // _STREAM_MIN_BYTES))
    bounds = _split_bounds(arr.numel(), n_streams)
    landing = _to_host([flat[int(bounds[i]):int(bounds[i + 1])] for i in range(n_streams)],
                       arr.device)

    def fetch(i):
        flat_out[int(bounds[i]):int(bounds[i + 1])] = _landed(landing[i])

    with ThreadPoolExecutor(n_streams) as ex:
        list(ex.map(fetch, range(n_streams)))
    return out
