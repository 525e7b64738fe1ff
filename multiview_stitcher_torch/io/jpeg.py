"""First-party baseline JPEG (ITU T.81) decoder for CZI subblocks.

The port of ``multiview_stitcher_tpu.io.jpeg``, numpy on the host as there.
Baseline sequential DCT JPEG (SOF0, the variant Zeiss writers emit for
compression id 1) is decoded with numpy: marker parse -> entropy-decode MCUs
(Huffman, DC prediction, AC run-length) -> dequantize -> 8x8 IDCT
(vectorized over all blocks) -> chroma upsample -> YCbCr->RGB when 3
components. Grayscale and YCbCr, 8-bit precision, restart markers
supported; progressive (SOF2) and arithmetic coding are not (they raise).

The hot loop is the bit-serial Huffman scan: decoded with a table-driven
reader over a numpy bit-unpacked stream — adequate for microscopy
subblocks (typically <= a few MB); everything after entropy decode is
vectorized numpy + one batched scipy IDCT.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])


class _Huff:
    """Canonical Huffman table as a (code -> (length, value)) fast map."""

    def __init__(self, counts: List[int], symbols: bytes):
        self.lookup: Dict[Tuple[int, int], int] = {}
        code = 0
        k = 0
        self.max_len = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lookup[(length, code)] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        for length in range(16, 0, -1):
            if counts[length - 1]:
                self.max_len = max(self.max_len, length)


class _BitReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00 unstuffing
    and restart-marker awareness."""

    def __init__(self, data: bytes):
        # unstuff: 0xFF 0x00 -> 0xFF; record restart-marker positions
        out = bytearray()
        self.restarts = []  # byte offsets (in unstuffed stream) of RSTn
        i, n = 0, len(data)
        while i < n:
            b = data[i]
            if b == 0xFF:
                if i + 1 < n and data[i + 1] == 0x00:
                    out.append(0xFF)
                    i += 2
                    continue
                if i + 1 < n and 0xD0 <= data[i + 1] <= 0xD7:
                    self.restarts.append(len(out))
                    i += 2
                    continue
                break  # next marker: end of scan
            out.append(b)
            i += 1
        self.bits = np.unpackbits(np.frombuffer(bytes(out), np.uint8))
        self.pos = 0
        self._restart_bitpos = [r * 8 for r in self.restarts]
        self._next_restart = 0

    def read_bit(self) -> int:
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        v = 0
        p = self.pos
        bits = self.bits
        for i in range(n):
            v = (v << 1) | int(bits[p + i])
        self.pos = p + n
        return v

    def sync_restart(self):
        """Advance to the next restart boundary (byte-aligned)."""
        if self._next_restart < len(self._restart_bitpos):
            self.pos = self._restart_bitpos[self._next_restart]
            self._next_restart += 1

    def decode_symbol(self, table: _Huff) -> int:
        code = 0
        length = 0
        bits = self.bits
        p = self.pos
        lookup = table.lookup
        for length in range(1, table.max_len + 1):
            code = (code << 1) | int(bits[p])
            p += 1
            sym = lookup.get((length, code))
            if sym is not None:
                self.pos = p
                return sym
        raise ValueError("invalid JPEG Huffman code")


def _extend(v: int, n: int) -> int:
    """JPEG signed magnitude extension (T.81 F.2.2.1)."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def _idct8x8(blocks: np.ndarray) -> np.ndarray:
    """Batched 2D type-III DCT (inverse of the JPEG forward DCT)."""
    from scipy.fft import idctn

    return idctn(blocks, axes=(-2, -1), norm="ortho")


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG byte stream to (H, W) or (H, W, 3) uint8."""
    i = 0
    qt: Dict[int, np.ndarray] = {}
    huff_dc: Dict[int, _Huff] = {}
    huff_ac: Dict[int, _Huff] = {}
    frame = None
    restart_interval = 0

    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (missing SOI)")
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        i += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seg_len,) = struct.unpack(">H", data[i : i + 2])
        seg = data[i + 2 : i + seg_len]
        if marker == 0xDB:  # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 0xF
                j += 1
                if pq == 0:
                    tbl = np.frombuffer(seg[j : j + 64], np.uint8).astype(
                        np.int32
                    )
                    j += 64
                else:
                    tbl = np.frombuffer(
                        seg[j : j + 128], ">u2"
                    ).astype(np.int32)
                    j += 128
                qt[tq] = tbl
        elif marker == 0xC4:  # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 0xF
                j += 1
                counts = list(seg[j : j + 16])
                j += 16
                nsym = sum(counts)
                symbols = seg[j : j + nsym]
                j += nsym
                (huff_dc if tc == 0 else huff_ac)[th] = _Huff(
                    counts, symbols
                )
        elif marker == 0xC0:  # SOF0 baseline
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise NotImplementedError(
                    f"JPEG precision {prec} (baseline is 8-bit)"
                )
            comps = []
            for c in range(nc):
                cid, sampling, tq = struct.unpack(
                    ">BBB", seg[6 + 3 * c : 9 + 3 * c]
                )
                comps.append(
                    {"id": cid, "h": sampling >> 4, "v": sampling & 0xF,
                     "tq": tq}
                )
            frame = {"H": H, "W": W, "comps": comps}
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise NotImplementedError(
                f"JPEG SOF{marker - 0xC0}: only baseline sequential "
                "(SOF0) is supported"
            )
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scan = []
            for c in range(ns):
                cs, tables = seg[1 + 2 * c], seg[2 + 2 * c]
                scan.append({"cs": cs, "dc": tables >> 4, "ac": tables & 0xF})
            ecs_start = i + seg_len
            return _decode_scan(
                data[ecs_start:], frame, scan, qt, huff_dc, huff_ac,
                restart_interval,
            )
        i += seg_len
    raise ValueError("no scan data found in JPEG stream")


def _decode_scan(ecs, frame, scan, qt, huff_dc, huff_ac, restart_interval):
    H, W, comps = frame["H"], frame["W"], frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-W // (8 * hmax))
    mcuy = -(-H // (8 * vmax))

    reader = _BitReader(ecs)
    by_id = {c["id"]: c for c in comps}
    # coefficient planes per component (in 8x8 block units)
    planes = {}
    for c in comps:
        bw = mcux * c["h"]
        bh = mcuy * c["v"]
        planes[c["id"]] = np.zeros((bh * bw, 64), np.int32)
    pred = {c["id"]: 0 for c in comps}

    n_mcu = mcux * mcuy
    for m in range(n_mcu):
        if restart_interval and m and m % restart_interval == 0:
            reader.sync_restart()
            for k in pred:
                pred[k] = 0
        my, mx = divmod(m, mcux)
        for s in scan:
            c = by_id[s["cs"]]
            dct = huff_dc[s["dc"]]
            act = huff_ac[s["ac"]]
            bw = mcux * c["h"]
            for vy in range(c["v"]):
                for vx in range(c["h"]):
                    coeffs = np.zeros(64, np.int32)
                    t = reader.decode_symbol(dct)
                    diff = _extend(reader.read_bits(t), t)
                    pred[c["id"]] += diff
                    coeffs[0] = pred[c["id"]]
                    k = 1
                    while k < 64:
                        rs = reader.decode_symbol(act)
                        r, size = rs >> 4, rs & 0xF
                        if size == 0:
                            if r == 15:
                                k += 16
                                continue
                            break  # EOB
                        k += r
                        coeffs[k] = _extend(reader.read_bits(size), size)
                        k += 1
                    bi = (my * c["v"] + vy) * bw + (mx * c["h"] + vx)
                    planes[c["id"]][bi] = coeffs

    # dequantize + dezigzag + batched IDCT + assemble per component
    out_comps = []
    for c in comps:
        bw = mcux * c["h"]
        bh = mcuy * c["v"]
        coefs = planes[c["id"]] * qt[c["tq"]][None, :]
        blocks = np.zeros((bh * bw, 64), np.float64)
        blocks[:, ZIGZAG] = coefs
        pix = _idct8x8(blocks.reshape(-1, 8, 8)) + 128.0
        img = (
            pix.reshape(bh, bw, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(bh * 8, bw * 8)
        )
        # upsample subsampled chroma to full MCU resolution with libjpeg's
        # "fancy" (triangle) filter: out[2i] = (3*in[i] + in[i-1]) / 4,
        # out[2i+1] = (3*in[i] + in[i+1]) / 4, edges clamped
        ry, rx = vmax // c["v"], hmax // c["h"]
        for r in (ry, rx):
            if r & (r - 1):
                raise NotImplementedError(
                    f"JPEG sampling ratio {r} (only power-of-2 chroma "
                    "subsampling is supported)"
                )
        for axis, r in ((0, ry), (1, rx)):
            while r > 1:
                prev = np.roll(img, 1, axis=axis)
                nxt = np.roll(img, -1, axis=axis)
                edge = [slice(None)] * img.ndim
                edge[axis] = 0
                prev[tuple(edge)] = img[tuple(edge)]
                edge[axis] = -1
                nxt[tuple(edge)] = img[tuple(edge)]
                lo = (3.0 * img + prev) / 4.0
                hi = (3.0 * img + nxt) / 4.0
                img = np.stack([lo, hi], axis=axis + 1).reshape(
                    tuple(
                        s * 2 if d == axis else s
                        for d, s in enumerate(img.shape)
                    )
                )
                r //= 2
        out_comps.append(img[:H, :W])

    if len(out_comps) == 1:
        return np.clip(np.round(out_comps[0]), 0, 255).astype(np.uint8)
    if len(out_comps) == 3:
        y, cb, cr = out_comps
        r = y + 1.402 * (cr - 128.0)
        g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
        b = y + 1.772 * (cb - 128.0)
        rgb = np.stack([r, g, b], axis=-1)
        return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    raise NotImplementedError(
        f"JPEG with {len(out_comps)} components"
    )
