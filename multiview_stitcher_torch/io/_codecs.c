/* Native TIFF decoders (PackBits, TIFF LZW and predictor 2) and the link
 * codec's host half (ops/link_codec.py: bit packing and the row delta).
 *
 * Built at first use by io/codecs.py (cc -O2 -shared -fPIC) into the
 * package's _build/ directory and called through ctypes, which releases the
 * GIL for each call; io/codecs.py keeps pure-Python versions of the same
 * decoders as the plain versions, taken where no C compiler exists.
 *
 * The decoders return the number of bytes written to dst, or -1 on
 * malformed input or when the output would exceed cap.
 */

#include <stdint.h>
#include <string.h>

long mvs_packbits_decode(const uint8_t *src, long n, uint8_t *dst, long cap)
{
    long i = 0, o = 0;
    while (i < n) {
        int8_t h = (int8_t)src[i++];
        if (h >= 0) {
            long cnt = (long)h + 1;
            if (i + cnt > n || o + cnt > cap)
                return -1;
            memcpy(dst + o, src + i, (size_t)cnt);
            i += cnt;
            o += cnt;
        } else if (h != -128) { /* -128 is a no-op per spec */
            long cnt = 1 - (long)h;
            if (i >= n || o + cnt > cap)
                return -1;
            memset(dst + o, src[i++], (size_t)cnt);
            o += cnt;
        }
    }
    return o;
}

/* TIFF variant of LZW: 9..12 bit codes, MSB-first bit packing,
 * ClearCode=256, EOI=257, and the "early change" quirk (code width grows
 * one code earlier than plain LZW). */
long mvs_lzw_decode(const uint8_t *src, long n, uint8_t *dst, long cap)
{
    enum { CLEAR = 256, EOI = 257, MAXCODES = 4096 };
    static const int FIRST = 258;

    int prev[MAXCODES];
    uint8_t suffix[MAXCODES];
    int length[MAXCODES];
    uint8_t tmp[MAXCODES];

    int c;
    for (c = 0; c < 256; c++) {
        prev[c] = -1;
        suffix[c] = (uint8_t)c;
        length[c] = 1;
    }

    int next_code = FIRST;
    int width = 9;
    int prev_code = -1;
    uint32_t bitbuf = 0;
    int bits = 0;
    long i = 0, o = 0;

    for (;;) {
        while (bits < width) {
            if (i >= n)
                return o; /* ran out of input: accept (strips may omit EOI) */
            bitbuf = (bitbuf << 8) | src[i++];
            bits += 8;
        }
        int code = (int)((bitbuf >> (bits - width)) & ((1u << width) - 1));
        bits -= width;

        if (code == EOI)
            return o;
        if (code == CLEAR) {
            next_code = FIRST;
            width = 9;
            prev_code = -1;
            continue;
        }
        if (prev_code < 0) {
            if (code > 255)
                return -1;
            if (o + 1 > cap)
                return -1;
            dst[o++] = (uint8_t)code;
            prev_code = code;
            continue;
        }

        int emit_code, emit_len;
        uint8_t first_byte;
        if (code < next_code) {
            emit_code = code;
            emit_len = length[code];
        } else if (code == next_code) {
            /* KwKwK case: string(prev) + first byte of string(prev) */
            emit_code = prev_code;
            emit_len = length[prev_code] + 1;
        } else {
            return -1;
        }

        /* materialize the emitted string (walk the chain backwards) */
        {
            int k = emit_code;
            int pos = (code == next_code) ? emit_len - 1 : emit_len;
            while (k >= 0) {
                tmp[--pos] = suffix[k];
                k = prev[k];
            }
            first_byte = tmp[0];
            if (code == next_code)
                tmp[emit_len - 1] = first_byte;
        }
        if (o + emit_len > cap)
            return -1;
        memcpy(dst + o, tmp, (size_t)emit_len);
        o += emit_len;

        if (next_code < MAXCODES) {
            prev[next_code] = prev_code;
            suffix[next_code] = first_byte;
            length[next_code] = length[prev_code] + 1;
            next_code++;
        }
        /* early change: width grows when the NEXT code to assign would not
         * fit, one entry earlier than plain LZW */
        if (next_code == (1 << width) - 1 && width < 12)
            width++;

        prev_code = code;
    }
}

/* TIFF predictor 2 (horizontal differencing), in-place, 8/16-bit samples. */
void mvs_predictor2_u8(uint8_t *row, long width, long spp)
{
    long x;
    for (x = spp; x < width * spp; x++)
        row[x] = (uint8_t)(row[x] + row[x - spp]);
}

void mvs_predictor2_u16(uint16_t *row, long width, long spp)
{
    long x;
    for (x = spp; x < width * spp; x++)
        row[x] = (uint16_t)(row[x] + row[x - spp]);
}

/* Predictor 2 over `rows` contiguous rows of `width` single samples. */
void mvs_predictor2_rows_u8(uint8_t *data, long rows, long width)
{
    long r;
    for (r = 0; r < rows; r++)
        mvs_predictor2_u8(data + r * width, width, 1);
}

void mvs_predictor2_rows_u16(uint16_t *data, long rows, long width)
{
    long r;
    for (r = 0; r < rows; r++)
        mvs_predictor2_u16(data + r * width, width, 1);
}

/* Link codec bit-pack (ops/link_codec.py byte-planar layout):
 * packed = [lo bytes (count)] + [high bits, 8/(nbits-8) fields per byte].
 * The loops are memory-bound and run without the GIL (ctypes releases it),
 * so host packing overlaps the copies of other bands.
 * Return bytes written / values written, or -1 on bad nbits. */

long mvs_bitpack(const uint16_t *v, long count, int nbits, uint8_t *out)
{
    long k, blocks;
    int e = nbits - 8, per, i;
    if (nbits == 8) {
        for (k = 0; k < count; k++)
            out[k] = (uint8_t)(v[k] & 0xFF);
        return count;
    }
    if (nbits < 8) {
        /* sub-byte widths (delta residuals): groups of g values -> b
         * bytes, little-endian fields (ops/link_codec.py
         * _SUB_BYTE_GROUP layout); odd widths use group-of-8 (up to
         * 56 bits -> uint64 accumulator) */
        int g, b, j;
        long groups;
        if (nbits == 2)      { g = 4; b = 1; }
        else if (nbits == 3) { g = 8; b = 3; }
        else if (nbits == 4) { g = 2; b = 1; }
        else if (nbits == 5) { g = 8; b = 5; }
        else if (nbits == 6) { g = 4; b = 3; }
        else if (nbits == 7) { g = 8; b = 7; }
        else
            return -1;
        groups = (count + g - 1) / g;
        for (k = 0; k < groups; k++) {
            uint64_t acc = 0;
            for (i = 0; i < g; i++) {
                long p = k * (long)g + i;
                uint64_t f = p < count ? (uint64_t)v[p] : 0;
                acc |= f << (i * nbits);
            }
            for (j = 0; j < b; j++)
                out[k * (long)b + j] = (uint8_t)(acc >> (8 * j));
        }
        return groups * (long)b;
    }
    if (e != 1 && e != 2 && e != 4)
        return -1;
    per = 8 / e;
    for (k = 0; k < count; k++)
        out[k] = (uint8_t)(v[k] & 0xFF);
    blocks = (count + per - 1) / per;
    for (k = 0; k < blocks; k++) {
        uint8_t acc = 0;
        for (i = 0; i < per; i++) {
            long j = k * (long)per + i;
            uint8_t hi = j < count ? (uint8_t)(v[j] >> 8) : 0;
            acc |= (uint8_t)(hi << (i * e));
        }
        out[count + k] = acc;
    }
    return count + blocks;
}

/* Row-segmented zigzag delta transform (ops/link_codec.py delta mode).
 * Rows of `row` values, edge-padded: firsts[r] is each row's first value,
 * resid holds zigzag-coded wrapped first differences ((row-1) per row).
 * Matches the numpy and torch codecs bit for bit (uint16 wraparound). */

long mvs_delta_encode(const uint16_t *v, long count, int row,
                      uint16_t *firsts, uint16_t *resid)
{
    long n_rows = (count + row - 1) / row;
    long r, i;
    for (r = 0; r < n_rows; r++) {
        long base = r * (long)row;
        uint16_t prev = v[base];
        uint16_t *rr = resid + r * (long)(row - 1);
        firsts[r] = prev;
        for (i = 1; i < row; i++) {
            long j = base + i;
            uint16_t cur = j < count ? v[j] : v[count - 1];
            int16_t d = (int16_t)(uint16_t)(cur - prev);
            rr[i - 1] = (uint16_t)(((int)d << 1) ^ ((int)d >> 15));
            prev = cur;
        }
    }
    return n_rows;
}

long mvs_delta_decode(const uint16_t *firsts, const uint16_t *resid,
                      long count, int row, uint16_t *out)
{
    long n_rows = (count + row - 1) / row;
    long r, i;
    for (r = 0; r < n_rows; r++) {
        long base = r * (long)row;
        uint16_t cur = firsts[r];
        const uint16_t *rr = resid + r * (long)(row - 1);
        if (base < count)
            out[base] = cur;
        for (i = 1; i < row; i++) {
            long j = base + i;
            int z = rr[i - 1];
            int d = (z >> 1) ^ -(z & 1);
            cur = (uint16_t)(cur + (uint16_t)d);
            if (j < count)
                out[j] = cur;
            else
                break;
        }
    }
    return count;
}

long mvs_bitunpack(const uint8_t *buf, long buf_len, int nbits, long count,
                   uint16_t *out)
{
    long k, blocks;
    int e = nbits - 8, per, i;
    uint8_t mask;
    if (nbits == 8) {
        if (buf_len < count)
            return -1;
        for (k = 0; k < count; k++)
            out[k] = buf[k];
        return count;
    }
    if (nbits < 8) {
        int g, b, j;
        long groups;
        uint64_t m = (uint64_t)((1u << nbits) - 1);
        if (nbits == 2)      { g = 4; b = 1; }
        else if (nbits == 3) { g = 8; b = 3; }
        else if (nbits == 4) { g = 2; b = 1; }
        else if (nbits == 5) { g = 8; b = 5; }
        else if (nbits == 6) { g = 4; b = 3; }
        else if (nbits == 7) { g = 8; b = 7; }
        else
            return -1;
        groups = (count + g - 1) / g;
        if (buf_len < groups * (long)b)
            return -1;
        for (k = 0; k < groups; k++) {
            uint64_t acc = 0;
            for (j = 0; j < b; j++)
                acc |= (uint64_t)buf[k * (long)b + j] << (8 * j);
            for (i = 0; i < g; i++) {
                long p = k * (long)g + i;
                if (p < count)
                    out[p] = (uint16_t)((acc >> (i * nbits)) & m);
            }
        }
        return count;
    }
    if (e != 1 && e != 2 && e != 4)
        return -1;
    per = 8 / e;
    mask = (uint8_t)((1 << e) - 1);
    blocks = (count + per - 1) / per;
    if (buf_len < count + blocks)
        return -1;
    /* full blocks: branch-free unrolled bodies the compiler can vectorize */
    if (e == 2) {
        long full = count / 4;
        const uint8_t *hi = buf + count;
        for (k = 0; k < full; k++) {
            uint8_t acc = hi[k];
            long j = k * 4;
            out[j]     = (uint16_t)(buf[j]     | ((acc        & 3u) << 8));
            out[j + 1] = (uint16_t)(buf[j + 1] | (((acc >> 2) & 3u) << 8));
            out[j + 2] = (uint16_t)(buf[j + 2] | (((acc >> 4) & 3u) << 8));
            out[j + 3] = (uint16_t)(buf[j + 3] | (((acc >> 6) & 3u) << 8));
        }
        k = full;
    } else if (e == 4) {
        long full = count / 2;
        const uint8_t *hi = buf + count;
        for (k = 0; k < full; k++) {
            uint8_t acc = hi[k];
            long j = k * 2;
            out[j]     = (uint16_t)(buf[j]     | ((acc        & 15u) << 8));
            out[j + 1] = (uint16_t)(buf[j + 1] | (((acc >> 4) & 15u) << 8));
        }
        k = full;
    } else { /* e == 1 (9-bit): the ragged loop below handles all blocks */
        k = 0;
    }
    for (; k < blocks; k++) { /* ragged tail */
        uint8_t acc = buf[count + k];
        for (i = 0; i < per; i++) {
            long j = k * (long)per + i;
            if (j < count)
                out[j] = (uint16_t)(buf[j] |
                                    (((acc >> (i * e)) & mask) << 8));
        }
    }
    return count;
}
