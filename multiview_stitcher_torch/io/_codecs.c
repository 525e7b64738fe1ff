/* Native TIFF decoders: PackBits, TIFF LZW and predictor 2.
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
