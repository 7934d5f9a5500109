/* Native host-side byte assembly for fibers_tpu.
 *
 * The Python/numpy layer owns file formats and device math; these helpers
 * cover the few host loops where numpy's generality costs real wall time
 * on multi-hundred-MB buffers.  Built lazily by native/build.py with the
 * system C compiler; fibers_tpu falls back to numpy when unavailable.
 *
 * pack_trk_lines: interleave TrackVis streamline records
 *   [int32 npts_i][float32 (xyz + ns scalars)*npts_i]... converting
 *   0-based voxel coords to 0.5-based mm ((v + 0.5) * voxel_size,
 *   reference: src/trk.jl:476) in the same pass, one line per loop
 *   iteration across OpenMP threads.  No intermediate copy.
 *
 * unpack_trk_records: the inverse scan used by trk_read — splits counts
 *   and points and converts mm back to voxel coords
 *   (reference: src/trk.jl:410-412).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Line i's record starts at word i + (3 + ns) * (points of lines < i):
 * a prefix sum of 1 + (3 + ns) * npts_i, taken once up front, after
 * which the lines are independent.  The point math is the numpy path's
 * float32 (v + 0.5f) * voxel_size, one rounding per operation; scalars
 * are copied as they are.  Returns -1 when the offsets' buffer cannot
 * be allocated, else 0. */
int32_t pack_trk_lines(int64_t n, const int32_t *npts, const float *pts,
                       const float *scal, int32_t ns, const float *vsz,
                       float *out)
{
    const float sx = vsz[0], sy = vsz[1], sz = vsz[2];
    const int64_t width = 3 + (int64_t)ns;
    int64_t *first = (int64_t *)malloc((size_t)(n > 0 ? n : 1)
                                       * sizeof(int64_t));
    if (first == NULL)
        return -1;
    int64_t acc = 0;
    for (int64_t i = 0; i < n; i++) {
        first[i] = acc;
        acc += npts[i];
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const int64_t p0 = first[i];
        const int32_t m = npts[i];
        const float *src = pts + p0 * 3;
        const float *sc = ns ? scal + p0 * ns : scal;
        float *dst = out + i + p0 * width;
        memcpy(dst, &m, sizeof(int32_t));
        dst++;
        for (int32_t j = 0; j < m; j++) {
            dst[0] = (src[0] + 0.5f) * sx;
            dst[1] = (src[1] + 0.5f) * sy;
            dst[2] = (src[2] + 0.5f) * sz;
            for (int32_t k = 0; k < ns; k++)
                dst[3 + k] = sc[k];
            dst += width;
            src += 3;
            sc += ns;
        }
    }
    free(first);
    return 0;
}

/* Decode int8 error-feedback delta streams into float32 positions:
 * out[j] = anchor_line + (integer running sum of deltas) * inv_scale.
 * Lines are independent (parallelized when OpenMP is available). */
void decode_delta_lines(const int8_t *q, const int64_t *off,
                        const int32_t *npts, const float *anchors,
                        int64_t nlines, float inv_scale, float *out)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nlines; i++) {
        int64_t j = off[i];
        const int8_t *src = q + j * 3;
        float *dst = out + j * 3;
        const float ax = anchors[i * 3], ay = anchors[i * 3 + 1],
                    az = anchors[i * 3 + 2];
        int32_t cx = 0, cy = 0, cz = 0;
        for (int32_t k = 0; k < npts[i]; k++) {
            cx += src[0]; cy += src[1]; cz += src[2];
            dst[0] = ax + cx * inv_scale;
            dst[1] = ay + cy * inv_scale;
            dst[2] = az + cz * inv_scale;
            src += 3;
            dst += 3;
        }
    }
}

/* Fused delta-decode + TrackVis record pack: one pass from the fetched
 * int8 wire straight to the .trk byte stream, skipping the [total, 3]
 * float32 intermediate that decode_delta_lines + pack_trk_records
 * would produce and re-read (two full memory passes over ~GB buffers
 * on the benchmark host).  Line i's record starts at word
 * off[i]*3 + i (one count word per preceding line).  Point math is the
 * exact composition of the two unfused passes:
 * (anchor + cumsum(q)*inv_scale + 0.5) * voxel_size. */
void decode_delta_trk_records(const int8_t *q, const int64_t *off,
                              const int32_t *npts, const float *anchors,
                              int64_t nlines, float inv_scale,
                              const float *vsz, float *out)
{
    const float sx = vsz[0], sy = vsz[1], sz = vsz[2];
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nlines; i++) {
        int64_t j = off[i];
        const int8_t *src = q + j * 3;
        float *dst = out + j * 3 + i;
        const float ax = anchors[i * 3], ay = anchors[i * 3 + 1],
                    az = anchors[i * 3 + 2];
        int32_t m = npts[i];
        memcpy(dst, &m, sizeof(int32_t));
        dst++;
        int32_t cx = 0, cy = 0, cz = 0;
        for (int32_t k = 0; k < m; k++) {
            cx += src[0]; cy += src[1]; cz += src[2];
            dst[0] = (ax + cx * inv_scale + 0.5f) * sx;
            dst[1] = (ay + cy * inv_scale + 0.5f) * sy;
            dst[2] = (az + cz * inv_scale + 0.5f) * sz;
            src += 3;
            dst += 3;
        }
    }
}

/* The i6 wire is a flat little-endian stream of 6-bit sign-offset
 * fields over 32-bit words (16 fields per 3 words; fields 5 and 10
 * straddle word boundaries).  Each line is decoded with a rolling
 * bit-buffer reader (~3 ops per field, refill branch taken 1 in 5) —
 * a naive per-field extractor measured ~3x slower on the 1-core
 * benchmark host, turning the 25% wire saving into a decode loss. */
struct bits6 {
    const uint32_t *p;
    uint64_t acc;
    int have;
};

static inline struct bits6 bits6_at(const uint32_t *w, int64_t field)
{
    uint64_t bit = (uint64_t)field * 6;
    struct bits6 b;
    b.p = w + (bit >> 5);
    b.acc = (uint64_t)(*b.p++) >> (bit & 31);
    b.have = 32 - (int)(bit & 31);
    return b;
}

static inline int32_t bits6_next(struct bits6 *b)
{
    if (b->have < 6) {
        b->acc |= (uint64_t)(*b->p++) << b->have;
        b->have += 32;
    }
    int32_t v = (int32_t)(b->acc & 63u) - 32;
    b->acc >>= 6;
    b->have -= 6;
    return v;
}

/* Fused 6-bit-wire decode + TrackVis record pack: the i6 counterpart of
 * decode_delta_trk_records — one pass from the fetched uint32 wire
 * straight to .trk record bytes, skipping both the int8 expansion and
 * the [total, 3] float32 intermediate. */
void decode_delta6_trk_records(const uint32_t *q, const int64_t *off,
                               const int32_t *npts, const float *anchors,
                               int64_t nlines, float inv_scale,
                               const float *vsz, float *out)
{
    const float sx = vsz[0], sy = vsz[1], sz = vsz[2];
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nlines; i++) {
        int64_t j = off[i] * 3;
        float *dst = out + j + i;
        const float ax = anchors[i * 3], ay = anchors[i * 3 + 1],
                    az = anchors[i * 3 + 2];
        int32_t m = npts[i];
        memcpy(dst, &m, sizeof(int32_t));
        dst++;
        if (m == 0)
            continue;   /* a trailing zero-point line (len_min=0) would
                         * otherwise seed the reader one word past the
                         * fetched buffer */
        struct bits6 b = bits6_at(q, j);
        int32_t cx = 0, cy = 0, cz = 0;
        for (int32_t k = 0; k < m; k++) {
            cx += bits6_next(&b);
            cy += bits6_next(&b);
            cz += bits6_next(&b);
            dst[0] = (ax + cx * inv_scale + 0.5f) * sx;
            dst[1] = (ay + cy * inv_scale + 0.5f) * sy;
            dst[2] = (az + cz * inv_scale + 0.5f) * sz;
            dst += 3;
        }
    }
}

/* Expand the 6-bit wire (tract/stream.py _compact mode="i6") back to
 * int8: each group of 16 sign-offset 6-bit fields lives in 3 uint32
 * words (values 5 and 10 straddle word boundaries).  One streaming
 * pass; the expanded buffer then feeds the existing int8 delta
 * decoders unchanged. */
void unpack_sext6(const uint32_t *w, int64_t nvals, int8_t *out)
{
    int64_t ngroups = (nvals + 15) / 16;
#pragma omp parallel for schedule(static)
    for (int64_t g = 0; g < ngroups; g++) {
        const uint32_t w0 = w[g * 3], w1 = w[g * 3 + 1],
                       w2 = w[g * 3 + 2];
        uint32_t v[16];
        v[0] = w0;        v[1] = w0 >> 6;  v[2] = w0 >> 12;
        v[3] = w0 >> 18;  v[4] = w0 >> 24;
        v[5] = (w0 >> 30) | (w1 << 2);
        v[6] = w1 >> 4;   v[7] = w1 >> 10; v[8] = w1 >> 16;
        v[9] = w1 >> 22;
        v[10] = (w1 >> 28) | (w2 << 4);
        v[11] = w2 >> 2;  v[12] = w2 >> 8; v[13] = w2 >> 14;
        v[14] = w2 >> 20; v[15] = w2 >> 26;
        int64_t base = g * 16;
        int64_t lim = nvals - base;
        if (lim > 16) lim = 16;
        for (int64_t k = 0; k < lim; k++)
            out[base + k] = (int8_t)((int32_t)(v[k] & 63u) - 32);
    }
}

/* Gather rows of a C-contiguous [nvox, nvol] float32 matrix at `idx`
 * and quantize to uint16 (round-half-up of v/scale, negatives and
 * overflow clipped) in ONE pass — the host side of the u16 signal wire
 * (core/batch.py).  numpy needs ~5 full-size passes for the same
 * (fancy-index copy, astype, multiply, clip, astype); on 1-2 core
 * benchmark hosts those passes sit on the critical path ahead of every
 * upload. */
void gather_quant_u16(const float *flat, const int64_t *idx, int64_t n,
                      int64_t nvol, float inv_scale, uint16_t *out)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const float *src = flat + idx[i] * nvol;
        uint16_t *dst = out + i * nvol;
        for (int64_t v = 0; v < nvol; v++) {
            float q = src[v] * inv_scale;
            if (!(q > 0.0f)) q = 0.0f;
            if (q > 65535.0f) q = 65535.0f;
            dst[v] = (uint16_t)(q + 0.5f);
        }
    }
}

/* uint8 variant of gather_quant_u16 — the half-width wire for
 * scale-invariant consumers (DSI). */
void gather_quant_u8(const float *flat, const int64_t *idx, int64_t n,
                     int64_t nvol, float inv_scale, uint8_t *out)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const float *src = flat + idx[i] * nvol;
        uint8_t *dst = out + i * nvol;
        for (int64_t v = 0; v < nvol; v++) {
            float q = src[v] * inv_scale;
            if (!(q > 0.0f)) q = 0.0f;
            if (q > 255.0f) q = 255.0f;
            dst[v] = (uint8_t)(q + 0.5f);
        }
    }
}

/* 12-bit wire: gather + quantize + pack 2 values per 3 bytes, per row
 * (odd nvol pads a zero field).  25% fewer upload bytes than u16 at
 * absolute error <= max/8190 — still far below DWI fit noise
 * (core/batch.py routes the device-side unpack). */
void gather_quant_u12(const float *flat, const int64_t *idx, int64_t n,
                      int64_t nvol, float inv_scale, uint8_t *out)
{
    int64_t rowb = ((nvol + 1) / 2) * 3;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const float *src = flat + idx[i] * nvol;
        uint8_t *dst = out + i * rowb;
        for (int64_t v = 0; v < nvol; v += 2) {
            float q0f = src[v] * inv_scale;
            if (!(q0f > 0.0f)) q0f = 0.0f;
            if (q0f > 4095.0f) q0f = 4095.0f;
            uint32_t q0 = (uint32_t)(q0f + 0.5f);
            uint32_t q1 = 0;
            if (v + 1 < nvol) {
                float q1f = src[v + 1] * inv_scale;
                if (!(q1f > 0.0f)) q1f = 0.0f;
                if (q1f > 4095.0f) q1f = 4095.0f;
                q1 = (uint32_t)(q1f + 0.5f);
            }
            dst[0] = (uint8_t)(q0 & 0xFFu);
            dst[1] = (uint8_t)((q0 >> 8) | ((q1 & 0xFu) << 4));
            dst[2] = (uint8_t)(q1 >> 4);
            dst += 3;
        }
    }
}

/* RUMBA-SD signal rows in one pass (models/rumba.py host producer): for
 * masked voxel row idx[i], average the b0 frames (negatives clipped),
 * emit the b0>0 flag as column 0 and the b0-normalized DWI frames
 * clipped to [0,1] in columns 1.., all quantized to the u16 wire
 * (scale 1/65535).  Matches the numpy expression to within one grid
 * unit (the b0 mean accumulates in double here vs numpy's pairwise
 * f32 — last-ulp differences can flip a rounding boundary).  Non-finite
 * ratios (f32 overflow of v/b0 on a subnormal b0) become 0, exactly as
 * the numpy path's isfinite scrub does. */
void rumba_signal_u16(const float *flat, const int64_t *idx, int64_t n,
                      int64_t nvol, const int32_t *ib0, int64_t nb0,
                      const int32_t *idwi, int64_t ndwi, uint16_t *out)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const float *src = flat + idx[i] * nvol;
        uint16_t *dst = out + i * (ndwi + 1);
        double acc = 0.0;
        for (int64_t j = 0; j < nb0; j++) {
            float v = src[ib0[j]];
            if (v > 0.0f) acc += v;
        }
        float b0 = (float)(acc / (double)nb0);
        dst[0] = b0 > 0.0f ? 65535 : 0;
        for (int64_t j = 0; j < ndwi; j++) {
            float v = src[idwi[j]];
            if (!(v > 0.0f)) v = 0.0f;
            float q = b0 > 0.0f ? v / b0 : 0.0f;
            if (!isfinite(q)) q = 0.0f;
            if (q > 1.0f) q = 1.0f;
            dst[1 + j] = (uint16_t)(q * 65535.0f + 0.5f);
        }
    }
}

/* rumba_signal_u16's 12-bit counterpart: the same fused gather +
 * b0-normalize, quantized to 4095 steps on [0,1] and packed 2 values
 * per 3 bytes (25% fewer wire bytes; quantization ~100x below the
 * Rician noise the fit estimates).  Row layout matches the u12 batch
 * wire: ndwi+1 fields (b0 flag first), odd counts pad a zero field. */
void rumba_signal_u12(const float *flat, const int64_t *idx, int64_t n,
                      int64_t nvol, const int32_t *ib0, int64_t nb0,
                      const int32_t *idwi, int64_t ndwi, uint8_t *out)
{
    int64_t ncol = ndwi + 1;
    int64_t rowb = ((ncol + 1) / 2) * 3;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const float *src = flat + idx[i] * nvol;
        uint8_t *dst = out + i * rowb;
        double acc = 0.0;
        for (int64_t j = 0; j < nb0; j++) {
            float v = src[ib0[j]];
            if (v > 0.0f) acc += v;
        }
        float b0 = (float)(acc / (double)nb0);
        uint32_t pend = b0 > 0.0f ? 4095u : 0u;   /* field 0: b0 flag */
        int have = 1;
        for (int64_t j = 0; j < ndwi; j++) {
            float v = src[idwi[j]];
            if (!(v > 0.0f)) v = 0.0f;
            float q = b0 > 0.0f ? v / b0 : 0.0f;
            if (!isfinite(q)) q = 0.0f;
            if (q > 1.0f) q = 1.0f;
            uint32_t qi = (uint32_t)(q * 4095.0f + 0.5f);
            if (have) {
                dst[0] = (uint8_t)(pend & 0xFFu);
                dst[1] = (uint8_t)((pend >> 8) | ((qi & 0xFu) << 4));
                dst[2] = (uint8_t)(qi >> 4);
                dst += 3;
                have = 0;
            } else {
                pend = qi;
                have = 1;
            }
        }
        if (have) {                               /* odd ncol: pad 0 */
            dst[0] = (uint8_t)(pend & 0xFFu);
            dst[1] = (uint8_t)(pend >> 8);
            dst[2] = 0;
        }
    }
}

/* Row gather without quantization (the f32 wire). */
void gather_rows_f32(const float *flat, const int64_t *idx, int64_t n,
                     int64_t nvol, float *out)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++)
        memcpy(out + i * nvol, flat + idx[i] * nvol,
               (size_t)nvol * sizeof(float));
}

/* Returns the number of streamlines parsed, or -1 if the payload is
 * malformed (counts walking past the end).  rec_floats = payload length
 * in float32 units; stride_per_pt = 3 + n_scalars; n_properties floats
 * trail each record. */
int64_t unpack_trk_records(const float *payload, int64_t rec_floats,
                           int32_t stride_per_pt, int32_t n_properties,
                           const float *vsz,
                           int32_t *npts_out, int64_t max_lines,
                           float *pts_out, int64_t max_pts)
{
    const float sx = vsz[0], sy = vsz[1], sz = vsz[2];
    int64_t pos = 0, line = 0, npt = 0;

    while (pos < rec_floats && line < max_lines) {
        int32_t m;
        memcpy(&m, payload + pos, sizeof(int32_t));
        pos++;
        if (m < 0 || pos + (int64_t)m * stride_per_pt + n_properties
                     > rec_floats)
            return -1;
        if (npt + m > max_pts)
            return -1;
        npts_out[line++] = m;
        for (int32_t j = 0; j < m; j++) {
            const float *p = payload + pos + (int64_t)j * stride_per_pt;
            pts_out[npt * 3 + 0] = p[0] / sx - 0.5f;
            pts_out[npt * 3 + 1] = p[1] / sy - 0.5f;
            pts_out[npt * 3 + 2] = p[2] / sz - 0.5f;
            npt++;
        }
        pos += (int64_t)m * stride_per_pt + n_properties;
    }
    return line;
}
