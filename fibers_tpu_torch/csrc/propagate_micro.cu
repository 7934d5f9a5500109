// Microscopy cone-search streamline propagation, one direction of a chunk
// of streams, for Hopper (sm_90a).
//
// Replaces fibers_tpu/tract/modes.py:299-371 (`_propagate_micro`): a
// jitted `jax.lax.scan` over the step function, which XLA compiles into one
// device program (XLA, not Pallas).  The port's plain version,
// ops/kernels/propagate_micro.py:propagate_micro_dir_plain, runs each step
// as a few dozen torch launches over [S, W] windows; here one warp per
// stream runs all `nsteps` steps, so a direction of a chunk is one launch.
// Each step, in the plain loop's order: pos_next = pos + vec * step and its
// voxel (the bounds test and the mask); then the window of W cells around
// that voxel, lane l taking cells l, l + 32, ...: each cell's position and
// bounds test (the flat index computed here, so no gather leaves the
// field), its mask, the cone test conedot > search_cos, the first vector
// of the cell, cosang and cabs = isfinite(cosang) ? |cosang| : -inf; a
// warp argmax with torch.argmax's rules (cabs is never NaN: the first
// index wins ties, and when every cell is -inf the result is cell 0, whose
// cosang is not finite and stops the stream); the save of the current
// point, or with deltas the error-feedback quantizer; the stop rules (the
// angle to the chosen vector, the shared length budget); the EMA
// smoothing; the jump to the chosen cell.  Every lane keeps the stream's
// state (pos, vec, pos_q, npts, active) in registers and updates it alike;
// lane 0 stores.  Once the stream stops, the lanes store its frozen point
// (or a zero delta) and saved = false for the steps left, as the plain
// loop does, and the warp is done.
//
// Bit-equal to the plain loop on the card through the shared step helpers
// (propagate_common.cuh: products and sums rounded apart, the sums of
// three in torch's CUDA order, IEEE square root and quotient).  The window
// sums conedot ([S, W, 3] · [1, W, 3]) and cosang ([S, W, 3] · [S, 1, 3])
// are materialised by torch as contiguous [S * W, 3] products and reduced
// over the last dimension like any other sum of three;
// propagate_micro.py:window_selfcheck holds that on the card.
//
// What bounds it on an H100: operations.  A direction must write the
// [nsteps, S, 3] points and the [nsteps, S] flags and read the start state
// and the visited part of the field (bytes), but each active stream-step
// also tests all W cells: at W = 748 (search_dist 15 in 2-D) that is ~10k
// FP32 operations a stream-step against ~13 bytes of output, far above the
// card's ~20 operations a byte.  What holds this simple design below that:
// the cells' mask and vector gathers (L1/L2 latency; the window's offsets
// and directions are read through L1 by every warp), and warps whose
// streams stop early idle until their block's last stream ends.  What it
// reaches is in PERF.md.

#include "propagate_common.cuh"

namespace {

using prop::dot3;
using prop::round_i64;

constexpr int kThreads = 256;               // 8 warps: 8 streams a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct MicroParams {
    const float* pos0;      // [S, 3]
    const float* vec0;      // [S, 3]
    const int* npts0;       // [S]
    const uint8_t* mask;    // [nx * ny * nz] bool
    const float* vfirst;    // [nx * ny * nz, 3] the first vector per voxel
    const long long* woff;  // [W, 3] window offsets
    const float* wdir;      // [W, 3] window unit directions
    int S, nsteps, W, nx, ny, nz;
    float step, cos_thresh, search_cos, sc, sc1;
    int smooth, len_max;
    float qscale, qstep, dmax;
    void* out;              // [nsteps, S, 3] f32 points or i8 deltas
    uint8_t* saved;         // [nsteps, S] bool
    int* npts;              // [S]
    float* pos_q;           // [S, 3] the anchor
};

template <bool kDeltas>
__global__ void __launch_bounds__(kThreads)
micro_kernel(const MicroParams p)
{
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (s >= p.S) return;                   // the whole warp: one stream

    float px = p.pos0[3 * s], py = p.pos0[3 * s + 1], pz = p.pos0[3 * s + 2];
    float vx = p.vec0[3 * s], vy = p.vec0[3 * s + 1], vz = p.vec0[3 * s + 2];
    float qx = px, qy = py, qz = pz;
    int n = p.npts0[s];

    int t = 0;
    for (; t < p.nsteps; ++t) {
        const float nxp = __fadd_rn(px, __fmul_rn(vx, p.step));
        const float nyp = __fadd_rn(py, __fmul_rn(vy, p.step));
        const float nzp = __fadd_rn(pz, __fmul_rn(vz, p.step));
        const long long ix = round_i64(nxp);
        const long long iy = round_i64(nyp);
        const long long iz = round_i64(nzp);
        bool inb;
        const long long flat =
            prop::flat_index(ix, iy, iz, p.nx, p.ny, p.nz, inb);
        const bool inmask = inb && p.mask[flat];

        // this lane's cells: the best cabs, the first among equals
        float best = -INFINITY, bc = -INFINITY;
        float bx = 0.f, by = 0.f, bz = 0.f;
        int bi = 0x7fffffff;
        for (int w = lane; w < p.W; w += 32) {
            const long long* cell = p.woff + 3 * w;
            bool winb;
            const long long wflat = prop::flat_index(
                ix + __ldg(cell), iy + __ldg(cell + 1), iz + __ldg(cell + 2),
                p.nx, p.ny, p.nz, winb);
            const float* d = p.wdir + 3 * w;
            float c = -INFINITY, cabs = -INFINITY;
            float ax = 0.f, ay = 0.f, az = 0.f;
            if (winb && p.mask[wflat]
                    && dot3(vx, vy, vz, __ldg(d), __ldg(d + 1), __ldg(d + 2))
                           > p.search_cos) {
                const float* a = p.vfirst + 3 * wflat;
                ax = __ldg(a);
                ay = __ldg(a + 1);
                az = __ldg(a + 2);
                c = dot3(vx, vy, vz, ax, ay, az);
                cabs = isfinite(c) ? fabsf(c) : -INFINITY;
            }
            if (w == lane || cabs > best) {
                best = cabs;
                bi = w;
                bc = c;
                bx = ax;
                by = ay;
                bz = az;
            }
        }
        // the warp's argmax: the largest cabs, the lowest cell among equals
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(kFull, best, off);
            const int oi = __shfl_down_sync(kFull, bi, off);
            if (ov > best || (ov == best && oi < bi)) {
                best = ov;
                bi = oi;
            }
        }
        bi = __shfl_sync(kFull, bi, 0);
        const int src = bi & 31;            // the lane that took cell bi
        bc = __shfl_sync(kFull, bc, src);
        bx = __shfl_sync(kFull, bx, src);
        by = __shfl_sync(kFull, by, src);
        bz = __shfl_sync(kFull, bz, src);

        const bool save = inb && inmask && isfinite(bc);
        n += save;
        const size_t o = (size_t)t * p.S + s;
        float ox, oy, oz;
        prop::point_out<kDeltas>(save, px, py, pz, qx, qy, qz, p.qscale,
                                 p.qstep, p.dmax, ox, oy, oz);
        if (lane == 0) {
            prop::store3<kDeltas>(p.out, o, ox, oy, oz);
            p.saved[o] = save;
        }

        const bool pos_side = bc > 0.f;
        const float wx = pos_side ? bx : -bx;
        const float wy = pos_side ? by : -by;
        const float wz = pos_side ? bz : -bz;
        const bool cont = save
            && dot3(vx, vy, vz, wx, wy, wz) >= p.cos_thresh
            && n <= p.len_max;
        if (!cont) {
            ++t;
            break;
        }
        const long long* wo = p.woff + 3 * bi;
        px = (float)(ix + __ldg(wo));
        py = (float)(iy + __ldg(wo + 1));
        pz = (float)(iz + __ldg(wo + 2));
        prop::smooth_dir(vx, vy, vz, wx, wy, wz, p.sc, p.sc1, p.smooth);
    }
    // stopped: the frozen point (or a zero delta), not saved, for the steps
    // left, the lanes taking steps t + lane, t + lane + 32, ...
    for (int u = t + lane; u < p.nsteps; u += 32) {
        const size_t o = (size_t)u * p.S + s;
        if (kDeltas)
            prop::store3<kDeltas>(p.out, o, 0.f, 0.f, 0.f);
        else
            prop::store3<kDeltas>(p.out, o, px, py, pz);
        p.saved[o] = 0;
    }
    if (lane == 0) {
        p.npts[s] = n;
        p.pos_q[3 * s] = qx;
        p.pos_q[3 * s + 1] = qy;
        p.pos_q[3 * s + 2] = qz;
    }
}

// out[i] = dot3(a[i % m], b[i / bcast]) for [m, 3] rows a and [n / bcast,
// 3] rows b: the window's conedot layout with m = W and bcast = W, its
// cosang layout with m = n and bcast = W.
__global__ void window_dot3_kernel(const float* a, const float* b,
                                   float* out, long long n, long long m,
                                   long long bcast)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long ia = i % m, ib = i / bcast;
    out[i] = dot3(a[3 * ia], a[3 * ia + 1], a[3 * ia + 2], b[3 * ib],
                  b[3 * ib + 1], b[3 * ib + 2]);
}

}  // namespace

extern "C" {

// Launch one direction on `stream` (a cudaStream_t).  Returns a
// cudaError_t, 0 when the launch was accepted.  Does not synchronise.
// S >= 1, nsteps >= 1, W >= 1; mask, vfirst over nx * ny * nz voxels.
int propagate_micro_launch(const float* pos0, const float* vec0,
                           const int* npts0, const void* mask,
                           const float* vfirst, const long long* woff,
                           const float* wdir, int S, int nsteps, int W,
                           int nx, int ny, int nz, float step,
                           float cos_thresh, float search_cos, float sc,
                           float sc1, int smooth, int len_max, int deltas,
                           float qscale, float qstep, float dmax, void* out,
                           void* saved, int* npts, float* pos_q,
                           void* stream)
{
    const MicroParams p{pos0, vec0, npts0, (const uint8_t*)mask, vfirst,
                        woff, wdir, S, nsteps, W, nx, ny, nz, step,
                        cos_thresh, search_cos, sc, sc1, smooth, len_max,
                        qscale, qstep, dmax, out, (uint8_t*)saved, npts,
                        pos_q};
    const dim3 grid((S + kWarps - 1) / kWarps);
    const cudaStream_t st = (cudaStream_t)stream;
    if (deltas)
        micro_kernel<true><<<grid, kThreads, 0, st>>>(p);
    else
        micro_kernel<false><<<grid, kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
}

// The kernel's dot3 over the window's two layouts (window_dot3_kernel),
// for the self-check against torch's sums on the card.
int propagate_micro_window_selfcheck(const float* a, const float* b,
                                     float* out, long long n, long long m,
                                     long long bcast, void* stream)
{
    window_dot3_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(a, b, out, n, m, bcast);
    return (int)cudaGetLastError();
}

}  // extern "C"
