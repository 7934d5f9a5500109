// Microscopy cone-search streamline propagation, one direction of a chunk
// of streams, for Hopper (sm_90a).
//
// Replaces fibers_tpu/tract/modes.py:299-371 (`_propagate_micro`): a
// jitted `jax.lax.scan` over the step function, which XLA compiles into one
// device program (XLA, not Pallas).  The port's plain version,
// ops/kernels/propagate_micro.py:propagate_micro_dir_plain, runs each step
// as a few dozen torch launches over [S, W] windows; here a warp runs all
// `nsteps` steps of a stream, so a direction of a chunk is one launch.
// Each step, in the plain loop's order: pos_next = pos + vec * step and its
// voxel (the bounds test and the mask); then the window of W cells around
// that voxel: each cell's cone test conedot > search_cos and, for the cells
// in the cone only, its position and bounds test (the flat index computed
// here, so no gather leaves the field), its mask, its first vector, cosang
// and cabs = isfinite(cosang) ? |cosang| : -inf; an argmax with
// torch.argmax's rules (cabs is never NaN: the lowest cell index wins ties,
// and when no cell counts the result is cell 0, whose cosang is then not
// finite and stops the stream); the save of the current point, or with
// deltas the error-feedback quantizer; the stop rules (the angle to the
// chosen vector, the shared length budget); the EMA smoothing; the jump to
// the chosen cell.  Every lane keeps the stream's state (pos, vec, pos_q,
// npts) in registers and updates it alike.  A stopped stream keeps its
// frozen point (or a zero delta) and saved = false for the steps left, as
// the plain loop does.
//
// Bit-equal to the plain loop on the card through the shared step helpers
// (propagate_common.cuh: products and sums rounded apart, the sums of
// three in torch's CUDA order, IEEE square root and quotient).  The window
// sums conedot ([S, W, 3] · [1, W, 3]) and cosang ([S, W, 3] · [S, 1, 3])
// are materialised by torch as contiguous [S * W, 3] products and reduced
// over the last dimension like any other sum of three;
// propagate_micro.py:window_selfcheck holds that on the card.  The cone
// test sums its three products without torch's leading zeros: that changes
// at most the sign of a zero sum, never the comparison.
//
// What bounds it on an H100: operations.  A direction must write the
// [nsteps, S, 3] points and the [nsteps, S] flags and read the start state
// and the visited part of the field (bytes), but each active stream-step
// also tests all W cells' cones: at W = 748 (search_dist 15 in 2-D) that is
// ~4.5k FP32 operations a stream-step against ~13 bytes of output, far
// above the card's ~20 operations a byte.  The design follows from that,
// from the gathers' latency and from the scattered output:
// - the window's directions and offsets (SoA, the offsets as int32) live
//   in shared memory, loaded once a block, each lane's four cells of a
//   128-cell span (cells l, l + 32, l + 64, l + 96) side by side, so a
//   lane reads four cells' x, y or z in one 16-byte load; the window is
//   padded to whole spans with NaN directions, which no cone admits
//   (and so is a cell too far to count, `load_tile`).  A
//   window larger than kTile cells (a 3-D search) streams through in
//   tiles, the block's warps then taking their steps together, one
//   barrier pair a tile;
// - the cone test, read from shared memory, comes before any gather: each
//   lane keeps a bit a cell (up to 1,024 cells a 32-bit mask), and then
//   fetches its in-cone cells' masks and first vectors one cell at a
//   time (~42 of 748 cells at a 10 degree cone), the warp's 32 lanes'
//   loads in flight together;
// - 32-bit index arithmetic for volumes below 2^31 voxels (the wrapper
//   picks the template), 64-bit above;
// - persistent warps: the grid is what the card holds resident (the
//   occupancy API), and a warp whose stream stops takes the next stream
//   from a counter, so no warp idles while streams are left;
// - the frozen tail of a stopped stream is written coalesced: the warp
//   that stops the last stream of a group of 32 consecutive streams
//   writes the group's tails, a lane a stream, one row at a time.
// What it reaches is in PERF.md.

#include <algorithm>

#include "propagate_common.cuh"

namespace {

using prop::dot3;
using prop::dot3_nz;
using prop::voxel;

constexpr int kThreads = 256;               // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 128;                  // cells a warp tests at once
constexpr int kMaskCells = 1024;            // cells of one 32-bit mask
constexpr int kTile = 2048;                 // window cells in shared memory
// six 4-byte arrays of a tile: within the 48 KiB a launch gets without
// cudaFuncSetAttribute
static_assert(kTile * 6 * 4 <= 48 * 1024, "the window tile outgrows 48 KiB");
constexpr unsigned kFull = 0xffffffffu;

struct MicroParams {
    const float* pos0;      // [S, 3]
    const float* vec0;      // [S, 3]
    const int* npts0;       // [S]
    const uint8_t* mask;    // [nx * ny * nz] bool
    const float* vfirst;    // [nx * ny * nz, 3] the first vector per voxel
    const long long* woff;  // [W, 3] window offsets
    const float* wdir;      // [W, 3] window unit directions
    int S, nsteps, W, tile, nx, ny, nz;
    float step, cos_thresh, search_cos, sc, sc1;
    int smooth, len_max;
    float qscale, qstep, dmax;
    void* out;              // [nsteps, S, 3] f32 points or i8 deltas
    uint8_t* saved;         // [nsteps, S] bool
    int* npts;              // [S]
    float* pos_q;           // [S, 3] the anchor
    int* next;              // the next stream to take, 0 at the launch
    int* done;              // [ceil(S / 32)] streams stopped, 0 at the launch
    int* stop;              // [S] the steps each stream took
};

// The window tile in shared memory, `tile` cells (a multiple of kSpan) of
// each array; cell c of a span at c % 32 * 4 + c / 32 (`slot`).
struct Window {
    float *dx, *dy, *dz;
    int *ox, *oy, *oz;
};

__device__ __forceinline__ int slot(int c)
{
    return (c & ~(kSpan - 1)) | ((c & 31) << 2) | ((c >> 5) & 3);
}

// Cells [base, base + n) of the window into shared memory by the block,
// padded to a whole span with NaN directions and zero offsets.  A cell
// with an offset of kFar or more in any dimension goes in as padding too:
// from a voxel in the volume it lies outside (each dimension is below
// 2^29 on the 32-bit path, below 2^31 on the 64-bit one), and from a
// voxel outside the window does not matter, as no point is saved there.
// Every offset kept fits an int32, and on the 32-bit path no sum
// overflows.
template <typename Idx>
__device__ __forceinline__ void load_tile(const MicroParams& p,
                                          const Window& win, int base, int n)
{
    constexpr long long kFar = sizeof(Idx) == 4 ? 1ll << 29 : 1ll << 31;
    const int padded = (n + kSpan - 1) / kSpan * kSpan;
    for (int i = threadIdx.x; i < padded; i += kThreads) {
        const int k = slot(i);
        const long long* o = p.woff + 3 * (size_t)(base + i);
        bool near = i < n;
        for (int d = 0; d < 3 && near; ++d)
            near = o[d] > -kFar && o[d] < kFar;
        if (near) {
            const float* w = p.wdir + 3 * (size_t)(base + i);
            win.dx[k] = w[0];
            win.dy[k] = w[1];
            win.dz[k] = w[2];
            win.ox[k] = (int)o[0];
            win.oy[k] = (int)o[1];
            win.oz[k] = (int)o[2];
        } else {
            win.dx[k] = win.dy[k] = win.dz[k] = __int_as_float(0x7fc00000);
            win.ox[k] = win.oy[k] = win.oz[k] = 0;
        }
    }
}

// A lane's best cell so far: the largest cabs, the lowest cell among
// equals; its cosang, first vector and offset.  Starts as cell 0 at -inf,
// what torch.argmax gives when no cell counts.
struct Best {
    float cabs = -INFINITY, c = -INFINITY, x = 0.f, y = 0.f, z = 0.f;
    int cell = 0, ox = 0, oy = 0, oz = 0;
};

// The lane's next in-cone cell of `bits` (bit 4 g + j: cell first + g *
// kSpan + j * 32 + lane of the tile, slot at + g * kSpan + 4 lane + j),
// taken out of `bits`: its mask and first-vector loads are issued
// together, before either is used.
template <typename Idx>
__device__ __forceinline__ void take_cell(
    const MicroParams& p, const Window& win, unsigned& bits, int at,
    int first, Idx ix, Idx iy, Idx iz, float vx, float vy, float vz,
    Best& b)
{
    if (bits == 0)
        return;
    const int lane = threadIdx.x & 31;
    const int bit = __ffs(bits) - 1;
    bits &= bits - 1;
    const int k = at + (bit >> 2) * kSpan + 4 * lane + (bit & 3);
    const int cell = first + (bit >> 2) * kSpan + (bit & 3) * 32 + lane;
    bool inb;
    const Idx flat = prop::flat_index(ix + (Idx)win.ox[k],
                                      iy + (Idx)win.oy[k],
                                      iz + (Idx)win.oz[k], p.nx, p.ny, p.nz,
                                      inb);
    if (!inb)
        return;
    const uint8_t m = __ldg(p.mask + flat);
    const float* a = p.vfirst + 3 * (size_t)flat;
    const float ax = __ldg(a), ay = __ldg(a + 1), az = __ldg(a + 2);
    if (!m)
        return;
    const float c = dot3(vx, vy, vz, ax, ay, az);
    const float cabs = isfinite(c) ? fabsf(c) : -INFINITY;
    if (cabs > b.cabs || (cabs == b.cabs && cell < b.cell)) {
        b.cabs = cabs;
        b.c = c;
        b.x = ax;
        b.y = ay;
        b.z = az;
        b.cell = cell;
        b.ox = win.ox[k];
        b.oy = win.oy[k];
        b.oz = win.oz[k];
    }
}

// Element k of out [nsteps * S * 3], f32 or int8.
template <bool kDeltas>
__device__ __forceinline__ void store1(void* out, size_t k, float v)
{
    if (kDeltas)
        ((int8_t*)out)[k] = (int8_t)v;
    else
        ((float*)out)[k] = v;
}

// Stream s took `took` steps and stopped (or ran out of steps); the warp
// that stops the last stream of its group of 32 writes the group's frozen
// tails: the last point (or a zero delta) and saved = false from each
// stream's stop on, a lane a stream, the warp a row at a time.
template <bool kDeltas>
__device__ __forceinline__ void stopped(const MicroParams& p, int s,
                                        int took)
{
    const int lane = threadIdx.x & 31;
    const int g0 = s & ~31;
    if (lane == 0)
        p.stop[s] = took;
    __threadfence();            // every lane's stores before the count
    __syncwarp();
    int last = 0;
    if (lane == 0)
        last = atomicAdd(p.done + (s >> 5), 1) == min(32, p.S - g0) - 1;
    if (!__shfl_sync(kFull, last, 0))
        return;
    __threadfence();            // the group's rows after the count
    const int sl = g0 + lane;
    const bool mine = sl < p.S;
    const int from = mine ? __ldcg(p.stop + sl) : p.nsteps;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (!kDeltas && mine && from < p.nsteps) {
        const float* q = (const float*)p.out + 3 * ((size_t)(from - 1) * p.S
                                                    + sl);
        fx = __ldcg(q);
        fy = __ldcg(q + 1);
        fz = __ldcg(q + 2);
    }
    int u = from;
    for (int off = 16; off > 0; off >>= 1)
        u = min(u, __shfl_xor_sync(kFull, u, off));
    for (; u < p.nsteps; ++u) {
        if (u < from)
            continue;
        const size_t o = (size_t)u * p.S + sl;
        prop::store3<kDeltas>(p.out, o, fx, fy, fz);
        p.saved[o] = 0;
    }
}

template <typename Idx, bool kDeltas>
__global__ void __launch_bounds__(kThreads)
micro_kernel(const MicroParams p)
{
    extern __shared__ float4 smem[];
    const int lane = threadIdx.x & 31;
    Window win;
    win.dx = (float*)smem;
    win.dy = win.dx + p.tile;
    win.dz = win.dy + p.tile;
    win.ox = (int*)(win.dz + p.tile);
    win.oy = win.ox + p.tile;
    win.oz = win.oy + p.tile;
    const int ntiles = (p.W + p.tile - 1) / p.tile;
    const bool tiled = ntiles > 1;          // the same for the whole block
    if (!tiled) {
        load_tile<Idx>(p, win, 0, p.W);
        __syncthreads();
    }

    int s = -1;                             // the warp's stream, -1: none
    bool drained = false;                   // no stream left to take
    float px = 0.f, py = 0.f, pz = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    int n = 0, t = 0;
    for (;;) {
        if (s < 0 && !drained) {
            int got = 0;
            if (lane == 0)
                got = atomicAdd(p.next, 1);
            got = __shfl_sync(kFull, got, 0);
            if (got < p.S) {
                s = got;
                px = p.pos0[3 * s];
                py = p.pos0[3 * s + 1];
                pz = p.pos0[3 * s + 2];
                vx = p.vec0[3 * s];
                vy = p.vec0[3 * s + 1];
                vz = p.vec0[3 * s + 2];
                qx = px;
                qy = py;
                qz = pz;
                n = p.npts0[s];
                t = 0;
            } else {
                drained = true;
            }
        }
        const bool have = s >= 0;
        if (tiled) {
            if (!__syncthreads_or(have))
                break;
        } else if (!have) {
            break;
        }

        // step t of stream s (a warp without a stream only keeps the
        // block's barriers of a tiled window)
        const float nxp = __fadd_rn(px, __fmul_rn(vx, p.step));
        const float nyp = __fadd_rn(py, __fmul_rn(vy, p.step));
        const float nzp = __fadd_rn(pz, __fmul_rn(vz, p.step));
        const Idx ix = voxel<Idx>(nxp);
        const Idx iy = voxel<Idx>(nyp);
        const Idx iz = voxel<Idx>(nzp);
        bool inb;
        const Idx flat = prop::flat_index(ix, iy, iz, p.nx, p.ny, p.nz, inb);
        const bool inmask = have && inb && __ldg(p.mask + flat);

        Best b;
        for (int tile = 0; tile < ntiles; ++tile) {
            const int base = tile * p.tile;
            const int tn = min(p.tile, p.W - base);
            if (tiled) {
                __syncthreads();
                load_tile<Idx>(p, win, base, tn);
                __syncthreads();
            }
            if (!have)
                continue;
            const int padded = (tn + kSpan - 1) / kSpan * kSpan;
            for (int at = 0; at < padded; at += kMaskCells) {
                // the cone test of every cell, a bit each
                const int spans = min(kMaskCells, padded - at) / kSpan;
                unsigned bits = 0;
                for (int g = 0; g < spans; ++g) {
                    const int k = (at + g * kSpan) / 4 + lane;
                    const float4 x = ((const float4*)win.dx)[k];
                    const float4 y = ((const float4*)win.dy)[k];
                    const float4 z = ((const float4*)win.dz)[k];
                    const float sc = p.search_cos;
                    const unsigned four =
                        (unsigned)(dot3_nz(vx, vy, vz, x.x, y.x, z.x) > sc)
                        | (unsigned)(dot3_nz(vx, vy, vz, x.y, y.y, z.y)
                                     > sc) << 1
                        | (unsigned)(dot3_nz(vx, vy, vz, x.z, y.z, z.z)
                                     > sc) << 2
                        | (unsigned)(dot3_nz(vx, vy, vz, x.w, y.w, z.w)
                                     > sc) << 3;
                    bits |= four << (4 * g);
                }
                // then the cells in the cone
                while (__any_sync(kFull, bits))
                    take_cell(p, win, bits, at, base + at, ix, iy, iz, vx,
                              vy, vz, b);
            }
        }
        if (!have)
            continue;

        // the warp's argmax: the largest cabs, the lowest cell among equals
        float best = b.cabs;
        int bi = b.cell;
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(kFull, best, off);
            const int oi = __shfl_xor_sync(kFull, bi, off);
            if (ov > best || (ov == best && oi < bi)) {
                best = ov;
                bi = oi;
            }
        }
        float bc = -INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
        int box = 0, boy = 0, boz = 0;
        if (best != -INFINITY) {            // else no cell counts: stop
            const int src = __ffs(__ballot_sync(
                kFull, b.cabs == best && b.cell == bi)) - 1;
            bc = __shfl_sync(kFull, b.c, src);
            bx = __shfl_sync(kFull, b.x, src);
            by = __shfl_sync(kFull, b.y, src);
            bz = __shfl_sync(kFull, b.z, src);
            box = __shfl_sync(kFull, b.ox, src);
            boy = __shfl_sync(kFull, b.oy, src);
            boz = __shfl_sync(kFull, b.oz, src);
        }

        const bool save = inb && inmask && isfinite(bc);
        n += save;
        const size_t o = (size_t)t * p.S + s;
        float ox, oy, oz;
        prop::point_out<kDeltas>(save, px, py, pz, qx, qy, qz, p.qscale,
                                 p.qstep, p.dmax, ox, oy, oz);
        if (lane < 3)
            store1<kDeltas>(p.out, 3 * o + lane,
                            lane == 0 ? ox : lane == 1 ? oy : oz);
        else if (lane == 3)
            p.saved[o] = save;
        ++t;

        const bool pos_side = bc > 0.f;
        const float wx = pos_side ? bx : -bx;
        const float wy = pos_side ? by : -by;
        const float wz = pos_side ? bz : -bz;
        const bool cont = save
            && dot3(vx, vy, vz, wx, wy, wz) >= p.cos_thresh
            && n <= p.len_max;
        if (cont) {
            px = (float)(ix + (Idx)box);
            py = (float)(iy + (Idx)boy);
            pz = (float)(iz + (Idx)boz);
            prop::smooth_dir(vx, vy, vz, wx, wy, wz, p.sc, p.sc1, p.smooth);
        }
        if (cont && t < p.nsteps)
            continue;
        // stopped (or out of steps)
        if (lane == 0) {
            p.npts[s] = n;
            p.pos_q[3 * s] = qx;
            p.pos_q[3 * s + 1] = qy;
            p.pos_q[3 * s + 2] = qz;
        }
        stopped<kDeltas>(p, s, t);
        s = -1;
    }
}

template <typename Idx, bool kDeltas>
cudaError_t launch(const MicroParams& p, cudaStream_t st)
{
    const auto kernel = micro_kernel<Idx, kDeltas>;
    const size_t smem = (size_t)p.tile * 6 * 4;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, smem);
    if (!err && per_sm < 1)
        err = cudaErrorInvalidConfiguration;
    if (!err)                   // the stream counter and the group counts
        err = cudaMemsetAsync(p.next, 0,
                              sizeof(int) * (1 + (p.S + 31) / 32), st);
    if (err)
        return err;
    // the resident capacity, fewer when the streams do not fill it
    const int blocks = std::min(per_sm * sms, (p.S + kWarps - 1) / kWarps);
    kernel<<<blocks, kThreads, smem, st>>>(p);
    return cudaGetLastError();
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

// Launch one direction on `stream` (a cudaStream_t): a memset of the
// counters at the head of `scratch` (1 + ceil(S / 32) + S ints of device
// memory: the stream counter, the groups' counts, the streams' steps) and
// the kernel.  Returns a cudaError_t, 0 when both were accepted.  Does
// not synchronise.  S >= 1, nsteps >= 1, W >= 1; mask, vfirst over nx *
// ny * nz voxels; index_bits 32 (fewer than 2^31 voxels, each dimension
// below 2^29) or 64.
int propagate_micro_launch(const float* pos0, const float* vec0,
                           const int* npts0, const void* mask,
                           const float* vfirst, const long long* woff,
                           const float* wdir, int S, int nsteps, int W,
                           int nx, int ny, int nz, float step,
                           float cos_thresh, float search_cos, float sc,
                           float sc1, int smooth, int len_max, int deltas,
                           float qscale, float qstep, float dmax, void* out,
                           void* saved, int* npts, float* pos_q,
                           int* scratch, int index_bits, void* stream)
{
    const int tile = (std::min(W, kTile) + kSpan - 1) / kSpan * kSpan;
    int* next = scratch;
    int* done = scratch + 1;
    int* stop = done + (S + 31) / 32;
    const MicroParams p{pos0, vec0, npts0, (const uint8_t*)mask, vfirst,
                        woff, wdir, S, nsteps, W, tile, nx, ny, nz, step,
                        cos_thresh, search_cos, sc, sc1, smooth, len_max,
                        qscale, qstep, dmax, out, (uint8_t*)saved, npts,
                        pos_q, next, done, stop};
    const cudaStream_t st = (cudaStream_t)stream;
    if (index_bits == 32)
        return (int)(deltas ? launch<int, true>(p, st)
                            : launch<int, false>(p, st));
    if (index_bits == 64)
        return (int)(deltas ? launch<long long, true>(p, st)
                            : launch<long long, false>(p, st));
    return (int)cudaErrorInvalidValue;
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
