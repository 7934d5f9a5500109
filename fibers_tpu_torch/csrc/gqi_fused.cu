// Fused GQI reconstruction tile for Hopper (sm_90a): 3xTF32 tensor cores.
//
// Replaces the Pallas TPU kernel fibers_tpu/ops/pallas/gqi_fused.py:43-111
// (`gqi_fused`, body `_kernel`).  Per block of BM voxel rows it computes
//   - the ODF tile max(s, 0) @ A_t at f32-equivalent precision (the
//     reference runs it at Precision.HIGHEST);
//   - the strict local-max mask over face neighbours (an invalid
//     neighbour counts as -inf; fibers_tpu/ops/peaks.py peak_mask);
//   - per-row stats (ODF min, ODF mean, valid = max(s) > 0);
//   - the three largest entries of where(peak, odf, 0), descending, ties
//     to the lower vertex index (as lax.top_k), which the TPU model ran
//     as a separate top_k pass.
// NaN follows the reference: the clamp keeps NaN, a row holding a NaN has
// a NaN ODF, NaN min and mean, no peak, and is not valid.
//
// Bounds on an H100 SXM at the main path's shapes (N = 720,896, nvol =
// 198, nvert = 321): the product is 2*N*nvol*nvert = 91.6 GFLOP.
//   - in FP32 FMA: 91.6 GFLOP / 67 TFLOP/s = 1.37 ms;
//   - in 3xTF32 (this route): 3 x 91.6 GFLOP / 495 TFLOP/s = 0.56 ms,
//     against ~1.76 GB of bytes (0.57 GB of signals in; 0.93 GB of ODF,
//     0.23 GB of mask and 0.03 GB of stats and top-3 out) / 3.35 TB/s =
//     0.53 ms.
// What the design does about each cost of the first (plain FP32) design:
//   - Tensor cores in 3xTF32: each operand splits as x = hi + lo, both
//     TF32 (cvt.rna), and each k8 step sums lo*hi + hi*lo + hi*hi in one
//     chain of mma.sync.m16n8k8 (f32 accumulate) started from zero.  The
//     step's sum is added to the f32 accumulator with an ordinary FADD,
//     so the tensor core's own accumulation rounds over 8 products only
//     and the long sum over k rounds to nearest.  The dropped lo*lo term
//     and lo's own rounding are ~2^-22 of each product.
//   - Staging: a small pack kernel pads A_t to [K8, 112 * column groups]
//     (16-byte rows) and packs the neighbour table once per call.  The
//     block's raw signal rows stay in shared memory for the whole K (all
//     in flight at once through cp.async; the NaN-keeping clamp is applied
//     as fragments are read), and A_t streams through a 2-stage ring of
//     16-byte cp.async in chunks of KC = 32 rows.  BM = 128 rows per block
//     (96 at nvert = 362), so the A_t re-reads from L2 are ~1.5 GB instead
//     of 5.7 GB.
//   - Shared-memory traffic: a warp owns 32 rows x 112 columns (2 x 14
//     m16n8 tiles, 112 f32 accumulators a thread); each B fragment feeds
//     2 row tiles and each A fragment 14 column tiles.  Row strides are
//     4 (mod 8) words for the signals and 8 or 24 (mod 32) for A_t, so
//     every fragment load hits 32 banks.
//   - Columns: 3 x 112 = 336 computed for nvert = 321 (2 x 112 at 181,
//     4 x 112 at 362), not 6 x 64 = 384.
//   - Epilogue: the ODF tile lands in shared memory over the staging
//     buffers and goes out with 16-byte streaming stores of the block's
//     contiguous rows.  Then a thread per (row, range of 32-vertex words),
//     its lanes across rows: the neighbour gathers o[r][nbr[v][k]] hit 32
//     banks (odd nvert) and each vertex's 8 neighbour slots are one
//     broadcast 16-byte load, unrolled to maxdeg.  It keeps min, sum and
//     a top-3, and sets peak bits in shared memory; a thread per row
//     merges the ranges, and the mask goes out from the bits in 16-byte
//     stores.
// Measured on an H100 SXM at 700 W (PERF.md §6): 3.3-3.5 ms at the main
// path's shapes.  Builds without its parts (probe_paths.py --paths gqi)
// put ~2.0 ms in the product (each of the three mma.sync passes ~0.48
// ms: mma.sync TF32 runs near half the dense TF32 peak), ~0.64 ms in the
// epilogue, and ~0.79 ms in staging the signals, writing the ODF and
// fixed per-block work; one block per SM runs these in turn.  Tried and
// slower: 2 blocks of 64 rows per SM, 16-row warp tiles (24 warps),
// 2-step A_t chunks, and a persistent grid that prefetched the next tile
// during the epilogue.  Left for later: wgmma (twice mma.sync's TF32
// rate), whose sum stays in the tensor core: that alone gives about
// twice the plain f32 product's error, so it needs chunked accumulators.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MT = 2;                 // m16 row tiles per warp
constexpr int NT = 14;                // n8 column tiles per warp
constexpr int WROWS = 16 * MT;        // 32 rows per warp
constexpr int WCOLS = 8 * NT;         // 112 columns per warp
constexpr int KSTEPS = 4;             // k8 steps per staged A_t chunk
constexpr int KC = 8 * KSTEPS;        // A_t rows per chunk
constexpr int MAX_WARPS = 12;
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int MAX_ROW_GROUPS = 4;     // at most 128 rows per block
constexpr int MAXDEG = 8;             // neighbour slots per vertex
constexpr int NPEAK = 3;
constexpr int NPART = 2 + 2 * NPEAK;  // min, sum, top-3 values, indices

struct Config {
    int cg, rg, bm;       // column groups, row groups, rows per block
    int nk8, sa, sb, ncol, words;
    long alias, off_valid, off_nbr, off_bits, off_part, smem;  // bytes
};

long align16(long b) { return (b + 15) / 16 * 16; }

// The block shape for these sizes: the most rows per block (up to 128)
// whose shared memory fits `optin` bytes.  False if none does.
bool choose(int nvol, int nvert, long optin, Config& c)
{
    const int ntiles = (nvert + 7) / 8;
    c.cg = (ntiles + NT - 1) / NT;
    if (c.cg > MAX_WARPS) return false;
    c.nk8 = (nvol + 7) / 8;
    c.sa = c.nk8 * 8 + 4;                 // 4 (mod 8): conflict-free A
    c.ncol = c.cg * WCOLS;
    c.sb = c.ncol + 8;                    // 8 or 24 (mod 32): free B
    c.words = (nvert + 31) / 32;
    int rg = MAX_WARPS / c.cg;
    if (rg > MAX_ROW_GROUPS) rg = MAX_ROW_GROUPS;
    for (; rg >= 1; --rg) {
        c.rg = rg;
        c.bm = rg * WROWS;
        const long staging = 4L * ((long)c.bm * c.sa + 2L * KC * c.sb);
        const long odf = 4L * c.bm * nvert;
        c.alias = align16(staging > odf ? staging : odf);
        c.off_valid = c.alias;
        c.off_nbr = c.off_valid + align16(4L * c.bm);
        c.off_bits = c.off_nbr + 2L * MAXDEG * nvert;
        c.off_part = c.off_bits + align16(4L * c.bm * c.words);
        c.smem = c.off_part + 4L * (32 * c.cg / WROWS) * NPART * c.bm;
        if (c.smem <= optin) return true;
    }
    return false;
}

// max and min that return NaN when either input is NaN, as jnp.maximum,
// amax and amin do
__device__ __forceinline__ float max_nan(float a, float b)
{
    float y;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
    return y;
}

__device__ __forceinline__ float min_nan(float a, float b)
{
    float y;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
    return y;
}

__device__ __forceinline__ float clamp0(float x) { return max_nan(x, 0.f); }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    const float r = x - __uint_as_float(hi);       // exact
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of BYTES (4, 8 or 16) bytes; zero-filled when !ok
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                     :: "r"(d), "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// (a, ia) ranks before (b, ib): larger value, then lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib)
{
    return a > b || (a == b && ia < ib);
}

// (v, i) into a list sorted by `better`; branch-free, as lanes diverge
__device__ __forceinline__ void insert3(float (&tv)[NPEAK],
                                        int (&ti)[NPEAK], float v, int i)
{
    const bool b0 = better(v, i, tv[0], ti[0]);
    const bool b1 = better(v, i, tv[1], ti[1]);
    const bool b2 = better(v, i, tv[2], ti[2]);
    tv[2] = b1 ? tv[1] : (b2 ? v : tv[2]);
    ti[2] = b1 ? ti[1] : (b2 ? i : ti[2]);
    tv[1] = b0 ? tv[0] : (b1 ? v : tv[1]);
    ti[1] = b0 ? ti[0] : (b1 ? i : ti[1]);
    tv[0] = b0 ? v : tv[0];
    ti[0] = b0 ? i : ti[0];
}

// One thread's share of the epilogue for one row `o`: vertices of the
// 32-vertex words [w0, w1) in ascending order.  Peak bits into
// bits_out[w]; the row's min and sum and the top-3 of where(peak, odf, 0)
// accumulate.  D = maxdeg slots per vertex, each a valid neighbour (a
// vertex with fewer repeats one, which leaves the max alone); slot 0 is
// -1 for a vertex with none.
template <int D>
__device__ __forceinline__ void scan_vertices(
    const float* __restrict__ o, const int4* __restrict__ nb4,
    uint32_t* __restrict__ bits_out, int w0, int w1, int nvert, float& mn,
    float& sum, float (&tv)[NPEAK], int (&ti)[NPEAK])
{
    for (int w = w0; w < w1; ++w) {
        uint32_t bits = 0;
        const int vend = min(32, nvert - 32 * w);
#pragma unroll 4
        for (int bit = 0; bit < vend; ++bit) {
            const int v = 32 * w + bit;
            const int4 nb = nb4[v];               // the same for all lanes
            const int sl[4] = {nb.x, nb.y, nb.z, nb.w};
            const float x = o[v];
            float m = -INFINITY;
            if ((int16_t)sl[0] >= 0) {
#pragma unroll
                for (int q = 0; q < D; ++q) {
                    const int e = (q & 1) ? (sl[q >> 1] >> 16)
                                          : (int)(int16_t)sl[q >> 1];
                    m = max_nan(m, o[e]);
                }
            }
            const bool p = x > m;     // false on NaN, as amax propagates it
            bits |= (uint32_t)p << bit;
            mn = min_nan(mn, x);
            sum += x;
            const float val = p ? x : 0.f;
            if (better(val, v, tv[2], ti[2])) insert3(tv, ti, val, v);
        }
        bits_out[w] = bits;
    }
}

// Once per call, into the scratch buffer: A_t zero-padded to [kpad, ncol]
// (rows of 16-byte multiples), and the neighbour table as MAXDEG int16
// slots per vertex: its valid neighbours, then the first of them repeated
// (which leaves a max alone); -1 if it has none.
__global__ void gqi_pack_kernel(const float* __restrict__ a_t,
                                const int* __restrict__ nbr,
                                const uint8_t* __restrict__ nbr_ok,
                                float* __restrict__ apad,
                                int16_t* __restrict__ nbr8, int nvol,
                                int nvert, int maxdeg, int kpad, int ncol)
{
    const int stride = gridDim.x * blockDim.x;
    const int first = blockIdx.x * blockDim.x + threadIdx.x;
    for (int i = first; i < kpad * ncol; i += stride) {
        const int k = i / ncol, col = i - k * ncol;
        apad[i] = (k < nvol && col < nvert) ? a_t[k * nvert + col] : 0.f;
    }
    for (int v = first; v < nvert; v += stride) {
        int16_t* sl = nbr8 + v * MAXDEG;
        int cnt = 0;
        for (int k = 0; k < maxdeg; ++k)
            if (nbr_ok[v * maxdeg + k])
                sl[cnt++] = (int16_t)nbr[v * maxdeg + k];
        const int16_t fill = cnt ? sl[0] : (int16_t)-1;
        for (int k = cnt; k < MAXDEG; ++k) sl[k] = fill;
    }
}

// padded A_t rows [c*KC, min(c*KC + KC, kpad)) into ring stage `st`
__device__ __forceinline__ void stage_b(float* sB, const float* apad, int c,
                                        int st, int kpad, int ncol, int sb)
{
    float* dst = sB + (long)st * KC * sb;
    const int krows = min(KC, kpad - c * KC), n4 = ncol / 4;
    const float* src = apad + (long)c * KC * ncol;
    for (int i = threadIdx.x; i < krows * n4; i += blockDim.x) {
        const int kk = i / n4, c4 = i - kk * n4;
        cp_async<16>(dst + kk * sb + 4 * c4, src + kk * ncol + 4 * c4, true);
    }
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
gqi_fused_kernel(const float* __restrict__ sig,
                 const float* __restrict__ apad,
                 const int16_t* __restrict__ nbr8,
                 float* __restrict__ odf,
                 uint8_t* __restrict__ peak,
                 float* __restrict__ stats,
                 float* __restrict__ vals,
                 long long* __restrict__ idx,
                 int n, int nvol, int nvert, int maxdeg, Config cf)
{
    extern __shared__ float4 smem4[];
    char* smem = reinterpret_cast<char*>(smem4);
    float* sA = reinterpret_cast<float*>(smem);          // [bm][sa]
    float* sB = sA + (long)cf.bm * cf.sa;                 // [2][KC][sb]
    float* sO = reinterpret_cast<float*>(smem);          // [bm][nvert]
    float* sValid = reinterpret_cast<float*>(smem + cf.off_valid);
    int16_t* sNbr = reinterpret_cast<int16_t*>(smem + cf.off_nbr);
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + cf.off_bits);
    float* sPart = reinterpret_cast<float*>(smem + cf.off_part);

    const int tid = threadIdx.x, nth = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nwarps = nth >> 5;
    const int nchunks = (cf.nk8 + KSTEPS - 1) / KSTEPS;

    const int kpad = cf.nk8 * 8;
    const long row0 = (long)blockIdx.x * cf.bm;
    const int rows = (int)min((long)cf.bm, (long)n - row0);
    for (int v = tid; v < nvert; v += nth)
        cp_async<16>(sNbr + v * MAXDEG, nbr8 + v * MAXDEG, true);
    // the block's signal rows, raw (the clamp is applied where they are
    // read), all in flight at once, a warp per row; zero past nvol to the
    // padded K and past the last row; 8-byte copies where rows allow
    const bool pairs = (nvol % 2) == 0
        && (reinterpret_cast<uintptr_t>(sig) & 7) == 0;
    for (int r = warp; r < cf.bm; r += nwarps) {
        const float* src = sig + (row0 + (r < rows ? r : 0)) * nvol;
        float* dst = sA + r * cf.sa;
        if (pairs) {
            for (int k = 2 * lane; k < kpad; k += 64) {
                const bool ok = r < rows && k < nvol;
                cp_async<8>(dst + k, ok ? src + k : sig, ok);
            }
        } else {
            for (int k = lane; k < kpad; k += 32) {
                const bool ok = r < rows && k < nvol;
                cp_async<4>(dst + k, ok ? src + k : sig, ok);
            }
        }
    }
    stage_b(sB, apad, 0, 0, kpad, cf.ncol, cf.sb);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // valid = max(s) > 0, false where the row holds a NaN
    for (int r = warp; r < rows; r += nwarps) {
        const float* a = sA + r * cf.sa;
        float mx = 0.f;
        for (int k = lane; k < nvol; k += 32) mx = max_nan(mx, a[k]);
        for (int off = 16; off > 0; off >>= 1)
            mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane == 0) sValid[r] = mx > 0.f ? 1.f : 0.f;  // NaN: false
    }

    // the product: warp (rg, cgi) owns rows wr.. +32, columns wc.. +112
    const int wr = (warp / cf.cg) * WROWS, wc = (warp % cf.cg) * WCOLS;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) {
            stage_b(sB, apad, c + 1, (c + 1) & 1, kpad, cf.ncol, cf.sb);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* bst = sB + (long)(c & 1) * KC * cf.sb;
        const int nks = min(KSTEPS, cf.nk8 - c * KSTEPS);
        // not unrolled: fragments of later steps hoisted here would spill
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
            const int k0 = c * KC + ks * 8;
            uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const float* a = sA + (wr + mt * 16 + g) * cf.sa + k0 + t;
                split_tf32(clamp0(a[0]), ahi[mt][0], alo[mt][0]);
                split_tf32(clamp0(a[8 * cf.sa]), ahi[mt][1], alo[mt][1]);
                split_tf32(clamp0(a[4]), ahi[mt][2], alo[mt][2]);
                split_tf32(clamp0(a[8 * cf.sa + 4]), ahi[mt][3],
                           alo[mt][3]);
            }
            const float* b = bst + (ks * 8 + t) * cf.sb + wc + g;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(b[j * 8], bh0, bl0);
                split_tf32(b[4 * cf.sb + j * 8], bh1, bl1);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    float d[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_tf32(d, alo[mt], bh0, bh1);
                    mma_tf32(d, ahi[mt], bl0, bl1);
                    mma_tf32(d, ahi[mt], bh0, bh1);
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[mt][j][q] += d[q];
                }
            }
        }
        __syncthreads();
    }

    // ODF tile into shared memory, over the staging buffers
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int r = wr + mt * 16 + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int col = wc + j * 8 + 2 * t;
            if (col < nvert) {
                sO[r * nvert + col] = acc[mt][j][0];
                sO[(r + 8) * nvert + col] = acc[mt][j][2];
            }
            if (col + 1 < nvert) {
                sO[r * nvert + col + 1] = acc[mt][j][1];
                sO[(r + 8) * nvert + col + 1] = acc[mt][j][3];
            }
        }
    }
    __syncthreads();

    // the block's ODF rows are contiguous: one streaming copy
    {
        float* dst = odf + row0 * nvert;
        const int total = rows * nvert;
        int done = 0;
        if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
            const int n4 = total / 4;
            for (int i = tid; i < n4; i += nth)
                __stcs(reinterpret_cast<float4*>(dst) + i,
                       reinterpret_cast<const float4*>(sO)[i]);
            done = 4 * n4;
        }
        for (int i = done + tid; i < total; i += nth)
            __stcs(dst + i, sO[i]);
    }

    // a thread per (row, range of 32-vertex words): lanes run over rows,
    // so the gathers o[r][nbr[v][k]] spread over the banks and each
    // neighbour index is one broadcast
    const int nrange = nth / cf.bm;
    {
        const int r = tid % cf.bm, j = tid / cf.bm;
        const int w0 = j * cf.words / nrange;
        const int w1 = (j + 1) * cf.words / nrange;
        float mn = INFINITY, sum = 0.f;
        float tv[NPEAK] = {-INFINITY, -INFINITY, -INFINITY};
        int ti[NPEAK] = {INT32_MAX, INT32_MAX, INT32_MAX};
        if (r < rows) {
            const float* o = sO + r * nvert;
            const int4* nb4 = reinterpret_cast<const int4*>(sNbr);
            uint32_t* bo = sBits + r * cf.words;
            switch (maxdeg) {
#define GQI_SCAN(D)                                             \
            case D:                                             \
                scan_vertices<D>(o, nb4, bo, w0, w1, nvert, mn, \
                                 sum, tv, ti);                  \
                break;
            GQI_SCAN(1) GQI_SCAN(2) GQI_SCAN(3) GQI_SCAN(4)
            GQI_SCAN(5) GQI_SCAN(6) GQI_SCAN(7) GQI_SCAN(8)
#undef GQI_SCAN
            }
        }
        float* part = sPart + (long)j * NPART * cf.bm + r;
        part[0] = mn;
        part[cf.bm] = sum;
#pragma unroll
        for (int q = 0; q < NPEAK; ++q) {
            part[(2 + q) * cf.bm] = tv[q];
            part[(2 + NPEAK + q) * cf.bm] = __int_as_float(ti[q]);
        }
    }
    __syncthreads();

    // a thread per row merges its ranges: stats and top-3
    if (tid < rows) {
        const float* part = sPart + tid;
        float mn = INFINITY, sum = 0.f;
        float tv[NPEAK] = {-INFINITY, -INFINITY, -INFINITY};
        int ti[NPEAK] = {INT32_MAX, INT32_MAX, INT32_MAX};
        for (int j = 0; j < nrange; ++j, part += NPART * cf.bm) {
            mn = min_nan(mn, part[0]);
            sum += part[cf.bm];
#pragma unroll
            for (int q = 0; q < NPEAK; ++q)
                insert3(tv, ti, part[(2 + q) * cf.bm],
                        __float_as_int(part[(2 + NPEAK + q) * cf.bm]));
        }
        const long row = row0 + tid;
        stats[row * 3 + 0] = mn;
        stats[row * 3 + 1] = sum / (float)nvert;
        stats[row * 3 + 2] = sValid[tid];
#pragma unroll
        for (int q = 0; q < NPEAK; ++q) {
            vals[row * NPEAK + q] = tv[q];
            idx[row * NPEAK + q] = ti[q];
        }
    }

    // the peak mask from the bits, 16 bytes a thread where aligned
    {
        uint8_t* dst = peak + row0 * nvert;
        const int total = rows * nvert;
        int done = 0;
        if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
            const int n16 = total / 16;
            for (int i = tid; i < n16; i += nth) {
                int r = 16 * i / nvert, v = 16 * i - r * nvert;
                uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int q = 0; q < 16; ++q) {
                    const uint32_t b =
                        (sBits[r * cf.words + (v >> 5)] >> (v & 31)) & 1u;
                    w[q >> 2] |= b << (8 * (q & 3));
                    if (++v == nvert) {
                        v = 0;
                        ++r;
                    }
                }
                __stcs(reinterpret_cast<uint4*>(dst) + i,
                       make_uint4(w[0], w[1], w[2], w[3]));
            }
            done = 16 * n16;
        }
        for (int i = done + tid; i < total; i += nth) {
            const int r = i / nvert, v = i - r * nvert;
            dst[i] = (sBits[r * cf.words + (v >> 5)] >> (v & 31)) & 1u;
        }
    }
}

// The block shape on the current device: cudaSuccess, or why there is
// none (cudaErrorInvalidValue when the sizes do not fit).
cudaError_t device_config(int nvol, int nvert, int maxdeg, Config& c)
{
    if (nvol <= 0 || nvert < NPEAK || maxdeg <= 0 || maxdeg > MAXDEG ||
        nvert > 32767)
        return cudaErrorInvalidValue;
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    return choose(nvol, nvert, optin, c) ? cudaSuccess
                                         : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of scratch device memory `gqi_fused_launch` takes: the padded
// A_t, then the neighbour slots.
long gqi_fused_scratch_bytes(int nvol, int nvert)
{
    const long kpad = (nvol + 7) / 8 * 8;
    const long ncol = ((nvert + 7) / 8 + NT - 1) / NT * WCOLS;
    return 4 * kpad * ncol + 2L * MAXDEG * nvert;
}

// Dynamic shared memory one block needs, in bytes; -1 when no block
// shape fits.
long gqi_fused_smem_bytes(int nvol, int nvert, int maxdeg)
{
    Config c;
    return device_config(nvol, nvert, maxdeg, c) == cudaSuccess ? c.smem
                                                                 : -1;
}

// Voxel rows per block for these sizes (0 when none fits).
int gqi_fused_rows_per_block(int nvol, int nvert, int maxdeg)
{
    Config c;
    return device_config(nvol, nvert, maxdeg, c) == cudaSuccess ? c.bm : 0;
}

// Launch on `stream` (a cudaStream_t): the pack kernel into `scratch`
// (gqi_fused_scratch_bytes, 16-byte aligned), then the tile kernel.
// Returns a cudaError_t: 0 when both launches were accepted.  Does not
// synchronise.
int gqi_fused_launch(const float* sig, const float* a_t, const int* nbr,
                     const uint8_t* nbr_ok, float* odf, uint8_t* peak,
                     float* stats, float* vals, long long* idx,
                     void* scratch, int n, int nvol, int nvert, int maxdeg,
                     void* stream)
{
    if (n <= 0) return (int)cudaSuccess;
    Config c;
    cudaError_t err = device_config(nvol, nvert, maxdeg, c);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gqi_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)c.smem);
    if (err != cudaSuccess) return (int)err;
    float* apad = static_cast<float*>(scratch);
    int16_t* nbr8 = reinterpret_cast<int16_t*>(
        static_cast<char*>(scratch) + 4L * c.nk8 * 8 * c.ncol);
    gqi_pack_kernel<<<64, 256, 0, (cudaStream_t)stream>>>(
        a_t, nbr, nbr_ok, apad, nbr8, nvol, nvert, maxdeg, c.nk8 * 8,
        c.ncol);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((n + (long)c.bm - 1) / c.bm);
    gqi_fused_kernel<<<grid, 32 * c.rg * c.cg, (size_t)c.smem,
                       (cudaStream_t)stream>>>(
        sig, apad, nbr8, odf, peak, stats, vals, idx, n, nvol, nvert,
        maxdeg, c);
    return (int)cudaGetLastError();
}

}  // extern "C"
