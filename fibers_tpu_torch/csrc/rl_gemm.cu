// RUMBA-SD's Richardson-Lucy products on Hopper's bf16 tensor cores
// (sm_90a): C[M, N] f32 = A[M, K] f32 @ B[K, N] f32 in the reference's
// matrix-unit arithmetic.
//
// Replaces the three products of the reference's iteration program,
// fibers_tpu/models/rumba.py:343 _rumba_step_core (XLA): rl_num =
// (signal * iratio) @ kernel and rl_den = dodf @ kernel (:360-361), and
// dodf = fodf @ kernel.T (:379), which it runs as jnp.dot(...,
// precision=hp) on the matrix unit (:46-55):
//   passes = 3 (precision "high", the default): each operand splits as
//     x = hi + lo, hi = bf16_rn(x), lo = bf16_rn(x - hi), and each k16
//     step sums lo_a*hi_b, hi_a*lo_b, hi_a*hi_b (small terms first, as
//     gqi_fused.cu's 3xTF32) in one chain of mma.sync.m16n8k16 started
//     from zero; the step's sum is added to the f32 accumulator with an
//     ordinary FADD, so the tensor core's own accumulation rounds over 48
//     products only and the long sum over K rounds to nearest.  The
//     dropped lo_a*lo_b term and lo's own rounding are ~2^-17 of each
//     product;
//   passes = 1 (precision "default"): hi_a*hi_b only, the product of
//     bf16-rounded operands with f32 accumulation.
// A row of A holding a NaN gives NaN in every column of its C row, as
// the f32 product does (bf16_rn keeps a NaN).  An infinite element of A
// gives NaN there (its lo is inf - inf), where the f32 product gives inf.
//
// Layout: a block owns BM rows and a column block of up to 384 columns
// (the grid's third index; one block at RUMBA's N): its warps form RG
// row groups of 32 rows (two m16 tiles) by CG = 4 column groups
// of NT n8 tiles, the accumulator tile in registers.  K runs in chunks of
// 32 (two k16 steps) through a 3-stage cp.async ring in shared memory:
// the A chunk as raw f32 (16-byte copies where K % 4 == 0 and A is
// 16-byte aligned, else 4-byte copies, so the 253-float signal rows need
// no alignment), zero-filled past K and past M; B as packed bf16 planes
// (rl_pack_kernel, once per matrix), fragment-ordered so that a lane's
// two words of an n8 tile are one 8-byte load and a warp's load is 256
// contiguous bytes.  A splits as its fragments are read (float2 loads at
// a row stride of 8 (mod 32) words, conflict-free), once per column group
// (a split once a chunk into shared memory, behind a second barrier a
// chunk, was tried and not kept: no faster over both routes).  After the
// loop the C tile goes into shared memory over the ring and out in one
// streaming copy of the block's rows, which are contiguous when one
// column block covers N (16-byte stores; the fragments' own 8-byte stores
// straddled the 1,456-byte rows' sectors).  Two A operands against one B
// (num and den) are one launch: the grid's second index picks the pair.
// Row indices are 64-bit.
//
// What bounds it on an H100: bytes.  At RUMBA config 4 (M = 715,200 rows,
// K x N = 253 x 364 and 364 x 253) one product reads 0.72 GB of A and
// writes 1.04 GB of C (0.53 ms at 3.35 TB/s); its 3 x 131.7 GFLOP take
// 0.40 ms at bf16's dense 989 TFLOP/s.  mma.sync reaches only part of
// that rate, one block an SM (168 registers) does not overlap its
// epilogue with its loop, and every block re-reads B's planes from L2 (a
// block holds BM = 96 rows at N = 364, 128 at N = 253): wgmma with TMA
// multicast of B across a cluster and a persistent grid is the redesign.
// What it reaches, and builds without its parts (probe_paths.py --paths
// rlgemm), are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CG = 4;                // column groups of warps
constexpr int MT = 2;                // m16 tiles per warp
constexpr int KS = 2;                // k16 steps per chunk
constexpr int BK = 16 * KS;          // K per chunk
constexpr int SA = BK + 8;           // A row stride: 8 (mod 32) words
constexpr int NSTAGE = 3;
constexpr int COLS = CG * 12 * 8;    // columns of a column block, 384

// RG row groups: three at NT = 12 (96 accumulators a thread, 384
// threads), four below (512 threads)
template <int NT> struct Shape {
    static constexpr int RG = NT > 8 ? 3 : 4;
    static constexpr int THREADS = 32 * RG * CG;
    static constexpr int BM = 16 * MT * RG;
    static constexpr int NTP = CG * NT;          // n8 tiles in a plane
};

// the n8 tiles a warp owns for an N: the least of 2, 4, 8, 12 that covers
// a column block with CG column groups
int tiles_for(int n)
{
    const int need = ((n < COLS ? n : COLS) + 31) / 32;
    return need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 12;
}

// uint2 words of one column block's plane
long long block_words(int k, int n)
{
    return (long long)((k + 15) / 16) * (CG * tiles_for(n)) * 32;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// the bf16 halves of a packed pair as floats (exact)
__device__ __forceinline__ float low_f(uint32_t w)
{
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float high_f(uint32_t w)
{
    return __uint_as_float(w & 0xffff0000u);
}

// a pair of f32 (lower column first) split into packed hi and lo halves
__device__ __forceinline__ void split2(float2 v, uint32_t& hi, uint32_t& lo)
{
    hi = pack_bf16(v.x, v.y);
    lo = pack_bf16(v.x - low_f(hi), v.y - high_f(hi));  // exact differences
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint2 b)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// cp.async of BYTES (4 or 16) bytes; zero-filled when !ok
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
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

// B [k, n] f32 row-major into its packed planes [ncb][nks][ntp][32] of
// uint2: for column block cb, k16 step s, n8 tile j and lane (g, t) of
// the mma fragment, the words {B[16s+2t][c], B[16s+2t+1][c]} and
// {B[16s+2t+8][c], B[16s+2t+9][c]}, c = 384 cb + 8j + g, as bf16 pairs,
// lower k in the low half; hi from bf16_rn(B), lo from bf16_rn(B - hi);
// zero past k and n.
__global__ void rl_pack_kernel(const float* __restrict__ b,
                               uint2* __restrict__ hi, uint2* __restrict__ lo,
                               int k, int n, int nks, int ntp,
                               long long total)
{
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int lane = (int)(i & 31);
        const long long q = i >> 5;
        const int j = (int)(q % ntp);
        const int s = (int)(q / ntp % nks);
        const int cb = (int)(q / ntp / nks);
        const int col = COLS * cb + 8 * j + (lane >> 2);
        const int k0 = 16 * s + 2 * (lane & 3);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int kk = k0 + (e & 1) + 8 * (e >> 1);
            v[e] = (col < n && kk < k) ? b[(long long)kk * n + col] : 0.f;
        }
        uint2 h, l;
        split2(make_float2(v[0], v[1]), h.x, l.x);
        split2(make_float2(v[2], v[3]), h.y, l.y);
        hi[i] = h;
        lo[i] = l;
    }
}

// one chunk (k16 steps [KS c, KS c + KS)) of A rows [row0, row0 + BM) and
// of the B planes into ring stage `st`
template <int PASSES, int NT>
__device__ __forceinline__ void stage_chunk(
    float* sA, uint2* sB, const float* __restrict__ a,
    const uint2* __restrict__ bhi, const uint2* __restrict__ blo,
    long long m, int k, int nks, long long row0, int c, int st, bool vec)
{
    using S = Shape<NT>;
    constexpr int PLANE = KS * S::NTP * 32;      // uint2 a plane a stage
    float* dA = sA + st * S::BM * SA;
    const int tid = threadIdx.x;
    const int kc = c * BK;
    if (vec) {
        for (int i = tid; i < S::BM * (BK / 4); i += S::THREADS) {
            const int r = i / (BK / 4), p = i % (BK / 4);
            const long long row = row0 + r;
            const int kk = kc + 4 * p;
            const bool ok = row < m && kk < k;
            cp_async<16>(dA + r * SA + 4 * p,
                         ok ? a + row * k + kk : a, ok);
        }
    } else {
        for (int i = tid; i < S::BM * BK; i += S::THREADS) {
            const int r = i / BK, q = i % BK;
            const long long row = row0 + r;
            const int kk = kc + q;
            const bool ok = row < m && kk < k;
            cp_async<4>(dA + r * SA + q, ok ? a + row * k + kk : a, ok);
        }
    }
    // the chunk's k16 steps are contiguous in each plane
    const int steps = min(KS, nks - c * KS);
    const int n16 = steps * S::NTP * 16;         // 16-byte pieces a plane
    const long long off = (long long)c * PLANE;
    uint2* dB = sB + st * (PASSES > 1 ? 2 : 1) * PLANE;
    for (int i = tid; i < n16; i += S::THREADS)
        cp_async<16>(dB + 2 * i, bhi + off + 2 * i, true);
    if (PASSES > 1)
        for (int i = tid; i < n16; i += S::THREADS)
            cp_async<16>(dB + PLANE + 2 * i, blo + off + 2 * i, true);
}

template <int PASSES, int NT>
__global__ void __launch_bounds__(Shape<NT>::THREADS, 1)
rl_gemm_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
               const uint2* __restrict__ bhi, const uint2* __restrict__ blo,
               float* __restrict__ c0, float* __restrict__ c1, long long m,
               int k, int n, int nks, int vec)
{
    using S = Shape<NT>;
    constexpr int PLANE = KS * S::NTP * 32;
    extern __shared__ float4 smem4[];
    float* sA = reinterpret_cast<float*>(smem4);     // [NSTAGE][BM][SA]
    uint2* sB = reinterpret_cast<uint2*>(sA + NSTAGE * S::BM * SA);

    const float* a = blockIdx.y ? a1 : a0;
    float* c = blockIdx.y ? c1 : c0;
    // this column block's planes and first column
    const long long cb_words = (long long)nks * S::NTP * 32;
    bhi += blockIdx.z * cb_words;
    blo += blockIdx.z * cb_words;
    const int col0 = COLS * blockIdx.z;
    const long long row0 = (long long)blockIdx.x * S::BM;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = (warp / CG) * (16 * MT);      // the warp's first row
    const int wt = (warp % CG) * NT;             // and first n8 tile
    const int nchunks = (nks + KS - 1) / KS;

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nchunks)
            stage_chunk<PASSES, NT>(sA, sB, a, bhi, blo, m, k, nks, row0, s,
                                    s, vec);
        cp_async_commit();
    }
    for (int ch = 0; ch < nchunks; ++ch) {
        cp_async_wait<NSTAGE - 2>();
        // chunk ch has landed, and every warp is done with chunk ch - 1,
        // whose stage the next copy refills
        __syncthreads();
        if (ch + NSTAGE - 1 < nchunks)
            stage_chunk<PASSES, NT>(sA, sB, a, bhi, blo, m, k, nks, row0,
                                    ch + NSTAGE - 1,
                                    (ch + NSTAGE - 1) % NSTAGE, vec);
        cp_async_commit();
        const int st = ch % NSTAGE;
        const float* As = sA + st * S::BM * SA;
        const uint2* Bh = sB + st * (PASSES > 1 ? 2 : 1) * PLANE;
        const int steps = min(KS, nks - ch * KS);
        // not unrolled: the next step's fragments hoisted here would spill
#pragma unroll 1
        for (int ks = 0; ks < steps; ++ks) {
            uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const float* p =
                    As + (wr + 16 * mt + g) * SA + 16 * ks + 2 * t;
                const float2 v[4] = {
                    *reinterpret_cast<const float2*>(p),
                    *reinterpret_cast<const float2*>(p + 8 * SA),
                    *reinterpret_cast<const float2*>(p + 8),
                    *reinterpret_cast<const float2*>(p + 8 * SA + 8)};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (PASSES > 1)
                        split2(v[q], ahi[mt][q], alo[mt][q]);
                    else
                        ahi[mt][q] = pack_bf16(v[q].x, v[q].y);
                }
            }
            const uint2* bh = Bh + (ks * S::NTP + wt) * 32 + lane;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const uint2 bhj = bh[32 * j];
                uint2 blj = bhj;
                if (PASSES > 1) blj = bh[PLANE + 32 * j];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    float d[4] = {0.f, 0.f, 0.f, 0.f};
                    if (PASSES > 1) {
                        mma_bf16(d, alo[mt], bhj);
                        mma_bf16(d, ahi[mt], blj);
                    }
                    mma_bf16(d, ahi[mt], bhj);
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[mt][j][q] += d[q];
                }
            }
        }
    }
    cp_async_wait<0>();
    // every warp is done with the ring: the C tile goes over it
    __syncthreads();

    // rows g and g + 8 of each m16 tile, columns 2t and 2t + 1 of each n8
    // tile, into the tile [BM][nb] of this column block's nb columns
    float* sC = reinterpret_cast<float*>(smem4);
    const int nb = min(COLS, n - col0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float* dst = sC + (wr + 16 * mt + 8 * h + g) * nb;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int col = 8 * (wt + j) + 2 * t;
                if (col < nb) dst[col] = acc[mt][j][2 * h];
                if (col + 1 < nb) dst[col + 1] = acc[mt][j][2 * h + 1];
            }
        }
    }
    __syncthreads();

    // out to C, masked past m: the block's rows are contiguous when one
    // column block covers N, so one streaming copy, 16 bytes a thread
    // where C allows
    const int rows = (int)min((long long)S::BM, m - row0);
    const int tid = threadIdx.x;
    if (nb == n) {
        float* dst = c + row0 * n;
        const int total = rows * n;
        int done = 0;
        if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
            const int n4 = total / 4;
            for (int i = tid; i < n4; i += S::THREADS)
                __stcs(reinterpret_cast<float4*>(dst) + i,
                       reinterpret_cast<const float4*>(sC)[i]);
            done = 4 * n4;
        }
        for (int i = done + tid; i < total; i += S::THREADS)
            __stcs(dst + i, sC[i]);
    } else {
        for (int i = tid; i < rows * nb; i += S::THREADS) {
            const int r = i / nb, q = i - r * nb;
            __stcs(c + (row0 + r) * n + col0 + q, sC[i]);
        }
    }
}

template <int PASSES, int NT>
int launch(const float* a0, const float* a1, const uint2* hi,
           const uint2* lo, float* c0, float* c1, long long m, int k, int n,
           bool two, cudaStream_t st)
{
    using S = Shape<NT>;
    const int nks = (k + 15) / 16;
    // the ring, and the C tile over it after the loop
    const size_t ring = NSTAGE * (sizeof(float) * S::BM * SA
                                  + sizeof(uint2) * (PASSES > 1 ? 2 : 1)
                                        * KS * S::NTP * 32);
    const size_t tile = sizeof(float) * S::BM * 8 * S::NTP;
    const size_t smem = ring > tile ? ring : tile;
    const cudaError_t e = cudaFuncSetAttribute(
        rl_gemm_kernel<PASSES, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bool vec = k % 4 == 0
        && ((reinterpret_cast<uintptr_t>(a0)
             | reinterpret_cast<uintptr_t>(a1)) & 15) == 0;
    const dim3 grid((unsigned)((m + S::BM - 1) / S::BM), two ? 2 : 1,
                    (unsigned)((n + COLS - 1) / COLS));
    rl_gemm_kernel<PASSES, NT><<<grid, S::THREADS, smem, st>>>(
        a0, a1, hi, lo, c0, c1, m, k, n, nks, (int)vec);
    return (int)cudaGetLastError();
}

template <int PASSES>
int launch_passes(const float* a0, const float* a1, const uint2* hi,
                  const uint2* lo, float* c0, float* c1, long long m, int k,
                  int n, bool two, cudaStream_t st)
{
    switch (tiles_for(n)) {
    case 2:
        return launch<PASSES, 2>(a0, a1, hi, lo, c0, c1, m, k, n, two, st);
    case 4:
        return launch<PASSES, 4>(a0, a1, hi, lo, c0, c1, m, k, n, two, st);
    case 8:
        return launch<PASSES, 8>(a0, a1, hi, lo, c0, c1, m, k, n, two, st);
    default:
        return launch<PASSES, 12>(a0, a1, hi, lo, c0, c1, m, k, n, two, st);
    }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Return a cudaError_t, 0 when the
// launch was accepted, or -1 for a shape the kernel does not take.  Do
// not synchronise.

// uint2 words in each packed plane of a [k, n] B; -1 unless k and n are
// positive.
long long rl_gemm_plane_words(int k, int n)
{
    if (k < 1 || n < 1) return -1;
    return block_words(k, n) * ((n + COLS - 1) / COLS);
}

// b [k, n] f32 row-major into the planes hi, lo (rl_gemm_plane_words
// uint2 each, 16-byte aligned).
int rl_pack_launch(const float* b, void* hi, void* lo, int k, int n,
                   void* stream)
{
    const long long words = rl_gemm_plane_words(k, n);
    if (words < 0) return -1;
    const int threads = 256;
    const long long want = (words + threads - 1) / threads;
    const int blocks = (int)(want < 65536 ? want : 65536);
    rl_pack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        b, (uint2*)hi, (uint2*)lo, k, n, (k + 15) / 16, CG * tiles_for(n),
        words);
    return (int)cudaGetLastError();
}

// c0 [m, n] = a0 [m, k] @ B and, when a1 is not NULL, c1 = a1 @ B in the
// same launch; B's planes from rl_pack_launch of the same k and n.  All
// f32 row-major and contiguous; passes 1 or 3.
int rl_gemm_launch(const float* a0, const float* a1, const void* hi,
                   const void* lo, float* c0, float* c1, long long m, int k,
                   int n, int passes, void* stream)
{
    if (rl_gemm_plane_words(k, n) < 0 || m < 0 || (passes != 1 && passes != 3)
        || (a1 == nullptr) != (c1 == nullptr))
        return -1;
    if (m == 0) return 0;
    const bool two = a1 != nullptr;
    if (!two) {
        a1 = a0;
        c1 = c0;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const uint2* h = (const uint2*)hi;
    const uint2* l = (const uint2*)lo;
    return passes == 3
        ? launch_passes<3>(a0, a1, h, l, c0, c1, m, k, n, two, st)
        : launch_passes<1>(a0, a1, h, l, c0, c1, m, k, n, two, st);
}

}  // extern "C"
