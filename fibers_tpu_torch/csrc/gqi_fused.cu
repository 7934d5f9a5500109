// Fused GQI reconstruction tile for Hopper (sm_90a), plain FP32.
//
// Replaces the Pallas TPU kernel fibers_tpu/ops/pallas/gqi_fused.py
// (`gqi_fused`, body `_kernel`).  Per block of BM voxel rows it:
//   1. stages max(s, 0) for the tile in shared memory, k-major;
//   2. computes the ODF tile s @ A_t with plain FP32 FMAs (no TF32, no
//      wgmma) so the sums keep full f32 precision, like the reference's
//      Precision.HIGHEST;
//   3. writes the ODF tile to shared memory and once to global memory;
//   4. computes the strict local-max mask over face neighbours straight
//      from the shared ODF tile through the [nvert, maxdeg] neighbour
//      table (invalid neighbours count as -inf; fibers_tpu/ops/peaks.py
//      peak_mask).  The TPU kernel spelled this gather as maxdeg one-hot
//      permutation matmuls because Mosaic has no in-kernel gather;
//      Hopper gathers from shared memory directly;
//   5. writes per-row stats: ODF min, ODF mean, valid = max(s) > 0.
//
// Floors on an H100: at the main path's shapes (N = 720,896, nvol = 198,
// nvert = 321) the product is 2*N*nvol*nvert = 91.6 GFLOP of FP32 FMA,
// against ~0.57 GB of signals in and ~0.93 GB of ODF plus ~0.23 GB of
// uint8 mask out.  At 67 TFLOP/s of FP32 and 3.35 TB/s that is ~1.4 ms of
// arithmetic against ~0.5 ms of traffic.  The design keeps every
// intermediate (clamped signals, the ODF tile, the neighbour maxima) in
// shared memory, so device memory sees each input once and each output
// once.  Each thread owns a 4x4 register tile fed by float4 shared-memory
// loads.
//
// Measured (H100 80GB HBM3, 700 W power limit): ~12.3 ms, far above both
// floors, so neither FMA throughput nor DRAM traffic is what holds it.
// Without steps 4-5 it takes ~8.6 ms; BM = 64 gains ~5% and BK = 32 loses
// ~10%.  What limits the product loop and the epilogue is not measured
// (no hardware counters were read); likely candidates are shared-memory
// bandwidth in the inner loop (two float4 loads per 16 FMAs), latency at
// low occupancy (~72 KB of shared memory per 128-thread block leaves ~3
// blocks per SM), a barrier every BK steps, and in the epilogue the
// per-element reads of the neighbour table.  Known costs left for later
// work: the last BN-wide column pass is mostly padding at nvert = 321 (384
// columns computed for 321); there is no wgmma/3xTF32 path, no TMA
// staging, and top-k plus QA still run as separate passes after the
// kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;            // voxel rows per block
constexpr int BN = 64;            // ODF columns per register-tile pass
constexpr int BK = 16;            // depth of each staged A_t chunk
constexpr int TX = 16;            // threads across columns (4 cols each)
constexpr int TY = BM / 4;        // threads across rows (4 rows each)
constexpr int THREADS = TX * TY;  // 128
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
gqi_fused_kernel(const float* __restrict__ sig,
                 const float* __restrict__ a_t,
                 const int* __restrict__ nbr,
                 const uint8_t* __restrict__ nbr_ok,
                 float* __restrict__ odf,
                 uint8_t* __restrict__ peak,
                 float* __restrict__ stats,
                 int n, int nvol, int nvol_pad, int nvert, int maxdeg)
{
    extern __shared__ float4 smem4[];
    float* sT = reinterpret_cast<float*>(smem4);  // [nvol_pad][BM]
    float* sB = sT + nvol_pad * BM;                // [BK][BN]
    float* sO = sB + BK * BN;                      // [BM][nvert]

    const int tid = threadIdx.x;
    const int tx = tid % TX;
    const int ty = tid / TX;
    const long row0 = (long)blockIdx.x * BM;
    const int rows = (int)min((long)BM, (long)n - row0);

    // 1. clamped signals, transposed; ragged rows and k padding are zero.
    //    Lanes run along rows, so the shared-memory stores hit 32 banks.
    for (int i = tid; i < nvol_pad * BM; i += THREADS) {
        const int r = i % BM, k = i / BM;
        float v = 0.f;
        if (r < rows && k < nvol) v = fmaxf(sig[(row0 + r) * nvol + k], 0.f);
        sT[i] = v;
    }
    __syncthreads();

    // 2.-3. ODF tile, BN columns per pass, accumulated in registers
    for (int c0 = 0; c0 < nvert; c0 += BN) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

        for (int k0 = 0; k0 < nvol_pad; k0 += BK) {
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int kk = i / BN, c = i % BN;
                const int k = k0 + kk, col = c0 + c;
                sB[i] = (k < nvol && col < nvert)
                            ? __ldg(&a_t[(long)k * nvert + col]) : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(
                    &sT[(k0 + kk) * BM + ty * 4]);
                const float4 b = *reinterpret_cast<const float4*>(
                    &sB[kk * BN + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = c0 + tx * 4 + j;
                if (col < nvert) sO[(ty * 4 + i) * nvert + col] = acc[i][j];
            }
    }
    __syncthreads();

    // The block's rows are contiguous in odf and peak: one linear copy
    const long base = row0 * nvert;
    const int tile = rows * nvert;
    for (int i = tid; i < tile; i += THREADS) odf[base + i] = sO[i];

    // 4. strict local maxima over face neighbours
    for (int i = tid; i < tile; i += THREADS) {
        const int r = i / nvert, v = i - r * nvert;
        const float* o = sO + r * nvert;
        float m = -INFINITY;
        for (int k = 0; k < maxdeg; ++k) {
            const int e = v * maxdeg + k;
            if (__ldg(&nbr_ok[e])) m = fmaxf(m, o[__ldg(&nbr[e])]);
        }
        peak[base + i] = o[v] > m ? 1 : 0;
    }

    // 5. stats: a warp per row for min/mean; warp 0 also takes valid,
    //    one row per lane
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += WARPS) {
        const float* o = sO + r * nvert;
        float mn = INFINITY, sum = 0.f;
        for (int v = lane; v < nvert; v += 32) {
            mn = fminf(mn, o[v]);
            sum += o[v];
        }
        for (int off = 16; off > 0; off >>= 1) {
            mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        if (lane == 0) {
            stats[(row0 + r) * 3 + 0] = mn;
            stats[(row0 + r) * 3 + 1] = sum / (float)nvert;
        }
    }
    if (warp == 0 && lane < rows) {
        float smax = 0.f;
        for (int k = 0; k < nvol; ++k) smax = fmaxf(smax, sT[k * BM + lane]);
        stats[(row0 + lane) * 3 + 2] = smax > 0.f ? 1.f : 0.f;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long gqi_fused_smem_bytes(int nvol, int nvert)
{
    const long nvol_pad = (nvol + BK - 1) / BK * BK;
    return (long)sizeof(float) * (nvol_pad * BM + BK * BN + (long)BM * nvert);
}

// Launch on `stream` (a cudaStream_t).  Returns a cudaError_t: 0 when the
// launch was accepted.  Does not synchronise.
int gqi_fused_launch(const float* sig, const float* a_t, const int* nbr,
                     const uint8_t* nbr_ok, float* odf, uint8_t* peak,
                     float* stats, int n, int nvol, int nvert, int maxdeg,
                     void* stream)
{
    if (n <= 0) return (int)cudaSuccess;
    const int nvol_pad = (nvol + BK - 1) / BK * BK;
    const long smem = gqi_fused_smem_bytes(nvol, nvert);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(gqi_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((n + BM - 1) / BM);
    gqi_fused_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        sig, a_t, nbr, nbr_ok, odf, peak, stats, n, nvol, nvol_pad, nvert,
        maxdeg);
    return (int)cudaGetLastError();
}

}  // extern "C"
