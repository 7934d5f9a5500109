// RUMBA-SD dense TV stencil for Hopper (sm_90a), and the two launch
// variants of the TV-variant experiment.
//
// Replaces the Pallas TPU kernels
//   fibers_tpu/ops/pallas/tv_stencil.py  `tv_multiplier` (body `_tv_kernel`)
//   benchmarks/exp_tv_variants.py        `tv_dimsem`  (component axis
//                                         declared parallel)
//   benchmarks/exp_tv_variants.py        `tv_2slice`  (two x-slices per
//                                         grid step, `_tv_kernel2`)
// Input: a channels-minor [X, Y, Z, C] component stack (f32, or bf16 for
// tv_multiplier), lam [X, Y, Z] f32.  Output: the [X, Y, Z, C] f32 TV
// multiplier.  The arithmetic is tv_common.cuh's.
//
// tv_multiplier runs tv_common.cuh's x-sweep (`sweep_kernel`): a block
// stages each slice of an 8 x 8 (y, z) tile and its halo, 32 components
// wide, into shared memory with cp.async and computes each normalised
// gradient once, carrying gn.x of the previous slice in registers.  What
// bounds it on an H100: device memory needs one read of the stack and one
// write of the output (1.07 GB + 2.15 GB at RUMBA's bf16 128x128x90x364
// crop, ~0.96 ms at 3.35 TB/s); per element it does ~1.25 square roots
// and ~2.25 IEEE divides (the halo's gradients included), so the
// arithmetic is of the same order.  What it reaches is in PERF.md.
//
// The experiment variants keep the first port's design, one thread per
// (cell, component) through `tv::cell_multiplier`, recomputing the 4
// gradients a cell needs from its 13 neighbours.  tv_dimsem walks the grid
// with the component axis outermost (blockIdx.y = a 32-wide component
// chunk): the ported form of declaring that TPU grid axis parallel.
// tv_2slice computes two x-slices per thread, sharing the normalised
// gradient of the lower slice between them, with the experiment's three
// divides by the norm; X must be even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tv_common.cuh"

namespace {

// The f32 stack read by the experiment variants.
struct Dense {
    const float* v;
    int Y, Z, C, c;
    __device__ __forceinline__ float operator()(int x, int y, int z) const
    {
        return __ldg(v + (((long)x * Y + y) * Z + z) * C + c);
    }
};

constexpr int kChunk = 32;   // components per chunk in tv_dimsem

// Component chunk outermost: blockIdx.y picks the chunk, the threads of a
// block walk cells with the chunk's components fastest.
__global__ void __launch_bounds__(tv::kThreads)
tv_dimsem_kernel(const float* __restrict__ v, const float* __restrict__ lam,
                 float* __restrict__ out, int X, int Y, int Z, int C)
{
    const long ncell = (long)X * Y * Z;
    const int c = blockIdx.y * kChunk + (int)(threadIdx.x % kChunk);
    if (c >= C) return;
    const long per_block = tv::kThreads / kChunk;
    for (long cell = (long)blockIdx.x * per_block + threadIdx.x / kChunk;
         cell < ncell; cell += (long)gridDim.x * per_block) {
        const int z = (int)(cell % Z);
        const int y = (int)((cell / Z) % Y);
        const int x = (int)(cell / ((long)Y * Z));
        const Dense val{v, Y, Z, C, c};
        out[cell * C + c] = tv::cell_multiplier<false, false>(
            val, x, y, z, X, Y, Z, __ldg(lam + cell));
    }
}

// Two x-slices per thread: cells (2i, y, z) and (2i+1, y, z).
__global__ void __launch_bounds__(tv::kThreads)
tv_2slice_kernel(const float* __restrict__ v, const float* __restrict__ lam,
                 float* __restrict__ out, int X, int Y, int Z, int C)
{
    const long total = (long)(X / 2) * Y * Z * C;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (long)gridDim.x * blockDim.x) {
        const int c = (int)(i % C);
        const long rest = i / C;
        const int z = (int)(rest % Z);
        const int y = (int)((rest / Z) % Y);
        const int x0 = 2 * (int)(rest / ((long)Y * Z));
        const Dense val{v, Y, Z, C, c};
        auto grad = [&](int qx, int qy, int qz) {
            const float vq = val(qx, qy, qz);
            const float vx = qx + 1 < X ? val(qx + 1, qy, qz) : vq;
            const float vy = qy + 1 < Y ? val(qx, qy + 1, qz) : vq;
            const float vz = qz + 1 < Z ? val(qx, qy, qz + 1) : vq;
            return tv::norm_grad<false, true>(vq, vx, vy, vz);
        };
        const tv::Grad g0 = grad(x0, y, z);
        const tv::Grad g1 = grad(x0 + 1, y, z);
        for (int k = 0; k < 2; ++k) {
            const int x = x0 + k;
            const tv::Grad g = k ? g1 : g0;
            float ddx = g.x, ddy = g.y, ddz = g.z;
            if (k) ddx = __fsub_rn(ddx, g0.x);
            else if (x > 0) ddx = __fsub_rn(ddx, grad(x - 1, y, z).x);
            if (y > 0) ddy = __fsub_rn(ddy, grad(x, y - 1, z).y);
            if (z > 0) ddz = __fsub_rn(ddz, grad(x, y, z - 1).z);
            const long cell = ((long)x * Y + y) * Z + z;
            out[cell * C + c] =
                tv::multiplier(__ldg(lam + cell), ddx, ddy, ddz);
        }
    }
}

// Self-check of the branch-free rounding helpers against the intrinsics:
// bit patterns [lo, hi) through sqrt_fast where sqrt_in holds, and
// rcp_fast where rcp_in holds; counts the mismatches into `bad`.
__global__ void rn_selfcheck_kernel(unsigned long long lo,
                                    unsigned long long hi,
                                    unsigned long long* bad)
{
    unsigned long long n = 0;
    for (unsigned long long i = lo + (unsigned long long)blockIdx.x *
                                          blockDim.x + threadIdx.x;
         i < hi; i += (unsigned long long)gridDim.x * blockDim.x) {
        const float v = __uint_as_float((unsigned)i);
        if (tv::sqrt_in(v) && __float_as_uint(tv::sqrt_fast(v)) !=
                                  __float_as_uint(__fsqrt_rn(v)))
            ++n;
        if (tv::rcp_in(v) && __float_as_uint(tv::rcp_fast(v)) !=
                                 __float_as_uint(__fdiv_rn(1.0f, v)))
            ++n;
    }
    if (n) atomicAdd(bad, n);
}

unsigned blocks_for(long work)
{
    const long b = (work + tv::kThreads - 1) / tv::kThreads;
    return (unsigned)(b < (1L << 30) ? b : (1L << 30));
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t); return a cudaError_t, 0 when the
// launch was accepted.  They do not synchronise.  `bf16` != 0: `v` holds
// __nv_bfloat16 values.

int tv_multiplier_launch(const void* v, int bf16, const float* lam,
                         float* out, int X, int Y, int Z, int C, void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return tv::sweep_launch<__nv_bfloat16, false>(
            (const __nv_bfloat16*)v, lam, nullptr, out, X, Y, Z, C, s);
    return tv::sweep_launch<float, false>((const float*)v, lam, nullptr, out,
                                          X, Y, Z, C, s);
}

// Mismatches of tv_common.cuh's branch-free sqrt and 1/x against
// __fsqrt_rn and __fdiv_rn over the bit patterns [lo, hi), added to *bad
// (device memory).
int tv_rn_selfcheck(unsigned long long lo, unsigned long long hi,
                    unsigned long long* bad, void* stream)
{
    rn_selfcheck_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
        lo, hi, bad);
    return (int)cudaGetLastError();
}

int tv_dimsem_launch(const float* v, const float* lam, float* out, int X,
                     int Y, int Z, int C, void* stream)
{
    const long ncell = (long)X * Y * Z;
    if (ncell <= 0 || C <= 0) return (int)cudaSuccess;
    const dim3 grid(blocks_for(ncell * kChunk),
                    (unsigned)((C + kChunk - 1) / kChunk));
    tv_dimsem_kernel<<<grid, tv::kThreads, 0, (cudaStream_t)stream>>>(
        v, lam, out, X, Y, Z, C);
    return (int)cudaGetLastError();
}

int tv_2slice_launch(const float* v, const float* lam, float* out, int X,
                     int Y, int Z, int C, void* stream)
{
    if (X % 2) return (int)cudaErrorInvalidValue;
    const long total = (long)(X / 2) * Y * Z * C;
    if (total <= 0) return (int)cudaSuccess;
    tv_2slice_kernel<<<blocks_for(total), tv::kThreads, 0,
                       (cudaStream_t)stream>>>(v, lam, out, X, Y, Z, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
