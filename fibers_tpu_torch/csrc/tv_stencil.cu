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
// What bounds it on an H100: per output element the kernel reads 13 stack
// values (the cell and its neighbours) and writes one float, and does 4
// square roots and 5 divides.  Neighbouring threads take neighbouring
// components, so every read of a warp is one contiguous row segment, and
// the +-y and +-x neighbours of a row are rows the block's neighbours read
// too: the repeated reads are meant to hit L1/L2, leaving device memory
// one read of the stack and one write of the output (2.15 GB + 2.15 GB at
// RUMBA's 128x128x90x364 crop, ~1.3 ms at 3.35 TB/s).  What it reaches is
// in PERF.md.
//
// tv_dimsem walks the grid with the component axis outermost
// (blockIdx.y = a 32-wide component chunk): the ported form of declaring
// that TPU grid axis parallel.  tv_2slice computes two x-slices per
// thread, sharing the normalised gradient of the lower slice between
// them, with the experiment's three divides by the norm; X must be even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tv_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float load(const T* p, long i);

template <>
__device__ __forceinline__ float load<float>(const float* p, long i)
{
    return __ldg(p + i);
}

template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     long i)
{
    return __bfloat162float(p[i]);
}

template <typename T>
struct Dense {
    const T* v;
    int Y, Z, C, c;
    __device__ __forceinline__ float operator()(int x, int y, int z) const
    {
        return load(v, (((long)x * Y + y) * Z + z) * C + c);
    }
};

// One thread per (cell, component), component fastest.
template <typename T>
__global__ void __launch_bounds__(tv::kThreads)
tv_dense_kernel(const T* __restrict__ v, const float* __restrict__ lam,
                float* __restrict__ out, int X, int Y, int Z, int C)
{
    const long total = (long)X * Y * Z * C;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (long)gridDim.x * blockDim.x) {
        const int c = (int)(i % C);
        const long cell = i / C;
        const int z = (int)(cell % Z);
        const int y = (int)((cell / Z) % Y);
        const int x = (int)(cell / ((long)Y * Z));
        const Dense<T> val{v, Y, Z, C, c};
        out[i] = tv::cell_multiplier<sizeof(T) == 2, false>(
            val, x, y, z, X, Y, Z, __ldg(lam + cell));
    }
}

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
        const Dense<float> val{v, Y, Z, C, c};
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
        const Dense<float> val{v, Y, Z, C, c};
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
    const long total = (long)X * Y * Z * C;
    if (total <= 0) return (int)cudaSuccess;
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        tv_dense_kernel<__nv_bfloat16><<<blocks_for(total), tv::kThreads, 0,
                                         s>>>(
            (const __nv_bfloat16*)v, lam, out, X, Y, Z, C);
    else
        tv_dense_kernel<float><<<blocks_for(total), tv::kThreads, 0, s>>>(
            (const float*)v, lam, out, X, Y, Z, C);
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
