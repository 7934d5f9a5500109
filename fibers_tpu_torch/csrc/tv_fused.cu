// RUMBA-SD TV multiplier fused with the mask embed and unembed, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fibers_tpu/ops/pallas/tv_fused.py
// (`tv_fused`, body `_kernel`).  It computes what embedding the fODF rows
// into the dense [X, Y, Z, C] TV grid, the dense stencil and the gather
// back to rows compute together, without forming the grid: it reads the
// fODF row table and writes multiplier rows.
//
// One thread per (mask row, component), component fastest.  The row's
// crop cell comes from `rowcell`; each neighbour cell is looked up in the
// cell -> row table `cellrow` (-1 for a cell outside the mask, whose value
// is 0, as the embed's zero padding row).  The arithmetic is
// tv_common.cuh's, so the result equals tv_stencil.cu's on the embedded
// grid.  Only mask rows are written; the caller's output buffer is reused
// across iterations and its other rows keep their values.  The TPU kernel
// needed DMA windows over contiguous row ranges, a donated [R + YZ, Cp]
// buffer and components padded to 128 because Mosaic had no multi-vreg
// gather; a CUDA thread gathers directly, so none of that is carried over.
//
// What bounds it on an H100: 13 row reads and up to 13 table reads per
// element (the table reads are the same for the whole row, so a warp
// broadcasts them), 4 square roots and 5 divides.  Device memory needs one
// read of the row table and one write of the output (1.04 GB each at
// RUMBA's 715,200 x 364 rows, ~0.6 ms at 3.35 TB/s) if the neighbour rows
// hit in L2; a +-x neighbour lies ~YZ cells, a few MB of rows, away.  What
// it reaches is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tv_common.cuh"

namespace {

struct Rows {
    const float* rows;
    const int* cellrow;
    int Y, Z, C, c;
    __device__ __forceinline__ float operator()(int x, int y, int z) const
    {
        const int r = __ldg(cellrow + ((long)x * Y + y) * Z + z);
        return r >= 0 ? __ldg(rows + (long)r * C + c) : 0.0f;
    }
};

__global__ void __launch_bounds__(tv::kThreads)
tv_fused_kernel(const float* __restrict__ rows, const float* __restrict__ lam,
                const int* __restrict__ cellrow,
                const int* __restrict__ rowcell, float* __restrict__ out,
                int nmask, int X, int Y, int Z, int C)
{
    const long total = (long)nmask * C;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (long)gridDim.x * blockDim.x) {
        const int c = (int)(i % C);
        const long r = i / C;
        const int cell = __ldg(rowcell + r);
        const int z = cell % Z;
        const int y = (cell / Z) % Y;
        const int x = cell / (Y * Z);
        const Rows val{rows, cellrow, Y, Z, C, c};
        out[i] = tv::cell_multiplier<false, false>(val, x, y, z, X, Y, Z,
                                                   __ldg(lam + cell));
    }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns a cudaError_t, 0 when the
// launch was accepted.  Does not synchronise.  rows [>= nmask, C] f32,
// lam [X*Y*Z] f32, cellrow [X*Y*Z] i32 in [-1, nmask), rowcell [nmask]
// i32 in [0, X*Y*Z), out [>= nmask, C] f32 (rows < nmask written).
int tv_fused_launch(const float* rows, const float* lam, const int* cellrow,
                    const int* rowcell, float* out, int nmask, int X, int Y,
                    int Z, int C, void* stream)
{
    const long total = (long)nmask * C;
    if (total <= 0) return (int)cudaSuccess;
    long blocks = (total + tv::kThreads - 1) / tv::kThreads;
    if (blocks > (1L << 30)) blocks = 1L << 30;
    tv_fused_kernel<<<(unsigned)blocks, tv::kThreads, 0,
                      (cudaStream_t)stream>>>(rows, lam, cellrow, rowcell,
                                              out, nmask, X, Y, Z, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
