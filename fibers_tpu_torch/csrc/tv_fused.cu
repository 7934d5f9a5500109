// RUMBA-SD TV multiplier fused with the mask embed and unembed, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fibers_tpu/ops/pallas/tv_fused.py
// (`tv_fused`, body `_kernel`).  It computes what embedding the fODF rows
// into the dense [X, Y, Z, C] TV grid, the dense stencil and the gather
// back to rows compute together, without forming the grid: it reads the
// fODF row table and writes multiplier rows.
//
// It is tv_common.cuh's x-sweep (`sweep_kernel<float, true>`), the design
// tv_stencil.cu's tv_multiplier runs, with the staged values taken from
// the rows: the block reads the cell -> row table `cellrow` (-1 outside
// the mask) once per halo cell and slice, copies each box cell's 32
// components of its row (zero-filled outside the mask, as the embed's
// padding row), skips tile-slices with no mask cell, and writes only mask
// rows.  The caller's output buffer is reused across iterations; its other
// rows keep their values.  The TPU kernel needed DMA windows over
// contiguous row ranges, a donated [R + YZ, Cp] buffer and components
// padded to 128 because Mosaic had no multi-vreg gather; a CUDA block
// gathers its rows itself, so none of that is carried over.
//
// What bounds it on an H100: device memory needs one read of the row
// table and one write of the output (1.04 GB each at RUMBA's 715,200 x 364
// rows, ~0.63 ms at 3.35 TB/s with the tables and lam); per mask element
// it does ~1.25 square roots and ~2.25 IEEE divides.  What it reaches is
// in PERF.md.

#include <cuda_runtime.h>

#include "tv_common.cuh"

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns a cudaError_t, 0 when the
// launch was accepted.  Does not synchronise.  rows [>= nmask, C] f32,
// lam [X*Y*Z] f32, cellrow [X*Y*Z] i32 in [-1, nmask), out [>= nmask, C]
// f32 (mask rows written).
int tv_fused_launch(const float* rows, const float* lam, const int* cellrow,
                    float* out, int X, int Y, int Z, int C, void* stream)
{
    return tv::Sweep<float, true>::launch(rows, lam, cellrow, out, X, Y, Z, C,
                                          false, (cudaStream_t)stream);
}

}  // extern "C"
