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
// All three run tv_common.cuh's x-sweep (`sweep_kernel`): a block stages
// each slice of an 8 x 8 (y, z) tile and its halo, 32 components wide,
// into shared memory with cp.async and computes each normalised gradient
// once, carrying gn.x of the previous slice in registers.  What bounds
// them on an H100: device memory needs one read of the stack and one
// write of the output (bf16: 1.07 GB + 2.15 GB at RUMBA's 128x128x90x364
// crop, ~0.96 ms at 3.35 TB/s; f32: 4.30 GB, ~1.28 ms); per element they
// do ~1.25 square roots and ~2.25 IEEE divides (the halo's gradients
// included; tv_2slice ~4.75 divides), so the arithmetic is of the same
// order.  What they reach is in PERF.md.
//
// What makes each experiment variant a variant, in this card's terms:
// - tv_dimsem: the component chunk is the slowest block index instead of
//   the fastest (the experiment's grid (nc, X) with the component axis
//   outermost and declared parallel).  Same arithmetic as tv_multiplier.
// - tv_2slice: two x-slices per loop iteration and barrier, gn.x of the
//   lower slice handed to the upper one in registers, with the
//   experiment's three divides by the norm; X must be even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tv_common.cuh"

namespace {

// 1 if div_in(a, b) holds and div_fast differs from __fdiv_rn, else 0.
__device__ __forceinline__ unsigned div_differs(float a, float b)
{
    if (!tv::div_in(a, b)) return 0;
    return __float_as_uint(tv::div_fast(a, b, tv::div_rcp(b))) !=
           __float_as_uint(__fdiv_rn(a, b));
}

// Self-check of the branch-free rounding helpers against the intrinsics:
// bit patterns [lo, hi) through sqrt_fast where sqrt_in holds, rcp_fast
// where rcp_in holds, and as the denominator of div_fast, where div_in
// holds, under a handful of numerators (fixed ones, zeros of both signs,
// and multiples of the denominator as a gradient component is of its
// norm); counts the mismatches into `bad`.
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
        const float nums[] = {0.0f, -0.0f, 1.0f, -3.1415927f, 1e-3f,
                              0x1.fffffep-1f, 0x1.8p-63f, 0x1.234568p+40f,
                              v, __fmul_rn(v, 0.70710677f),
                              __fmul_rn(v, -0.33333334f),
                              __fmul_rn(v, 0x1.fffffep-1f),
                              __fmul_rn(v, 0x1.3c0ca4p-17f)};
#pragma unroll
        for (float a : nums) n += div_differs(a, v);
    }
    if (n) atomicAdd(bad, n);
}

// 32 mixed bits of a 64-bit counter (the splitmix64 finaliser).
__device__ __forceinline__ unsigned long long mix64(unsigned long long z)
{
    z += 0x9e3779b97f4a7c15ull;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
}

// Self-check of div_fast on `npairs` pseudo-random pairs from `seed`: the
// denominator any float in [2^-12, 2^50), the numerator of either sign
// and up to 2^40 times smaller, as a gradient component against its norm.
__global__ void div_selfcheck_kernel(unsigned long long npairs,
                                     unsigned long long seed,
                                     unsigned long long* bad)
{
    unsigned long long n = 0;
    for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                                threadIdx.x;
         i < npairs; i += (unsigned long long)gridDim.x * blockDim.x) {
        const unsigned long long h = mix64(seed + i);
        const unsigned hb = (unsigned)h, ha = (unsigned)(h >> 32);
        const unsigned eb = 115u + (hb >> 23) % 62u;
        const unsigned ea = eb - (ha >> 23 & 0xffu) % 41u;
        const float b = __uint_as_float(eb << 23 | (hb & 0x7fffffu));
        const float a = __uint_as_float((ha & 0x80000000u) | ea << 23 |
                                        (ha & 0x7fffffu));
        n += div_differs(a, b);
    }
    if (n) atomicAdd(bad, n);
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
        return tv::Sweep<__nv_bfloat16, false>::launch(
            (const __nv_bfloat16*)v, lam, nullptr, out, X, Y, Z, C, false, s);
    return tv::Sweep<float, false>::launch((const float*)v, lam, nullptr,
                                           out, X, Y, Z, C, false, s);
}

// tv_multiplier's f32 function with the component chunk as the slowest
// block index.
int tv_dimsem_launch(const float* v, const float* lam, float* out, int X,
                     int Y, int Z, int C, void* stream)
{
    return tv::Sweep<float, false>::launch(v, lam, nullptr, out, X, Y, Z, C,
                                           true, (cudaStream_t)stream);
}

// Two x-slices per iteration, three divides by the norm; X even.
int tv_2slice_launch(const float* v, const float* lam, float* out, int X,
                     int Y, int Z, int C, void* stream)
{
    return tv::Sweep<float, false, 2, true>::launch(
        v, lam, nullptr, out, X, Y, Z, C, false, (cudaStream_t)stream);
}

// Blocks of one SM that the sweep's instance `which` can hold (the
// occupancy API, 16-byte staging): 0 tv_multiplier f32 and tv_dimsem,
// 1 tv_multiplier bf16, 2 tv_2slice.  Negative: minus a cudaError_t.
int tv_sweep_blocks_per_sm(int which)
{
    switch (which) {
    case 0: return tv::Sweep<float, false>::blocks_per_sm();
    case 1: return tv::Sweep<__nv_bfloat16, false>::blocks_per_sm();
    case 2: return tv::Sweep<float, false, 2, true>::blocks_per_sm();
    }
    return -(int)cudaErrorInvalidValue;
}

// Mismatches of tv_common.cuh's branch-free sqrt, 1/x and a/b against
// __fsqrt_rn and __fdiv_rn over the bit patterns [lo, hi), added to *bad
// (device memory).
int tv_rn_selfcheck(unsigned long long lo, unsigned long long hi,
                    unsigned long long* bad, void* stream)
{
    rn_selfcheck_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
        lo, hi, bad);
    return (int)cudaGetLastError();
}

// Mismatches of the branch-free a/b against __fdiv_rn on `npairs`
// pseudo-random pairs from `seed`, added to *bad (device memory).
int tv_div_selfcheck(unsigned long long npairs, unsigned long long seed,
                     unsigned long long* bad, void* stream)
{
    div_selfcheck_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
        npairs, seed, bad);
    return (int)cudaGetLastError();
}

}  // extern "C"
