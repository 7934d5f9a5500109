// RUMBA-SD's row passes around the Richardson-Lucy products, for Hopper
// (sm_90a): the fODF update and the refit.
//
// Replace the elementwise work that XLA fuses inside the reference's
// iteration program, fibers_tpu/models/rumba.py:_rumba_step_core (the
// body of _rumba_block's lax.fori_loop).  One iteration of the port is
// then two product launches (rl_gemm.cu), the TV kernel and these two
// launches, where the eager torch expression made ~28 kernels, each
// reading and writing whole [N, ndir] or [N, ncomp] arrays.
//
// rumba_update: fodf' = max(fodf * (num / (den + 1e-7)) * tv, 0) over
// [N, C], with num = x @ kernel, den = dodf @ kernel and tv the TV
// multiplier rows (absent without TV).  A thread a quad of 16 bytes when
// C is a multiple of 4, else a thread an element.  `out` may be `fodf` or
// `num`: each element is read before the same thread writes it.
//
// rumba_refit: after dodf = fodf' @ kernel.T, per row of [N, ndir]:
//   ir    = besseli_ratio(n_order, dodf_sig)        (this iteration's)
//   ds'   = (signal * dodf) / sig2
//   resid = (signal^2 + dodf^2) / 2 - (sig2 * ds') * ir
//   sig2' = clamp(sum(resid) * (1 / (n_order * ndir)), (1/80)^2, (1/8)^2)
//   x'    = signal * besseli_ratio(n_order, ds')     (the next product's)
// A warp a row; the row sum in registers.  This iteration's ratio is
// recomputed from the old dodf_sig, not carried: dodf_sig stays in the
// state (the reference's), and carrying the ratio too would add a write.
// The first-iteration mode (dodf NULL) computes only x' from dodf_sig.
//
// Rounding: every output but sig2' equals the torch expression on the
// card bit for bit.  Multiplies and adds are rounded apart (`__fmul_rn`,
// `__fadd_rn`, `__fsub_rn`: nvcc would contract a*b+c into an FMA, torch's
// elementwise kernels do not), quotients of two tensors are IEEE
// (`__fdiv_rn`), and a divide by a Python number is a multiply by its
// float reciprocal, as torch's CUDA `div` with a CPU scalar computes it
// (x / 2 is x * 0.5; the wrapper passes 1 / (n_order * ndir) rounded to
// float).  clamp and clamp_min keep a NaN, as torch's do (fmaxf alone
// would drop it).  The row sum is taken in double and rounded once: torch
// sums in float in an order this kernel does not follow, so sig2' is
// held to a tolerance, not bit for bit.
//
// What bounds it on an H100: bytes.  At RUMBA config 4 (N = 715,200,
// ndir = 253, ncomp = 364) the refit reads three and writes two
// [N, ndir] f32 arrays (3.6 GB, ~1.08 ms at 3.35 TB/s) and does nine IEEE
// divides an element; the update reads four and writes one [N, ncomp]
// array (5.2 GB, ~1.55 ms).  What they reach is in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ------------------------------------------------------------------ //
// rumba_update
// ------------------------------------------------------------------ //

template <bool kTV>
__device__ __forceinline__ float update1(float f, float n, float d, float t)
{
    const float rl = __fdiv_rn(n, __fadd_rn(d, 1e-7f));
    float p = __fmul_rn(f, rl);
    if (kTV) p = __fmul_rn(p, t);
    return isnan(p) ? p : fmaxf(p, 0.0f);         // torch.clamp_min
}

// A thread a quad; C % 4 == 0 and every base 16-byte aligned, so a quad
// never crosses a row.  No __restrict__: `out` may alias an input.
template <bool kTV>
__global__ void __launch_bounds__(kThreads)
update_quads(const float4* fodf, const float4* num, const float4* den,
             const float* tv, int ld_tv, float4* out, int nquad, int cq)
{
    const int q = blockIdx.x * kThreads + threadIdx.x;
    if (q >= nquad) return;
    const float4 f = fodf[q], n = num[q], d = den[q];
    float4 t = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (kTV) {
        const int row = q / cq;
        t = *reinterpret_cast<const float4*>(
            tv + (size_t)row * ld_tv + 4 * (q - row * cq));
    }
    float4 o;
    o.x = update1<kTV>(f.x, n.x, d.x, t.x);
    o.y = update1<kTV>(f.y, n.y, d.y, t.y);
    o.z = update1<kTV>(f.z, n.z, d.z, t.z);
    o.w = update1<kTV>(f.w, n.w, d.w, t.w);
    out[q] = o;
}

template <bool kTV>
__global__ void __launch_bounds__(kThreads)
update_elems(const float* fodf, const float* num, const float* den,
             const float* tv, int ld_tv, float* out, int nelem, int C)
{
    const int e = blockIdx.x * kThreads + threadIdx.x;
    if (e >= nelem) return;
    float t = 1.0f;
    if (kTV) {
        const int row = e / C;
        t = tv[(size_t)row * ld_tv + (e - row * C)];
    }
    out[e] = update1<kTV>(fodf[e], num[e], den[e], t);
}

// ------------------------------------------------------------------ //
// rumba_refit
// ------------------------------------------------------------------ //

// The constants of Perron's continued fraction for I_nu / I_{nu-1}.
struct Nu {
    float c1, c2, c3, c4, c5;                    // 2nu, +1, +3, +2, +5
};

// models/rumba.py:besseli_ratio as torch evaluates it, operation by
// operation (a Python int times or plus a tensor is that float).
__device__ __forceinline__ float bessel_ratio(float z, const Nu& k)
{
    const float z2 = __fmul_rn(2.0f, z);
    const float t5 = __fadd_rn(k.c3, z2);                 // (2nu+3) + 2z
    const float q5 = __fdiv_rn(__fmul_rn(k.c5, z), t5);
    const float t4 = __fsub_rn(__fadd_rn(k.c4, z2), q5);  // (2nu+2) + 2z - .
    const float q4 = __fdiv_rn(__fmul_rn(k.c3, z), t4);
    const float t3 = __fsub_rn(__fadd_rn(z2, k.c2), q4);  // 2z + (2nu+1) - .
    const float q3 = __fdiv_rn(__fmul_rn(k.c2, z), t3);
    const float t2 = __fsub_rn(__fadd_rn(k.c1, z), q3);   // (2nu + z) - .
    return __fdiv_rn(z, t2);
}

struct Refit {
    const float* __restrict__ signal;
    const float* __restrict__ dodf;              // NULL: first-iteration mode
    const float* __restrict__ dsig_old;
    const float* __restrict__ sig2;
    float* __restrict__ dsig;
    float* __restrict__ sig2_out;
    float* __restrict__ x;
    int n, ndir;
    Nu nu;
    float inv, lo, hi;
};

// One element: writes ds' and x' (or x alone), returns the residual term.
template <bool kRefit>
__device__ __forceinline__ float refit1(float s, float d, float dso, float s2,
                                        const Nu& nu, float& ds, float& x)
{
    float r = 0.0f;
    if (kRefit) {
        const float ir = bessel_ratio(dso, nu);
        ds = __fdiv_rn(__fmul_rn(s, d), s2);
        const float sq = __fmul_rn(__fadd_rn(__fmul_rn(s, s), __fmul_rn(d, d)),
                                   0.5f);
        r = __fsub_rn(sq, __fmul_rn(__fmul_rn(s2, ds), ir));
    } else {
        ds = dso;
    }
    x = __fmul_rn(s, bessel_ratio(ds, nu));
    return r;
}

template <bool kRefit>
__device__ __forceinline__ void refit_elem(const Refit& a, size_t e, float s2,
                                           double& acc)
{
    float ds, x;
    const float r = refit1<kRefit>(a.signal[e], kRefit ? a.dodf[e] : 0.0f,
                                   a.dsig_old[e], s2, a.nu, ds, x);
    if (kRefit) {
        a.dsig[e] = ds;
        acc += (double)r;
    }
    a.x[e] = x;
}

template <bool kRefit>
__device__ __forceinline__ void refit_quad(const Refit& a, size_t e, float s2,
                                           double& acc)
{
    const float4 s = *reinterpret_cast<const float4*>(a.signal + e);
    const float4 o = *reinterpret_cast<const float4*>(a.dsig_old + e);
    float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kRefit) d = *reinterpret_cast<const float4*>(a.dodf + e);
    float4 ds, x;
    const float r0 = refit1<kRefit>(s.x, d.x, o.x, s2, a.nu, ds.x, x.x);
    const float r1 = refit1<kRefit>(s.y, d.y, o.y, s2, a.nu, ds.y, x.y);
    const float r2 = refit1<kRefit>(s.z, d.z, o.z, s2, a.nu, ds.z, x.z);
    const float r3 = refit1<kRefit>(s.w, d.w, o.w, s2, a.nu, ds.w, x.w);
    if (kRefit) {
        *reinterpret_cast<float4*>(a.dsig + e) = ds;
        acc += (double)r0;
        acc += (double)r1;
        acc += (double)r2;
        acc += (double)r3;
    }
    *reinterpret_cast<float4*>(a.x + e) = x;
}

// A warp a row.  kVec: every base is 16-byte aligned, so the row's
// elements before its first 16-byte boundary go one a lane, then quads,
// then the rest one a lane (all arrays share the row layout).
template <bool kRefit, bool kVec>
__global__ void __launch_bounds__(kThreads) refit_rows(const Refit a)
{
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= a.n) return;
    const size_t e0 = (size_t)row * a.ndir;
    const float s2 = kRefit ? a.sig2[row] : 0.0f;
    double acc = 0.0;
    if (kVec) {
        const int head = min((int)((4 - (e0 & 3)) & 3), a.ndir);
        const int nq = (a.ndir - head) >> 2;
        const int rest = head + 4 * nq;
        if (lane < head) refit_elem<kRefit>(a, e0 + lane, s2, acc);
#pragma unroll 2
        for (int q = lane; q < nq; q += 32)
            refit_quad<kRefit>(a, e0 + head + 4 * (size_t)q, s2, acc);
        if (lane < a.ndir - rest)
            refit_elem<kRefit>(a, e0 + rest + lane, s2, acc);
    } else {
        for (int c = lane; c < a.ndir; c += 32)
            refit_elem<kRefit>(a, e0 + c, s2, acc);
    }
    if constexpr (kRefit) {
#pragma unroll
        for (int o = 16; o; o >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) {
            const float v = __fmul_rn((float)acc, a.inv);
            a.sig2_out[row] = isnan(v) ? v : fminf(fmaxf(v, a.lo), a.hi);
        }
    }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Return a cudaError_t, 0 when the
// launch was accepted.  Do not synchronise.

// fodf, num, den, out [n, C] f32 contiguous; tv [n, >= C] f32 with row
// stride ld_tv, or NULL (no TV term).  vec: C % 4 == 0, ld_tv % 4 == 0
// and every pointer 16-byte aligned.  n * max(C, ld_tv) < 2^31.
int rumba_update_launch(const float* fodf, const float* num, const float* den,
                        const float* tv, int ld_tv, float* out, int n, int C,
                        int vec, void* stream)
{
    const long long nelem = (long long)n * C;
    if (nelem == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec) {
        const int nquad = (int)(nelem / 4);
        const int grid = (nquad + kThreads - 1) / kThreads;
        auto f = (const float4*)fodf;
        auto u = (const float4*)num;
        auto d = (const float4*)den;
        if (tv)
            update_quads<true><<<grid, kThreads, 0, st>>>(
                f, u, d, tv, ld_tv, (float4*)out, nquad, C / 4);
        else
            update_quads<false><<<grid, kThreads, 0, st>>>(
                f, u, d, tv, ld_tv, (float4*)out, nquad, C / 4);
    } else {
        const int grid = (int)((nelem + kThreads - 1) / kThreads);
        if (tv)
            update_elems<true><<<grid, kThreads, 0, st>>>(
                fodf, num, den, tv, ld_tv, out, (int)nelem, C);
        else
            update_elems<false><<<grid, kThreads, 0, st>>>(
                fodf, num, den, tv, ld_tv, out, (int)nelem, C);
    }
    return (int)cudaGetLastError();
}

// signal, dodf_sig (the old ratio), dodf, dsig, x [n, ndir] f32
// contiguous; sig2, sig2_out [n] f32.  dodf NULL: the first-iteration
// mode, x only (dsig, sig2, sig2_out unused).  inv = 1 / (n_order * ndir)
// in float, [lo, hi] the clamp; vec: every pointer 16-byte aligned.
// n * ndir < 2^31.
int rumba_refit_launch(const float* signal, const float* dodf,
                       const float* dsig_old, const float* sig2, float* dsig,
                       float* sig2_out, float* x, int n, int ndir,
                       int n_order, float inv, float lo, float hi, int vec,
                       void* stream)
{
    if ((long long)n * ndir == 0) return 0;
    Refit a;
    a.signal = signal;
    a.dodf = dodf;
    a.dsig_old = dsig_old;
    a.sig2 = sig2;
    a.dsig = dsig;
    a.sig2_out = sig2_out;
    a.x = x;
    a.n = n;
    a.ndir = ndir;
    a.nu = Nu{(float)(2 * n_order), (float)(2 * n_order + 1),
              (float)(2 * n_order + 3), (float)(2 * n_order + 2),
              (float)(2 * n_order + 5)};
    a.inv = inv;
    a.lo = lo;
    a.hi = hi;
    const int grid = (n + kWarps - 1) / kWarps;
    cudaStream_t st = (cudaStream_t)stream;
    if (dodf) {
        if (vec) refit_rows<true, true><<<grid, kThreads, 0, st>>>(a);
        else refit_rows<true, false><<<grid, kThreads, 0, st>>>(a);
    } else {
        if (vec) refit_rows<false, true><<<grid, kThreads, 0, st>>>(a);
        else refit_rows<false, false><<<grid, kThreads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
