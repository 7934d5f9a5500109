// Step helpers shared by the three tractography kernels (propagate.cu,
// propagate_micro.cu, propagate_lcm.cu): each rounds as the plain step
// loops' torch operations round on the card, so the kernels equal the
// loops bit for bit.  Every multiply and add is rounded apart
// (`__fmul_rn`, `__fadd_rn`: nvcc would contract them into FMAs, torch's
// elementwise kernels do not); the square root and quotient are IEEE.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace prop {

// A sum of three products as torch's CUDA reduction takes it over a
// contiguous last dimension of 3 (ATen/native/cuda/Reduce.cuh: two lanes,
// lane 0 reduces elements 0 and 2 into separate accumulators, lane 1
// element 1; the accumulators start at 0 and combine in order, then the
// lanes): ((0 + p0) + (0 + p2)) + (0 + p1).  The zeros only turn a -0 into
// +0.  ops/kernels/propagate.py:sum3_selfcheck holds it to Tensor.sum.
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2)
{
    const float p0 = __fmul_rn(a0, b0);
    const float p1 = __fmul_rn(a1, b1);
    const float p2 = __fmul_rn(a2, b2);
    return __fadd_rn(__fadd_rn(__fadd_rn(0.0f, p0), __fadd_rn(0.0f, p2)),
                     __fadd_rn(0.0f, p1));
}

// torch.round (half to even), then .to(int64): cvt.rzi.s64.f32 on an
// integral value (NaN gives 0, out of range saturates), as torch's copy.
__device__ __forceinline__ long long round_i64(float x)
{
    return (long long)rintf(x);
}

// dot3 without torch's leading zeros: the same sum but for the sign of a
// zero, which no comparison, |.|, square root or isfinite sees.
__device__ __forceinline__ float dot3_nz(float a0, float a1, float a2,
                                        float b0, float b1, float b2)
{
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a2, b2)),
                     __fmul_rn(a1, b1));
}

// The voxel coordinate of x: torch.round, then .to(int64); the 32-bit
// path clamps it to +-2^30.  A clamped coordinate lies outside the volume
// (each dimension is below 2^29 there: propagate.py:_index_bits), and so
// does a clamped coordinate plus a window offset below 2^29
// (propagate_micro.cu:load_tile); the difference of a clamped coordinate
// and one inside the volume fits an int.
constexpr long long kReach = 1ll << 30;

template <typename Idx>
__device__ __forceinline__ Idx voxel(float x);

template <>
__device__ __forceinline__ long long voxel<long long>(float x)
{
    return round_i64(x);
}

// cvt.rni.s32.f32 rounds half to even like rint, gives 0 for NaN and
// saturates; either way the clamp gives what round_i64's would.
template <>
__device__ __forceinline__ int voxel<int>(float x)
{
    return max(min(__float2int_rn(x), (int)kReach), -(int)kReach);
}

// ops/kernels/propagate.py:_flat_index: the flat voxel index of an
// integer position, 0 where it lies outside the volume; inb says which.
__device__ __forceinline__ long long flat_index(long long ix, long long iy,
                                                long long iz, int nx, int ny,
                                                int nz, bool& inb)
{
    inb = ix >= 0 && ix < nx && iy >= 0 && iy < ny && iz >= 0 && iz < nz;
    return inb ? (ix * ny + iy) * nz + iz : 0;
}

// The same in 32-bit arithmetic, for a volume of fewer than 2^31 voxels
// (then every in-volume index fits an int).
__device__ __forceinline__ int flat_index(int ix, int iy, int iz, int nx,
                                          int ny, int nz, bool& inb)
{
    inb = ix >= 0 && ix < nx && iy >= 0 && iy < ny && iz >= 0 && iz < nz;
    return inb ? (ix * ny + iy) * nz + iz : 0;
}

// torch.argmax's rule for taking element k over the best so far: a NaN
// beats any number, the lower index wins among equals and among NaNs.
__device__ __forceinline__ bool argmax_takes(float best, float v)
{
    return !isnan(best) && (isnan(v) || v > best);
}

// pos_q + d * step in float64 (exact for |d| <= 127 and a float32 step),
// rounded once to float32: torch.add(pos_q.double(), d, alpha=step).
__device__ __forceinline__ float quant_next(float q, float d, float qstep)
{
    return __double2float_rn(
        __dadd_rn((double)q, __dmul_rn((double)d, (double)qstep)));
}

// torch.clamp(x, -dmax, dmax) then torch.where(save, ., 0.0)
__device__ __forceinline__ float quant_delta(float p, float q, float qscale,
                                             float dmax)
{
    const float d = rintf(__fmul_rn(__fsub_rn(p, q), qscale));
    return isnan(d) ? d : fminf(fmaxf(d, -dmax), dmax);
}

// What step t stores for its current point (px, py, pz): the position,
// or with kDeltas its error-feedback delta (zero when not saved), which
// also advances the quantizer's position q.
template <bool kDeltas>
__device__ __forceinline__ void point_out(bool save, float px, float py,
                                          float pz, float& qx, float& qy,
                                          float& qz, float qscale,
                                          float qstep, float dmax, float& ox,
                                          float& oy, float& oz)
{
    if (!kDeltas) {
        ox = px;
        oy = py;
        oz = pz;
        return;
    }
    ox = oy = oz = 0.f;
    if (save) {
        ox = quant_delta(px, qx, qscale, dmax);
        oy = quant_delta(py, qy, qscale, dmax);
        oz = quant_delta(pz, qz, qscale, dmax);
    }
    qx = quant_next(qx, ox, qstep);
    qy = quant_next(qy, oy, qstep);
    qz = quant_next(qz, oz, qstep);
}

// Row o of out [nsteps * S, 3], f32 points or int8 deltas.
template <bool kDeltas>
__device__ __forceinline__ void store3(void* out, size_t o, float ox,
                                       float oy, float oz)
{
    if (kDeltas) {
        int8_t* d = (int8_t*)out + 3 * o;
        d[0] = (int8_t)ox;
        d[1] = (int8_t)oy;
        d[2] = (int8_t)oz;
    } else {
        float* d = (float*)out + 3 * o;
        d[0] = ox;
        d[1] = oy;
        d[2] = oz;
    }
}

// ops/kernels/propagate.py:_smooth_dir: the EMA of the direction v toward
// w (sc v + sc1 w), renormalised, when smooth; else w.
__device__ __forceinline__ void smooth_dir(float& vx, float& vy, float& vz,
                                           float wx, float wy, float wz,
                                           float sc, float sc1, int smooth)
{
    if (!smooth) {
        vx = wx;
        vy = wy;
        vz = wz;
        return;
    }
    const float sx = __fadd_rn(__fmul_rn(sc, vx), __fmul_rn(sc1, wx));
    const float sy = __fadd_rn(__fmul_rn(sc, vy), __fmul_rn(sc1, wy));
    const float sz = __fadd_rn(__fmul_rn(sc, vz), __fmul_rn(sc1, wz));
    float nrm = __fsqrt_rn(dot3(sx, sy, sz, sx, sy, sz));
    nrm = isnan(nrm) ? nrm : fmaxf(nrm, 1e-20f);         // clamp_min
    vx = __fdiv_rn(sx, nrm);
    vy = __fdiv_rn(sy, nrm);
    vz = __fdiv_rn(sz, nrm);
}

}  // namespace prop
