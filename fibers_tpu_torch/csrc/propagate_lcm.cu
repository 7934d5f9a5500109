// LCM-guided (probabilistic) streamline propagation, one direction of a
// chunk of streams, for Hopper (sm_90a).
//
// Replaces fibers_tpu/tract/modes.py:45-180 (`_propagate_lcm`): a jitted
// `jax.lax.scan` over the step function, which XLA compiles into one device
// program (XLA, not Pallas).  The port's plain version,
// ops/kernels/propagate_lcm.py:propagate_lcm_dir_plain, runs each step as a
// few hundred torch launches; here one thread per stream runs all `nsteps`
// steps with its state (pos, vec, the previous vector index, the
// quantizer's pos_q, npts, active) in registers, so a direction of a chunk
// is one launch.  Each step, in the plain loop's order: pos_next = pos +
// vec * step, its voxel and the current one (the flat index computed and
// bounds-tested here, so no gather leaves the field), the mask; the
// conventional angle pick over the voxel's nvec candidates (for the
// difference flag and its ok); then either the same-voxel branch (continue
// along the previous index) or the LCM branch: the diagonal-jump rule on
// the two in-plane dims, the entry edge (the first of the four that
// matches, and whether one does), the LCM row masked to the pairs holding
// the entry edge, havelcm = its sum > 0, the Gumbel-max draw over the ten
// elements, the exit edge, the jump vector and the candidate best aligned
// with it; the save of the current point (or its error-feedback delta), the
// int8 method-difference flag, the length budget (no angle threshold), the
// EMA smoothing and the advance.  A step whose point is not saved stops the
// stream; the branches whose results only a saved point uses are skipped
// (the draws are counter-based, so skipping draws changes no later draw),
// and a stopped stream stores its frozen point (or a zero delta), saved =
// false and flag 0 for the steps left, as the plain loop does.
//
// The draws: Philox4x32-10 keyed by the direction's 64-bit key, counter
// (stream index in the chunk, step, block 0..2, 0); element j of the step's
// ten uniforms is word j % 4 of block j / 4, u = (word >> 8) * 2^-24
// clamped at FLT_MIN.  The plain version computes the same words with
// torch int64 operations (propagate_lcm.py:lcm_uniforms).
//
// Bit-equal to the plain loop on the card through the shared step helpers
// (propagate_common.cuh), torch's CUDA order for the sum of the ten LCM
// elements (sum10), the CUDA math library's logf as torch.log calls it,
// and torch.argmax's rules.  propagate_lcm.py:lcm_selfcheck holds logf,
// the Gumbel transform over all 2^24 uniforms, sum10, the argmax and the
// uniforms to torch on the card.
//
// What bounds it on an H100: bytes.  A direction must write the [nsteps,
// S, 3] points (f32) or deltas (i8), the [nsteps, S] saved and flag bytes,
// and read the start state and the visited voxels' candidates and LCM rows
// (40 B each).  What holds this simple design far from that: a chain of
// dependent gathers a thread, per step three Philox blocks (60 multiplies
// of 32 bits) and twenty logf where a new voxel is entered, divergence
// between the same-voxel and LCM branches and as streams stop, and
// partly coalesced 12-byte stores.  What it reaches is in PERF.md.

#include <float.h>

#include "propagate_common.cuh"

namespace {

using prop::argmax_takes;
using prop::dot3;
using prop::round_i64;

constexpr int kThreads = 128;
constexpr int kL = 10;                      // elements of an LCM row

struct LcmParams {
    const float* pos0;      // [S, 3]
    const float* vec0;      // [S, 3]
    const int* npts0;       // [S]
    const uint8_t* mask;    // [nx * ny * nz] bool
    const float* ovecs;     // [nx * ny * nz, nvec, 3]
    const float* lcms;      // [nx * ny * nz, 10]
    const long long* dxyz;  // [3, 4] in-plane increments of the four edges
    const long long* edget; // [2, 10] the edges of each LCM element
    int S, nsteps, nvec, nx, ny, nz, a, b;
    unsigned k0, k1;
    float step, sc, sc1;
    int smooth, len_max;
    float qscale, qstep, dmax;
    void* out;              // [nsteps, S, 3] f32 points or i8 deltas
    uint8_t* saved;         // [nsteps, S] bool
    int8_t* flags;          // [nsteps, S] method-difference flags
    int* npts;              // [S]
    float* pos_q;           // [S, 3] the anchor
};

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants) on counter c
// with key (k0, k1), in place.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1)
{
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t lo0 = 0xD2511F53u * c[0];
        const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
        const uint32_t lo1 = 0xCD9E8D57u * c[2];
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
        c[0] = hi1 ^ c[1] ^ k0;
        c[1] = lo1;
        c[2] = hi0 ^ c[3] ^ k1;
        c[3] = lo0;
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
}

// A 32-bit word as a uniform: its top 24 bits times 2^-24, clamped at the
// smallest normal float (torch.clamp_min(u, finfo.tiny)).
__device__ __forceinline__ float word_uniform(uint32_t w)
{
    return fmaxf(__fmul_rn(__uint2float_rn(w >> 8), 0x1p-24f), FLT_MIN);
}

// The ten uniforms of stream s at step t.
__device__ __forceinline__ void lcm_uniforms(uint32_t k0, uint32_t k1,
                                             uint32_t s, uint32_t t,
                                             float u[kL])
{
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
        uint32_t c[4] = {s, t, (uint32_t)blk, 0u};
        philox4x32_10(c, k0, k1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (4 * blk + i < kL) u[4 * blk + i] = word_uniform(c[i]);
    }
}

// -log(-log(u)), as torch.log runs on the card (the CUDA math library's
// logf, no fast math).
__device__ __forceinline__ float gumbel(float u)
{
    return -logf(-logf(u));
}

// torch.log(torch.clamp_min(x, 1e-30)): a NaN passes the clamp.
__device__ __forceinline__ float log_clamped(float x)
{
    return logf(isnan(x) ? x : fmaxf(x, 1e-30f));
}

// The sum of a row of ten as torch's CUDA reduction takes it over a
// contiguous last dimension of 10 (ATen/native/cuda/Reduce.cuh): eight
// lanes, lane k reducing elements k and k + 8 into separate accumulators
// that start at 0 and combine in order, then the lanes by shuffles down
// at offsets 4, 2 and 1).  Adding the idle accumulators' zeros changes no
// value here, as no lane sum can be -0.
__device__ __forceinline__ float sum10(const float m[kL])
{
    float l[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) l[k] = __fadd_rn(0.f, m[k]);
    l[0] = __fadd_rn(l[0], __fadd_rn(0.f, m[8]));
    l[1] = __fadd_rn(l[1], __fadd_rn(0.f, m[9]));
    return __fadd_rn(
        __fadd_rn(__fadd_rn(l[0], l[4]), __fadd_rn(l[2], l[6])),
        __fadd_rn(__fadd_rn(l[1], l[5]), __fadd_rn(l[3], l[7])));
}

__device__ __forceinline__ int argmax10(const float v[kL])
{
    float best = v[0];
    int ib = 0;
#pragma unroll
    for (int j = 1; j < kL; ++j)
        if (argmax_takes(best, v[j])) {
            best = v[j];
            ib = j;
        }
    return ib;
}

// v[i] of a three-element register array, without indexing it by a
// run-time value (which would move it to local memory).
template <typename T>
__device__ __forceinline__ T at3(const T v[3], int i)
{
    return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

// The candidate of `cand` [nvec, 3] with the largest |cos| to (dx, dy, dz)
// (dot3 of candidate and direction; a zero candidate scores -inf):
// its index, its signed cos (-inf when zero) and the candidate.
__device__ __forceinline__ int pick(const float* cand, int nvec, float dx,
                                    float dy, float dz, float& c_best,
                                    float& bx, float& by, float& bz)
{
    float best_abs = 0.f;
    int ib = 0;
    c_best = 0.f;
    bx = by = bz = 0.f;
    for (int k = 0; k < nvec; ++k) {
        const float ax = __ldg(cand + 3 * k);
        const float ay = __ldg(cand + 3 * k + 1);
        const float az = __ldg(cand + 3 * k + 2);
        const bool zero = ax == 0.f && ay == 0.f && az == 0.f;
        const float c = zero ? -INFINITY : dot3(ax, ay, az, dx, dy, dz);
        const float ca = zero ? -INFINITY : fabsf(c);
        if (k == 0 || argmax_takes(best_abs, ca)) {
            best_abs = ca;
            ib = k;
            c_best = c;
            bx = ax;
            by = ay;
            bz = az;
        }
    }
    return ib;
}

template <bool kDeltas>
__global__ void __launch_bounds__(kThreads)
lcm_kernel(const LcmParams p)
{
    __shared__ int sd[3][4], se[2][kL];
    if (threadIdx.x < 12) sd[threadIdx.x / 4][threadIdx.x % 4] =
        (int)p.dxyz[threadIdx.x];
    else if (threadIdx.x < 12 + 2 * kL) {
        const int i = threadIdx.x - 12;
        se[i / kL][i % kL] = (int)p.edget[i];
    }
    __syncthreads();
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= p.S) return;

    float pos[3] = {p.pos0[3 * s], p.pos0[3 * s + 1], p.pos0[3 * s + 2]};
    float vx = p.vec0[3 * s], vy = p.vec0[3 * s + 1], vz = p.vec0[3 * s + 2];
    float qx = pos[0], qy = pos[1], qz = pos[2];
    int n = p.npts0[s];
    int ivec_prev = 0;

    int t = 0;
    for (; t < p.nsteps; ++t) {
        const float nxt[3] = {__fadd_rn(pos[0], __fmul_rn(vx, p.step)),
                              __fadd_rn(pos[1], __fmul_rn(vy, p.step)),
                              __fadd_rn(pos[2], __fmul_rn(vz, p.step))};
        long long inext[3], dv[3];
        for (int d = 0; d < 3; ++d) {
            inext[d] = round_i64(nxt[d]);
            dv[d] = round_i64(pos[d]) - inext[d];
        }
        bool inb;
        const long long flat = prop::flat_index(inext[0], inext[1], inext[2],
                                                p.nx, p.ny, p.nz, inb);
        const float* cand = p.ovecs + flat * p.nvec * 3;

        bool save = false;
        int ivec_next = ivec_prev, ivec_ang = 0;
        float wx = 0.f, wy = 0.f, wz = 0.f;          // vnext
        if (inb && p.mask[flat]) {
            // the conventional angle pick, for the flag and its ok
            float c_ang, ax, ay, az;
            ivec_ang = pick(cand, p.nvec, vx, vy, vz, c_ang, ax, ay, az);
            const bool same_vox = dv[0] == 0 && dv[1] == 0 && dv[2] == 0;
            if (!isfinite(c_ang)) {
                // not saved, whatever the branch
            } else if (same_vox) {
                // continue along the previous index
                const float* vp = cand + 3 * ivec_prev;
                const float px_ = __ldg(vp), py_ = __ldg(vp + 1),
                            pz_ = __ldg(vp + 2);
                const bool pos_side = dot3(vx, vy, vz, px_, py_, pz_) > 0.f;
                wx = pos_side ? px_ : -px_;
                wy = pos_side ? py_ : -py_;
                wz = pos_side ? pz_ : -pz_;
                save = true;
            } else {
                // a diagonal jump keeps only its slower-changing in-plane
                // dim (src/stream.jl:422-437)
                const float da =
                    fabsf(__fsub_rn(at3(pos, p.a), at3(nxt, p.a)));
                const float db =
                    fabsf(__fsub_rn(at3(pos, p.b), at3(nxt, p.b)));
                if (at3(dv, p.a) != 0 && at3(dv, p.b) != 0) {
                    const int zeroed = da < db ? p.b : p.a;
#pragma unroll
                    for (int d = 0; d < 3; ++d)
                        if (d == zeroed) dv[d] = 0;
                }
                int entry = 0;
                bool matched = false;
                for (int e = 3; e >= 0; --e)
                    if (dv[0] == sd[0][e] && dv[1] == sd[1][e]
                            && dv[2] == sd[2][e]) {
                        entry = e;
                        matched = true;
                    }
                float m[kL], val[kL], u[kL];
                const float* row = p.lcms + flat * kL;
#pragma unroll
                for (int j = 0; j < kL; ++j) {
                    const bool has = se[0][j] == entry || se[1][j] == entry;
                    m[j] = has && matched ? __ldg(row + j) : 0.f;
                }
                const bool havelcm = sum10(m) > 0.f;
                lcm_uniforms(p.k0, p.k1, (uint32_t)s, (uint32_t)t, u);
#pragma unroll
                for (int j = 0; j < kL; ++j)
                    val[j] = __fadd_rn(log_clamped(m[j]), gumbel(u[j]));
                const int ilcm = argmax10(val);
                const int e0 = se[0][ilcm], e1 = se[1][ilcm];
                const int exit_edge = e0 == entry ? e1 : e0;
                float c_new, bx, by, bz;
                ivec_next = pick(cand, p.nvec, (float)sd[0][exit_edge],
                                 (float)sd[1][exit_edge],
                                 (float)sd[2][exit_edge], c_new, bx, by, bz);
                const bool pos_side = c_new > 0.f;
                wx = pos_side ? bx : -bx;
                wy = pos_side ? by : -by;
                wz = pos_side ? bz : -bz;
                save = isfinite(c_new) && havelcm;
            }
        }
        n += save;
        const size_t o = (size_t)t * p.S + s;
        float ox, oy, oz;
        prop::point_out<kDeltas>(save, pos[0], pos[1], pos[2], qx, qy, qz,
                                 p.qscale, p.qstep, p.dmax, ox, oy, oz);
        prop::store3<kDeltas>(p.out, o, ox, oy, oz);
        p.saved[o] = save;
        p.flags[o] = save && ivec_next != ivec_ang;

        // no angle threshold in LCM mode (src/stream.jl:668-671)
        if (!(save && n <= p.len_max)) {
            ++t;
            break;
        }
        pos[0] = nxt[0];
        pos[1] = nxt[1];
        pos[2] = nxt[2];
        prop::smooth_dir(vx, vy, vz, wx, wy, wz, p.sc, p.sc1, p.smooth);
        ivec_prev = ivec_next;
    }
    // stopped: the frozen point (or a zero delta), not saved, for the
    // steps left
    for (; t < p.nsteps; ++t) {
        const size_t o = (size_t)t * p.S + s;
        if (kDeltas)
            prop::store3<kDeltas>(p.out, o, 0.f, 0.f, 0.f);
        else
            prop::store3<kDeltas>(p.out, o, pos[0], pos[1], pos[2]);
        p.saved[o] = 0;
        p.flags[o] = 0;
    }
    p.npts[s] = n;
    p.pos_q[3 * s] = qx;
    p.pos_q[3 * s + 1] = qy;
    p.pos_q[3 * s + 2] = qz;
}

// The self-check's functions of the kernel, one per mode, for element i:
// 0 logf(x[i]); 1 the Gumbel transform of the uniform of word i << 8;
// 2 sum10 of row i of x [n, 10]; 3 argmax10 of that row (int32 out);
// 4 the ten uniforms of stream i at step t under (k0, k1) (out [n, 10]).
__global__ void lcm_check_kernel(int mode, const float* x, void* out,
                                 long long n, uint32_t k0, uint32_t k1, int t)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float* f = (float*)out;
    if (mode == 0) {
        f[i] = logf(x[i]);
    } else if (mode == 1) {
        f[i] = gumbel(word_uniform((uint32_t)i << 8));
    } else if (mode == 2 || mode == 3) {
        float m[kL];
        for (int j = 0; j < kL; ++j) m[j] = x[kL * i + j];
        if (mode == 2) f[i] = sum10(m);
        else ((int*)out)[i] = argmax10(m);
    } else {
        float u[kL];
        lcm_uniforms(k0, k1, (uint32_t)i, (uint32_t)t, u);
        for (int j = 0; j < kL; ++j) f[kL * i + j] = u[j];
    }
}

}  // namespace

extern "C" {

// Launch one direction on `stream` (a cudaStream_t).  Returns a
// cudaError_t, 0 when the launch was accepted.  Does not synchronise.
// S >= 1, nsteps >= 1; mask, ovecs and lcms over nx * ny * nz voxels;
// (a, b) the two in-plane dims.
int propagate_lcm_launch(const float* pos0, const float* vec0,
                         const int* npts0, const void* mask,
                         const float* ovecs, const float* lcms,
                         const long long* dxyz, const long long* edget, int S,
                         int nsteps, int nvec, int nx, int ny, int nz, int a,
                         int b, unsigned k0, unsigned k1, float step,
                         float sc, float sc1, int smooth, int len_max,
                         int deltas, float qscale, float qstep, float dmax,
                         void* out, void* saved, void* flags, int* npts,
                         float* pos_q, void* stream)
{
    const LcmParams p{pos0, vec0, npts0, (const uint8_t*)mask, ovecs, lcms,
                      dxyz, edget, S, nsteps, nvec, nx, ny, nz, a, b, k0, k1,
                      step, sc, sc1, smooth, len_max, qscale, qstep, dmax,
                      out, (uint8_t*)saved, (int8_t*)flags, npts, pos_q};
    const dim3 grid((S + kThreads - 1) / kThreads);
    const cudaStream_t st = (cudaStream_t)stream;
    if (deltas)
        lcm_kernel<true><<<grid, kThreads, 0, st>>>(p);
    else
        lcm_kernel<false><<<grid, kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
}

// lcm_check_kernel over n elements, for the self-check against torch.
int propagate_lcm_selfcheck(int mode, const float* x, void* out, long long n,
                            unsigned k0, unsigned k1, int t, void* stream)
{
    lcm_check_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(mode, x, out, n, k0, k1, t);
    return (int)cudaGetLastError();
}

}  // extern "C"
