// Deterministic streamline propagation, one direction of a chunk of
// streams, for Hopper (sm_90a).
//
// Replaces fibers_tpu/tract/stream.py:149-222 (`_propagate`): a jitted
// `jax.lax.scan` over the step function, which XLA compiles into one
// device program (XLA, not Pallas).  The port's plain version,
// ops/kernels/propagate.py:propagate_dir_plain, runs the same step as ~63
// torch launches; here one thread per stream runs all `nsteps` steps with
// its state (pos, vec, the quantizer's pos_q, npts, active) in registers,
// so a direction of a chunk is one launch.  Each step, in the plain
// loop's order: pos_next = pos + vec * step; its voxel (rint, the bounds
// test and the flat index computed here, so no gather leaves the field);
// the nvec candidates of that voxel; the greedy max-|cos| pick (a zero
// vector scores -inf, the first index wins ties, a NaN wins as in
// torch.argmax, ok = isfinite(c), the sign flip on c > 0); the save of
// the current point, or with deltas the error-feedback quantizer; the
// stop rules on bounds/mask, angle and the shared length budget; the EMA
// smoothing; the advance.  A stopped stream writes its frozen point (or a
// zero delta) and saved = false for the steps left, as the plain loop.
//
// Bit-equal to the plain loop on the card: every multiply and add is
// rounded apart (`__fmul_rn`, `__fadd_rn`: nvcc would contract them into
// FMAs, torch's elementwise kernels do not), the square root and quotient
// of the renormalisation are IEEE (`__fsqrt_rn`, `__fdiv_rn`), the sums
// of three products follow torch's CUDA reduction (`dot3`), and the
// quantizer's step is one float64 sum rounded once, as `torch.add` on
// float64 computes it.  The scalars arrive as the float32 values torch's
// kernels make of the Python floats.
//
// What bounds it on an H100: bytes.  Each launch must write the
// [nsteps, S, 3] points (f32) or deltas (i8) and the [nsteps, S] flags,
// and read the start state and, of the field, only the voxels its
// streams visit: at the main path's 131,072 streams x 142 steps the
// outputs and the start state are ~248 MB with f32 points (~0.074 ms at
// 3.35 TB/s), ~80 MB with deltas (~0.024 ms), plus 12 B a vector of
// each visited voxel (chip_smoke.py's [propagate] lines count them).
// What holds this simple design far from that: each thread walks a chain
// of 142 dependent gathers through L2 (the main path's field is 21.6 MB,
// RUMBA's 5 peaks 108 MB), threads of a warp diverge as their streams
// stop, and the 12-byte array-of-structs stores are only partly
// coalesced.  What it reaches is in PERF.md.

#include "propagate_common.cuh"

namespace {

using prop::dot3;
using prop::round_i64;

constexpr int kThreads = 128;

struct Params {
    const float* pos0;      // [S, 3]
    const float* vec0;      // [S, 3]
    const int* npts0;       // [S]
    const float* ovecs;     // [nx * ny * nz, nvec, 3]
    int S, nsteps, nvec, nx, ny, nz;
    float step, cos_thresh, sc, sc1;
    int smooth, len_max;
    float qscale, qstep, dmax;
    void* out;              // [nsteps, S, 3] f32 points or i8 deltas
    uint8_t* saved;         // [nsteps, S] bool
    int* npts;              // [S]
    float* pos_q;           // [S, 3] the anchor
};

template <bool kDeltas>
__global__ void __launch_bounds__(kThreads)
propagate_kernel(const Params p)
{
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= p.S) return;

    float px = p.pos0[3 * s], py = p.pos0[3 * s + 1], pz = p.pos0[3 * s + 2];
    float vx = p.vec0[3 * s], vy = p.vec0[3 * s + 1], vz = p.vec0[3 * s + 2];
    float qx = px, qy = py, qz = pz;
    int n = p.npts0[s];
    bool active = true;

    for (int t = 0; t < p.nsteps; ++t) {
        bool save = false;
        float wx = 0.f, wy = 0.f, wz = 0.f;          // vnext
        float nxp = 0.f, nyp = 0.f, nzp = 0.f;       // pos_next
        if (active) {
            nxp = __fadd_rn(px, __fmul_rn(vx, p.step));
            nyp = __fadd_rn(py, __fmul_rn(vy, p.step));
            nzp = __fadd_rn(pz, __fmul_rn(vz, p.step));
            const long long ix = round_i64(nxp);
            const long long iy = round_i64(nyp);
            const long long iz = round_i64(nzp);
            bool inb;
            const long long flat =
                prop::flat_index(ix, iy, iz, p.nx, p.ny, p.nz, inb);
            if (inb) {
                const float* cand = p.ovecs + flat * p.nvec * 3;
                float best_abs = 0.f, best_c = 0.f;
                float bx = 0.f, by = 0.f, bz = 0.f;
                for (int k = 0; k < p.nvec; ++k) {
                    const float ax = __ldg(cand + 3 * k);
                    const float ay = __ldg(cand + 3 * k + 1);
                    const float az = __ldg(cand + 3 * k + 2);
                    const bool zero = ax == 0.f && ay == 0.f && az == 0.f;
                    const float c =
                        zero ? -INFINITY : dot3(ax, ay, az, vx, vy, vz);
                    const float ca = zero ? -INFINITY : fabsf(c);
                    if (k == 0 || prop::argmax_takes(best_abs, ca)) {
                        best_abs = ca;
                        best_c = c;
                        bx = ax;
                        by = ay;
                        bz = az;
                    }
                }
                save = isfinite(best_c);
                const bool pos_side = best_c > 0.f;
                wx = pos_side ? bx : -bx;
                wy = pos_side ? by : -by;
                wz = pos_side ? bz : -bz;
            }
        }
        n += save;

        const size_t o = (size_t)t * p.S + s;
        float ox, oy, oz;
        prop::point_out<kDeltas>(save, px, py, pz, qx, qy, qz, p.qscale,
                                 p.qstep, p.dmax, ox, oy, oz);
        prop::store3<kDeltas>(p.out, o, ox, oy, oz);
        p.saved[o] = save;

        // post-save stopping rules, then the smoothing and the advance
        const bool cont = save
            && dot3(vx, vy, vz, wx, wy, wz) >= p.cos_thresh
            && n <= p.len_max;
        if (cont) {
            px = nxp;
            py = nyp;
            pz = nzp;
            prop::smooth_dir(vx, vy, vz, wx, wy, wz, p.sc, p.sc1, p.smooth);
        }
        active = cont;
    }
    p.npts[s] = n;
    p.pos_q[3 * s] = qx;
    p.pos_q[3 * s + 1] = qy;
    p.pos_q[3 * s + 2] = qz;
}

// out[i] = dot3(a[i], b[i / bcast]) for [n, 3] rows a and [n / bcast, 3]
// rows b (bcast 0: 1)
__global__ void sum3_kernel(const float* a, const float* b, float* out,
                            int n, int bcast)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int j = bcast > 1 ? i / bcast : i;
    out[i] = dot3(a[3 * i], a[3 * i + 1], a[3 * i + 2], b[3 * j],
                  b[3 * j + 1], b[3 * j + 2]);
}

}  // namespace

extern "C" {

// Launch one direction on `stream` (a cudaStream_t).  Returns a
// cudaError_t, 0 when the launch was accepted.  Does not synchronise.
// S >= 1 and nsteps >= 1; ovecs holds nx * ny * nz * nvec * 3 floats.
int propagate_launch(const float* pos0, const float* vec0, const int* npts0,
                     const float* ovecs, int S, int nsteps, int nvec, int nx,
                     int ny, int nz, float step, float cos_thresh, float sc,
                     float sc1, int smooth, int len_max, int deltas,
                     float qscale, float qstep, float dmax, void* out,
                     void* saved, int* npts, float* pos_q, void* stream)
{
    const Params p{pos0, vec0, npts0, ovecs, S, nsteps, nvec, nx, ny, nz,
                   step, cos_thresh, sc, sc1, smooth, len_max, qscale, qstep,
                   dmax, out, (uint8_t*)saved, npts, pos_q};
    const dim3 grid((S + kThreads - 1) / kThreads);
    const cudaStream_t st = (cudaStream_t)stream;
    if (deltas)
        propagate_kernel<true><<<grid, kThreads, 0, st>>>(p);
    else
        propagate_kernel<false><<<grid, kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
}

// The kernel's dot3 over n rows (see sum3_kernel), for the self-check
// against torch's sum on the card.
int propagate_sum3_selfcheck(const float* a, const float* b, float* out,
                             int n, int bcast, void* stream)
{
    sum3_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        a, b, out, n, bcast);
    return (int)cudaGetLastError();
}

}  // extern "C"
