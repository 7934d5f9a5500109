// Deterministic streamline propagation for Hopper (sm_90a): one direction
// of a chunk of streams (`propagate_launch`), or both directions of it in
// one launch (`propagate_pair_launch`).
//
// Replaces fibers_tpu/tract/stream.py:149-222 (`_propagate`): a jitted
// `jax.lax.scan` over the step function, which XLA compiles into one
// device program (XLA, not Pallas).  The port's plain version,
// ops/kernels/propagate.py:propagate_dir_plain, runs the same step as ~63
// torch launches; here a thread runs all `nsteps` steps of a stream with
// its state (pos, vec, the quantizer's pos_q, npts, active) in registers.
// Each step, in the plain loop's order: pos_next = pos + vec * step; its
// voxel (rint, the bounds test and the flat index computed here, so no
// gather leaves the field); the nvec candidates of that voxel; the greedy
// max-|cos| pick (a zero vector scores -inf, the first index wins ties, a
// NaN wins as in torch.argmax, ok = isfinite(c), the sign flip on c > 0);
// the save of the current point, or with deltas the error-feedback
// quantizer; the stop rules on bounds/mask, angle and the shared length
// budget; the EMA smoothing; the advance.  A stopped stream writes its
// frozen point (or a zero delta) and saved = false for the steps left, as
// the plain loop.
//
// Bit-equal to the plain loop on the card: every multiply and add is
// rounded apart (`__fmul_rn`, `__fadd_rn`: nvcc would contract them into
// FMAs, torch's elementwise kernels do not), the square root and quotient
// of the renormalisation are IEEE (`__fsqrt_rn`, `__fdiv_rn`), the sums
// of three products follow torch's CUDA reduction (`dot3`; where only a
// comparison, |.| or isfinite reads the sum, `dot3_nz`, the same sum but
// for the sign of a zero), and the quantizer's step is one float64 sum
// rounded once, as `torch.add` on float64 computes it.  The scalars arrive
// as the float32 values torch's kernels make of the Python floats.
//
// What bounds it on an H100: bytes.  A direction must write the [nsteps,
// S, 3] points (f32) or deltas (i8) and the [nsteps, S] flags, and read
// the start state and, of the field, only the voxels its streams visit: at
// the main path's 131,072 streams x 142 steps ~248 MB with f32 points
// (~0.074 ms at 3.35 TB/s), ~80 MB with deltas (~0.024 ms), plus 12 B a
// vector of each visited voxel (chip_smoke.py's [propagate] lines count
// them).  What holds it from that (probe_paths.py --paths tract): one
// direction of 131,072 streams keeps ~31 warps an SM issuing a step of
// ~250 instructions while some lane of the warp is still active (the
// issue rate bounds it), and below ~65,536 streams each thread's chain of
// dependent steps (gather, pick, square root, divides) does; i6 takes as
// long as f32 for a third of the bytes.  The design:
// - both directions of a chunk in one launch, two independent chains a
//   thread (the stream's forward and backward chain, stepped in turn), so
//   each thread has twice the work in flight and a chunk is one launch.
//   The backward chain shares the forward count's length budget.  It runs
//   with the budget the forward count so far leaves (a lower bound of the
//   final count, so it stops no earlier than the budget allows), and when
//   the forward chain stops it is cut back to the final budget (`cut`):
//   a direction's saves form a prefix and a stream stops at the first
//   step that saves nothing, so the budgeted chain is the provisional one
//   up to its last budgeted save and frozen after it;
// - the candidate loop at a compile-time count for the fields the chains
//   take (1, 3 and 5 vectors), all loads issued before the picks; the
//   run-time loop for any other count;
// - both chains' gathers and picks (`head`) before either's save and
//   advance (`tail`);
// - 32-bit index arithmetic below 2^31 voxels (propagate.py:_index_bits);
// - once every chain of a warp has stopped, the warp only stores the
//   frozen rows left.
// What it reaches is in PERF.md: the issue rate still bounds it, as the
// warps' chains stop at different steps.

#include "propagate_common.cuh"

namespace {

using prop::dot3;
using prop::dot3_nz;
using prop::voxel;

constexpr int kThreads = 128;

struct Params {
    const float* pos0;      // [S, 3]
    const float* vec0;      // [S, 3] the (forward) heading
    const int* npts0;       // [S] points already on the lines
    const float* ovecs;     // [nx * ny * nz, nvec, 3]
    int S, nsteps, nvec, nx, ny, nz;
    float step, cos_thresh, sc, sc1;
    int smooth, len_max;
    float qscale, qstep, dmax;
    void* out;              // [nsteps, S, 3] f32 points or i8 deltas
    uint8_t* saved;         // [nsteps, S] bool
    int* npts;              // [S]
    float* pos_q;           // [S, 3] the anchor
    void* out_b;            // the backward direction's out, saved and
    uint8_t* saved_b;       // npts (pair launches only)
    int* npts_b;
};

// One direction's state: position, heading, the quantizer's position, the
// points on the line, and whether the stream still steps.
struct Chain {
    float px, py, pz, vx, vy, vz, qx, qy, qz;
    int n;
    bool active;
};

__device__ __forceinline__ Chain start(const Params& p, int s, bool back,
                                       int n)
{
    Chain c;
    c.px = c.qx = p.pos0[3 * s];
    c.py = c.qy = p.pos0[3 * s + 1];
    c.pz = c.qz = p.pos0[3 * s + 2];
    c.vx = back ? -p.vec0[3 * s] : p.vec0[3 * s];
    c.vy = back ? -p.vec0[3 * s + 1] : p.vec0[3 * s + 1];
    c.vz = back ? -p.vec0[3 * s + 2] : p.vec0[3 * s + 2];
    c.n = n;
    c.active = true;
    return c;
}

// Candidate k of the pick: a zero vector scores -inf; the lower index wins
// ties, a NaN wins (torch.argmax).  |cos| and cos > 0 do not see the sign
// of a zero sum.
__device__ __forceinline__ void consider(int k, float ax, float ay,
                                         float az, float vx, float vy,
                                         float vz, float& best_abs,
                                         float& best_c, float& bx,
                                         float& by, float& bz)
{
    const bool zero = ax == 0.f && ay == 0.f && az == 0.f;
    const float c = zero ? -INFINITY : dot3_nz(ax, ay, az, vx, vy, vz);
    const float ca = zero ? -INFINITY : fabsf(c);
    if (k == 0 || prop::argmax_takes(best_abs, ca)) {
        best_abs = ca;
        best_c = c;
        bx = ax;
        by = ay;
        bz = az;
    }
}

// The greedy pick among the candidates at `cand` (kNvec of them, all
// loaded first; with kNvec 0, nvec in a run-time loop): the signed cos of
// the candidate with the largest |cos| to (vx, vy, vz), and the candidate.
template <int kNvec>
__device__ __forceinline__ float pick(const float* cand, int nvec, float vx,
                                      float vy, float vz, float& bx,
                                      float& by, float& bz)
{
    float best_abs = 0.f, best_c = 0.f;
    bx = by = bz = 0.f;
    if constexpr (kNvec > 0) {
        float a[3 * kNvec];
#pragma unroll
        for (int i = 0; i < 3 * kNvec; ++i) a[i] = __ldg(cand + i);
#pragma unroll
        for (int k = 0; k < kNvec; ++k)
            consider(k, a[3 * k], a[3 * k + 1], a[3 * k + 2], vx, vy, vz,
                     best_abs, best_c, bx, by, bz);
    } else {
        for (int k = 0; k < nvec; ++k)
            consider(k, __ldg(cand + 3 * k), __ldg(cand + 3 * k + 1),
                     __ldg(cand + 3 * k + 2), vx, vy, vz, best_abs, best_c,
                     bx, by, bz);
    }
    return best_c;
}

// The first half of a chain's step, which stores nothing: the next
// position and, in the volume, the pick among its voxel's candidates
// (whether the current point is saved, and the next direction).  A
// stopped chain saves nothing.
struct Head {
    float nx, ny, nz, wx, wy, wz;
    bool save;
};

template <typename Idx, int kNvec>
__device__ __forceinline__ Head head(const Params& p, const Chain& c)
{
    Head h{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
    if (c.active) {
        h.nx = __fadd_rn(c.px, __fmul_rn(c.vx, p.step));
        h.ny = __fadd_rn(c.py, __fmul_rn(c.vy, p.step));
        h.nz = __fadd_rn(c.pz, __fmul_rn(c.vz, p.step));
        bool inb;
        const Idx flat = prop::flat_index(voxel<Idx>(h.nx), voxel<Idx>(h.ny),
                                          voxel<Idx>(h.nz), p.nx, p.ny, p.nz,
                                          inb);
        if (inb) {
            const int nvec = kNvec > 0 ? kNvec : p.nvec;
            float bx, by, bz;
            const float best_c = pick<kNvec>(
                p.ovecs + (size_t)flat * (3 * nvec), nvec, c.vx, c.vy, c.vz,
                bx, by, bz);
            h.save = isfinite(best_c);
            const bool pos_side = best_c > 0.f;
            h.wx = pos_side ? bx : -bx;
            h.wy = pos_side ? by : -by;
            h.wz = pos_side ? bz : -bz;
        }
    }
    return h;
}

// The second half: the save of the current point (or of its delta) into
// out/saved row o, then the stop rules, the chain continuing while its
// point count stays within `budget`, the smoothing and the advance.  A
// stopped chain stores its frozen point (or a zero delta, which leaves its
// quantizer where it is).
template <bool kDeltas>
__device__ __forceinline__ void tail(const Params& p, Chain& c, const Head& h,
                                     int budget, void* out, uint8_t* saved,
                                     size_t o)
{
    c.n += h.save;
    float ox, oy, oz;
    prop::point_out<kDeltas>(h.save, c.px, c.py, c.pz, c.qx, c.qy, c.qz,
                             p.qscale, p.qstep, p.dmax, ox, oy, oz);
    prop::store3<kDeltas>(out, o, ox, oy, oz);
    saved[o] = h.save;

    // post-save stopping rules, then the smoothing and the advance
    const bool cont = h.save
        && dot3_nz(c.vx, c.vy, c.vz, h.wx, h.wy, h.wz) >= p.cos_thresh
        && c.n <= budget;
    if (cont) {
        c.px = h.nx;
        c.py = h.ny;
        c.pz = h.nz;
        prop::smooth_dir(c.vx, c.vy, c.vz, h.wx, h.wy, h.wz, p.sc, p.sc1,
                         p.smooth);
    }
    c.active = cont;
}

// Row o of a stopped chain: its frozen point (or a zero delta), not saved.
template <bool kDeltas>
__device__ __forceinline__ void frozen(const Chain& c, void* out,
                                       uint8_t* saved, size_t o)
{
    prop::store3<kDeltas>(out, o, kDeltas ? 0.f : c.px, kDeltas ? 0.f : c.py,
                          kDeltas ? 0.f : c.pz);
    saved[o] = 0;
}

// A thread a stream; the threads of a warp take their steps together
// (their rows are neighbours), and once all of them have stopped, the warp
// only stores the frozen rows left.
template <typename Idx, int kNvec, bool kDeltas>
__global__ void __launch_bounds__(kThreads)
propagate_kernel(const Params p)
{
    const int s = blockIdx.x * kThreads + threadIdx.x;
    const bool mine = s < p.S;
    Chain c = start(p, mine ? s : 0, false, mine ? p.npts0[s] : 0);
    c.active = mine;
    int t = 0;
    for (; t < p.nsteps && __any_sync(0xffffffffu, c.active); ++t)
        if (mine)
            tail<kDeltas>(p, c, head<Idx, kNvec>(p, c), p.len_max, p.out,
                          p.saved, (size_t)t * p.S + s);
    if (!mine)
        return;
    for (; t < p.nsteps; ++t)
        frozen<kDeltas>(c, p.out, p.saved, (size_t)t * p.S + s);
    p.npts[s] = c.n;
    p.pos_q[3 * s] = c.qx;
    p.pos_q[3 * s + 1] = c.qy;
    p.pos_q[3 * s + 2] = c.qz;
}

// The backward chain b of stream s, which stored rows 0..t-1 under a
// provisional budget, cut to the budget of the forward chain's final count
// nf.  The budgeted chain saves at most cap = max(len_max - nf, 0) + 1
// points: its n after a save at step u is nf + u + 1, and it stops after
// the first save past len_max.  Up to that save it is the provisional
// chain (whose budget was never smaller), so when the provisional chain
// holds cap points or more, the budgeted one saved cap points, stopped at
// step cap - 1 and froze there: the rows after it are rewritten as the
// frozen point (or zero deltas), not saved, and the chain stops.  With
// fewer points it already kept to the budget and goes on with it.
template <bool kDeltas>
__device__ __forceinline__ void cut(const Params& p, Chain& b, int nf, int t,
                                    int s)
{
    const int cap = max(p.len_max - nf, 0) + 1;
    if (b.n < cap) return;
    const int last = cap - 1;
    if (!kDeltas) {
        const float* q = (const float*)p.out_b + 3 * ((size_t)last * p.S + s);
        b.px = q[0];
        b.py = q[1];
        b.pz = q[2];
    }
    for (int u = cap; u < t; ++u)
        frozen<kDeltas>(b, p.out_b, p.saved_b, (size_t)u * p.S + s);
    b.n = cap;
    b.active = false;
}

// Both directions of stream s: the forward chain from (pos0, vec0) with
// npts0 points, the backward one from (pos0, -vec0) with the forward
// chain's final count, as the two propagate_kernel launches the plain
// version makes; the backward anchor is not kept.  Once every chain of
// the warp has stopped (and been cut), it only stores frozen rows.
template <typename Idx, int kNvec, bool kDeltas>
__global__ void __launch_bounds__(kThreads, 8)
propagate_pair_kernel(const Params p)
{
    const int s = blockIdx.x * kThreads + threadIdx.x;
    const bool mine = s < p.S;
    Chain f = start(p, mine ? s : 0, false, mine ? p.npts0[s] : 0);
    Chain b = start(p, mine ? s : 0, true, 0);
    f.active = b.active = mine;
    bool resolved = !mine;
    int t = 0;
    for (; t < p.nsteps && __any_sync(0xffffffffu, f.active || b.active);
         ++t) {
        if (!mine)
            continue;
        // both chains' gathers and picks first, independent of each other
        const size_t o = (size_t)t * p.S + s;
        const Head hf = head<Idx, kNvec>(p, f);
        Head hb = head<Idx, kNvec>(p, b);
        tail<kDeltas>(p, f, hf, p.len_max, p.out, p.saved, o);
        if (!f.active && !resolved) {
            cut<kDeltas>(p, b, f.n, t, s);
            resolved = true;
            hb.save = hb.save && b.active;      // a cut chain saves nothing
        }
        // f.n: the final count once resolved, a lower bound before
        tail<kDeltas>(p, b, hb, p.len_max - f.n, p.out_b, p.saved_b, o);
    }
    if (!mine)
        return;
    if (!resolved)
        cut<kDeltas>(p, b, f.n, p.nsteps, s);
    for (; t < p.nsteps; ++t) {
        const size_t o = (size_t)t * p.S + s;
        frozen<kDeltas>(f, p.out, p.saved, o);
        frozen<kDeltas>(b, p.out_b, p.saved_b, o);
    }
    p.npts[s] = f.n;
    p.pos_q[3 * s] = f.qx;
    p.pos_q[3 * s + 1] = f.qy;
    p.pos_q[3 * s + 2] = f.qz;
    p.npts_b[s] = f.n + b.n;
}

template <typename Idx, int kNvec, bool kDeltas>
cudaError_t launch(const Params& p, bool pair, cudaStream_t st)
{
    const dim3 grid((p.S + kThreads - 1) / kThreads);
    if (pair)
        propagate_pair_kernel<Idx, kNvec, kDeltas><<<grid, kThreads, 0, st>>>(
            p);
    else
        propagate_kernel<Idx, kNvec, kDeltas><<<grid, kThreads, 0, st>>>(p);
    return cudaGetLastError();
}

// The instance for the field's nvec (1, 3 or 5 at compile time, else the
// run-time loop) and the index arithmetic (64-bit: the run-time loop).
template <bool kDeltas>
cudaError_t dispatch(const Params& p, bool pair, int index_bits,
                     cudaStream_t st)
{
    if (index_bits == 64)
        return launch<long long, 0, kDeltas>(p, pair, st);
    if (index_bits != 32)
        return cudaErrorInvalidValue;
    switch (p.nvec) {
    case 1: return launch<int, 1, kDeltas>(p, pair, st);
    case 3: return launch<int, 3, kDeltas>(p, pair, st);
    case 5: return launch<int, 5, kDeltas>(p, pair, st);
    default: return launch<int, 0, kDeltas>(p, pair, st);
    }
}

template <typename K>
int resident(K kernel)
{
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                         0)
        ? -1 : n * kThreads;
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

// Launch one direction (pair 0) or both (pair 1) on `stream` (a
// cudaStream_t).  Returns a cudaError_t, 0 when the launch was accepted.
// Does not synchronise.  S >= 1 and nsteps >= 1; ovecs holds nx * ny * nz
// * nvec * 3 floats; index_bits 32 (fewer than 2^31 voxels, each dimension
// below 2^29) or 64.  The backward direction's heading is -vec0, its
// outputs out_b, saved_b and npts_b (the total count, as npts0 = the
// forward npts would give it).
int propagate_launch(const float* pos0, const float* vec0, const int* npts0,
                     const float* ovecs, int S, int nsteps, int nvec, int nx,
                     int ny, int nz, float step, float cos_thresh, float sc,
                     float sc1, int smooth, int len_max, int deltas,
                     float qscale, float qstep, float dmax, void* out,
                     void* saved, int* npts, float* pos_q, void* out_b,
                     void* saved_b, int* npts_b, int pair, int index_bits,
                     void* stream)
{
    const Params p{pos0, vec0, npts0, ovecs, S, nsteps, nvec, nx, ny, nz,
                   step, cos_thresh, sc, sc1, smooth, len_max, qscale, qstep,
                   dmax, out, (uint8_t*)saved, npts, pos_q, out_b,
                   (uint8_t*)saved_b, npts_b};
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(deltas ? dispatch<true>(p, pair != 0, index_bits, st)
                        : dispatch<false>(p, pair != 0, index_bits, st));
}

// Threads an SM holds of the 32-bit instance for `nvec` (1, 3, 5, or any
// other: the run-time loop) of the pair (1) or one-direction (0) kernel,
// points or deltas (the occupancy API); -1 on an error.
int propagate_resident_threads(int pair, int nvec, int deltas)
{
#define PROP_RESIDENT(N, D)                                                 \
    return pair ? resident(propagate_pair_kernel<int, N, D>)                \
                : resident(propagate_kernel<int, N, D>)
    if (deltas) {
        switch (nvec) {
        case 1: PROP_RESIDENT(1, true);
        case 3: PROP_RESIDENT(3, true);
        case 5: PROP_RESIDENT(5, true);
        default: PROP_RESIDENT(0, true);
        }
    }
    switch (nvec) {
    case 1: PROP_RESIDENT(1, false);
    case 3: PROP_RESIDENT(3, false);
    case 5: PROP_RESIDENT(5, false);
    default: PROP_RESIDENT(0, false);
    }
#undef PROP_RESIDENT
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
