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
// (40 B each).  It is far from that (probe_paths.py --paths tract): a
// forward direction of the 256^2 run is ~240 steps of every stream, and
// each step that enters a voxel issues a draw that the whole warp waits
// through.  The first design spent most of its time in the draw (three
// Philox blocks and thirty logf) and in its gathers.  The design:
// - only the draw that can matter: none where the masked row sums to 0
//   (nothing is saved there); the Gumbel terms of the live elements alone
//   (those the entry edge keeps whose logit is above log(1e-30)), with a
//   guard that proves no other element can win (`draw_pick`; all ten
//   otherwise);
// - what a step entering a voxel through an edge needs of its LCM row, the
//   four kept elements' logits (torch.log's) and the masked sum, in one
//   32-byte sector of a table the launch builds first (`lcm_table_kernel`);
// - the Philox words computed while the step's gathers are in flight,
//   with the round keys in the kernel's parameters; two candidates in
//   registers for a field of two;
// - persistent blocks: the grid is what the card holds resident (the
//   occupancy API); every kCompact steps a block moves its running streams
//   to its first threads and takes new streams from a counter for the
//   rest, so its warps stay full; the draws stay keyed by (stream, step,
//   block), so which thread runs a stream changes nothing;
// - the frozen tails written coalesced: the warp that stops the last
//   stream of a group of 32 consecutive streams writes the group's tails,
//   a lane a stream, a row at a time;
// - 32-bit index arithmetic below 2^31 voxels (propagate.py:_index_bits);
//   at most 64 registers a thread, so that four blocks fit an SM.
// What it reaches is in PERF.md.

#include <float.h>

#include <algorithm>

#include "propagate_common.cuh"

namespace {

using prop::argmax_takes;
using prop::dot3;
using prop::voxel;

constexpr int kThreads = 256;               // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;             // 64 registers a thread at most
constexpr int kCompact = 8;                 // steps between compactions
constexpr int kL = 10;                      // elements of an LCM row
constexpr unsigned kFull = 0xffffffffu;
// Above every Gumbel value of a draw: -logf(-logf(u)) for u <= 1 - 2^-24
// is at most ~16.64 (lcm_selfcheck's "gumbel_max" holds all 2^24 of them
// below it on the card).
constexpr float kGumbelMax = 17.0f;

struct LcmParams {
    const float* pos0;      // [S, 3]
    const float* vec0;      // [S, 3]
    const int* npts0;       // [S]
    const uint8_t* mask;    // [nx * ny * nz] bool
    const float* ovecs;     // [nx * ny * nz, nvec, 3]
    const float* lcms;      // [nx * ny * nz, 10]
    const float* table;     // [nx * ny * nz, 4, 8] (lcm_table_kernel)
    const long long* dxyz;  // [3, 4] in-plane increments of the four edges
    const long long* edget; // [2, 10] the edges of each LCM element
    int S, nsteps, nvec, nx, ny, nz, a, b;
    uint32_t rk[20];        // Philox's round keys (`round_keys`)
    float step, sc, sc1;
    int smooth, len_max;
    float qscale, qstep, dmax;
    void* out;              // [nsteps, S, 3] f32 points or i8 deltas
    uint8_t* saved;         // [nsteps, S] bool
    int8_t* flags;          // [nsteps, S] method-difference flags
    int* npts;              // [S]
    float* pos_q;           // [S, 3] the anchor
    int* next;              // the next stream to take, 0 at the launch
    int* done;              // [ceil(S / 32)] streams stopped, 0 at the launch
    int* stop;              // [S] the steps each stream took
};

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants) on counter c,
// in place, with the round keys rk[2 r], rk[2 r + 1] of round r (from the
// key (k0, k1): `round_keys`; in the kernel read from its parameters).
__device__ __forceinline__ void philox_rk(uint32_t c[4], const uint32_t* rk)
{
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t lo0 = 0xD2511F53u * c[0];
        const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
        const uint32_t lo1 = 0xCD9E8D57u * c[2];
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
        c[0] = hi1 ^ c[1] ^ rk[2 * r];
        c[1] = lo1;
        c[2] = hi0 ^ c[3] ^ rk[2 * r + 1];
        c[3] = lo0;
    }
}

// The key schedule: k0 + r W0 and k1 + r W1 for the rounds r = 0..9.
__device__ __host__ __forceinline__ void round_keys(uint32_t k0, uint32_t k1,
                                                    uint32_t rk[20])
{
    for (int r = 0; r < 10; ++r) {
        rk[2 * r] = k0;
        rk[2 * r + 1] = k1;
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
__device__ __forceinline__ void lcm_uniforms(const uint32_t* rk, uint32_t s,
                                             uint32_t t, float u[kL])
{
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
        uint32_t c[4] = {s, t, (uint32_t)blk, 0u};
        philox_rk(c, rk);
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

// v[j] of ten values in registers for a run-time j in 0..9 (any value
// for another j), as a tree of selects on j's bits: indexing the array
// would move it to local memory.
template <typename T>
__device__ __forceinline__ T sel10(const T v[kL], int j)
{
    const bool b0 = j & 1, b1 = j & 2, b2 = j & 4, b3 = j & 8;
    const T p01 = b0 ? v[1] : v[0], p23 = b0 ? v[3] : v[2];
    const T p45 = b0 ? v[5] : v[4], p67 = b0 ? v[7] : v[6];
    const T p89 = b0 ? v[9] : v[8];
    const T q03 = b1 ? p23 : p01, q47 = b1 ? p67 : p45;
    return b3 ? p89 : (b2 ? q47 : q03);
}

// The draw of stream s at step t is the argmax (torch.argmax's rules) of
// the ten values log(max(m_j, 1e-30)) + gumbel(u_j), where the elements
// outside `keep` are masked (m_j = 0).  It is taken in two parts.  The
// first reads nothing of the field, so it runs while the step's gathers
// are in flight: the three Philox blocks of words (a warp's lanes keep
// elements of every block between them).
__device__ __forceinline__ void draw_words(const uint32_t* rk, uint32_t s,
                                           uint32_t t, uint32_t w[12])
{
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
        uint32_t c[4] = {s, t, (uint32_t)blk, 0u};
        philox_rk(c, rk);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[4 * blk + i] = c[i];
    }
}

// The second, with the logits `l` of the kept elements at positions `pos`
// (ascending, -1 past the last; log(max(m_j, 1e-30)) as torch.log computes
// them, the plain loop's logits of those elements): the argmax over the
// live elements alone, the kept ones whose logit is above L0 =
// logf(1e-30f) or NaN, the lowest first.  Every other value is L0' (+) g_j
// with L0' <= L0 (a masked element's logit is L0, a kept one's at most
// L0), so at most `ceiling` = L0 (+) kGumbelMax ((+) the rounded sum,
// monotone in each term) and never NaN: when the best live value is NaN or
// above the ceiling, no other element takes the argmax from it
// (argmax_takes: a NaN keeps it, a number must exceed it).  Otherwise all
// ten values are computed and the full argmax taken.
__device__ __forceinline__ int draw_pick(const uint32_t w[12],
                                         const int pos[4], float4 l,
                                         float L0, float ceiling)
{
    const float lk[4] = {l.x, l.y, l.z, l.w};
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        live |= (unsigned)(pos[k] >= 0 && !(lk[k] <= L0)) << k;
    float best = 0.f;
    int ib = -1;
    for (unsigned rest = live; rest; rest &= rest - 1u) {
        const int k = __ffs(rest) - 1;
        const int j = pos[k];
        const float lj = k == 0 ? lk[0] : k == 1 ? lk[1] : k == 2 ? lk[2]
                                                                   : lk[3];
        const float v = __fadd_rn(lj, gumbel(word_uniform(sel10(w, j))));
        if (ib < 0 || argmax_takes(best, v)) {
            best = v;
            ib = j;
        }
    }
    if (ib >= 0 && (isnan(best) || best > ceiling))
        return ib;
    float val[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) {
        float lj = L0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (pos[k] == j) lj = lk[k];
        val[j] = __fadd_rn(lj, gumbel(word_uniform(w[j])));
    }
    return argmax10(val);
}

// The draw over all ten elements of the masked row m, for an edge that
// keeps more than four (not one of EDGETYPE's).
__device__ __forceinline__ int draw_full(const uint32_t w[12],
                                         const float m[kL], unsigned keep,
                                         float L0)
{
    float val[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j)
        val[j] = __fadd_rn(keep >> j & 1u ? log_clamped(m[j]) : L0,
                           gumbel(word_uniform(w[j])));
    return argmax10(val);
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

// A voxel's candidates: kNvec of them loaded at once into registers
// (8-byte pairs; the wrapper passes kNvec 2 only for an 8-byte aligned
// field), or with kNvec 0 the `nvec` where they lie, read as needed.
template <int kNvec>
struct Cands {
    const float* at;
    int nvec;
    float a[kNvec > 0 ? 3 * kNvec : 1];

    __device__ __forceinline__ Cands(const float* cand, int n)
        : at(cand), nvec(n)
    {
        if constexpr (kNvec > 0) {
            const float2* c2 = (const float2*)cand;
#pragma unroll
            for (int i = 0; i < 3 * kNvec / 2; ++i) {
                const float2 v = __ldg(c2 + i);
                a[2 * i] = v.x;
                a[2 * i + 1] = v.y;
            }
        }
    }

    // candidate k, k < nvec
    __device__ __forceinline__ void get(int k, float& x, float& y,
                                        float& z) const
    {
        if constexpr (kNvec > 0) {
            x = a[0];
            y = a[1];
            z = a[2];
#pragma unroll
            for (int i = 1; i < kNvec; ++i)
                if (k == i) {
                    x = a[3 * i];
                    y = a[3 * i + 1];
                    z = a[3 * i + 2];
                }
        } else {
            x = __ldg(at + 3 * k);
            y = __ldg(at + 3 * k + 1);
            z = __ldg(at + 3 * k + 2);
        }
    }

    // `pick` over these candidates
    __device__ __forceinline__ int best(float dx, float dy, float dz,
                                        float& c_best, float& bx, float& by,
                                        float& bz) const
    {
        if constexpr (kNvec == 0) {
            return pick(at, nvec, dx, dy, dz, c_best, bx, by, bz);
        } else {
            float best_abs = 0.f;
            int ib = 0;
            c_best = 0.f;
            bx = by = bz = 0.f;
#pragma unroll
            for (int k = 0; k < kNvec; ++k) {
                const float x = a[3 * k], y = a[3 * k + 1], z = a[3 * k + 2];
                const bool zero = x == 0.f && y == 0.f && z == 0.f;
                const float c = zero ? -INFINITY : dot3(x, y, z, dx, dy, dz);
                const float ca = zero ? -INFINITY : fabsf(c);
                if (k == 0 || argmax_takes(best_abs, ca)) {
                    best_abs = ca;
                    ib = k;
                    c_best = c;
                    bx = x;
                    by = y;
                    bz = z;
                }
            }
            return ib;
        }
    }
};

// Stream s took `took` steps and stopped (or ran out of steps) on this
// lane (`fin`): after its rows, its count.  The warp then writes the
// frozen tails of each group of 32 consecutive streams whose last stream
// one of its lanes stopped: the last point (or a zero delta), saved =
// false and flag 0 from each stream's stop on, a lane a stream, a row at
// a time.  Called by the whole warp.
template <bool kDeltas>
__device__ __forceinline__ void finish(const LcmParams& p, bool fin, int s)
{
    const int lane = threadIdx.x & 31;
    bool last = false;
    if (fin) {
        __threadfence();        // the stream's rows and stop before the count
        const int g0 = s & ~31;
        last = atomicAdd(p.done + (s >> 5), 1) == min(32, p.S - g0) - 1;
    }
    for (unsigned groups = __ballot_sync(kFull, last); groups;
         groups &= groups - 1) {
        const int g0 = __shfl_sync(kFull, s, __ffs(groups) - 1) & ~31;
        __threadfence();        // the group's rows after its count
        const int sl = g0 + lane;
        const bool mine = sl < p.S;
        const int from = mine ? __ldcg(p.stop + sl) : p.nsteps;
        float fx = 0.f, fy = 0.f, fz = 0.f;
        if (!kDeltas && mine && from < p.nsteps) {
            const float* q = (const float*)p.out
                + 3 * ((size_t)(from - 1) * p.S + sl);
            fx = __ldcg(q);
            fy = __ldcg(q + 1);
            fz = __ldcg(q + 2);
        }
        int u = from;
        for (int off = 16; off > 0; off >>= 1)
            u = min(u, __shfl_xor_sync(kFull, u, off));
        for (; u < p.nsteps; ++u) {
            if (u < from)
                continue;
            const size_t o = (size_t)u * p.S + sl;
            prop::store3<kDeltas>(p.out, o, fx, fy, fz);
            p.saved[o] = 0;
            p.flags[o] = 0;
        }
    }
}

// The elements of an LCM row whose pair holds edge e (bits), and the
// first four of them, lowest first (-1 past the last).
__device__ __forceinline__ unsigned kept_by(const int se[2][kL], int e)
{
    unsigned k = 0;
    for (int j = 0; j < kL; ++j)
        k |= (unsigned)(se[0][j] == e || se[1][j] == e) << j;
    return k;
}

__device__ __forceinline__ void kept_positions(unsigned keep, int pos[4])
{
    for (int k = 0; k < 4; ++k) {
        pos[k] = keep ? __ffs(keep) - 1 : -1;
        keep &= keep - 1u;
    }
}

// Per voxel and entry edge e, what an LCM step entering the voxel through
// e reads, in one 32-byte sector: the logits log(max(m_j, 1e-30)) of the
// first four elements e keeps (logf, which is torch.log on the card:
// lcm_selfcheck), then the sum of the row masked to the elements e keeps
// (sum10, torch's order).  A thread a (voxel, edge).
__global__ void lcm_table_kernel(const float* lcms, const long long* edget,
                                 float* table, long long n)
{
    __shared__ int se[2][kL];
    if (threadIdx.x < 2 * kL)
        se[threadIdx.x / kL][threadIdx.x % kL] = (int)edget[threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 4 * n)
        return;
    const float* row = lcms + (i >> 2) * kL;
    const unsigned keep = kept_by(se, (int)(i & 3));
    int pos[4];
    kept_positions(keep, pos);
    float m[kL], l[4];
#pragma unroll
    for (int j = 0; j < kL; ++j)
        m[j] = keep >> j & 1u ? row[j] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        l[k] = pos[k] >= 0 ? log_clamped(row[pos[k]]) : 0.f;
    float4* out = (float4*)(table + 8 * i);
    out[0] = make_float4(l[0], l[1], l[2], l[3]);
    out[1] = make_float4(sum10(m), 0.f, 0.f, 0.f);
}

// A stream's state between steps, as the block's compaction moves it.
struct Stream {
    float px, py, pz, vx, vy, vz, qx, qy, qz;
    int s, t, n, ivec_prev;
};

// Step st.t of stream st.s; true when the stream stopped (or ran out of
// steps), its count and anchor then written.
template <typename Idx, bool kDeltas, int kNvec>
__device__ __forceinline__ bool step(const LcmParams& p, Stream& st,
                                     const int sd[3][4], const int se[2][kL],
                                     const unsigned keeps[4],
                                     const int kpos[4][4], float L0,
                                     float ceiling)
{
    const float pos[3] = {st.px, st.py, st.pz};
    const float nxt[3] = {__fadd_rn(st.px, __fmul_rn(st.vx, p.step)),
                          __fadd_rn(st.py, __fmul_rn(st.vy, p.step)),
                          __fadd_rn(st.pz, __fmul_rn(st.vz, p.step))};
    Idx inext[3];
    for (int d = 0; d < 3; ++d) inext[d] = voxel<Idx>(nxt[d]);
    bool inb;
    const Idx flat = prop::flat_index(inext[0], inext[1], inext[2], p.nx,
                                      p.ny, p.nz, inb);
    bool save = false;
    int ivec_next = st.ivec_prev, ivec_ang = 0;
    float wx = 0.f, wy = 0.f, wz = 0.f;          // vnext
    if (inb) {
        // in the volume, so the differences fit an Idx
        Idx dv[3];
        for (int d = 0; d < 3; ++d) dv[d] = voxel<Idx>(pos[d]) - inext[d];
        const bool same_vox = dv[0] == 0 && dv[1] == 0 && dv[2] == 0;
        // a diagonal jump keeps only its slower-changing in-plane dim
        // (src/stream.jl:422-437)
        const float da = fabsf(__fsub_rn(at3(pos, p.a), at3(nxt, p.a)));
        const float db = fabsf(__fsub_rn(at3(pos, p.b), at3(nxt, p.b)));
        if (at3(dv, p.a) != 0 && at3(dv, p.b) != 0) {
            const int zeroed = da < db ? p.b : p.a;
#pragma unroll
            for (int d = 0; d < 3; ++d)
                if (d == zeroed) dv[d] = 0;
        }
        int entry = 0;
        bool matched = false;
        for (int e = 3; e >= 0; --e)
            if (dv[0] == sd[0][e] && dv[1] == sd[1][e] && dv[2] == sd[2][e]) {
                entry = e;
                matched = true;
            }
        // entering a new voxel through an edge: the LCM row masked to the
        // pairs holding the entry edge (else nothing is saved there)
        const bool lcm_step = !same_vox && matched;
        // the step's gathers, issued together: what the entry edge needs of
        // the voxel's LCM row (its kept elements' logits and masked sum, one
        // 32-byte sector), the mask and the candidates
        const unsigned keep = lcm_step ? keeps[entry] : 0u;
        const bool wide = __popc(keep) > 4;
        const float* te = p.table + ((size_t)flat * 4 + entry) * 8;
        float4 tl = make_float4(0.f, 0.f, 0.f, 0.f);
        float tsum = 0.f;
        if (lcm_step) {
            tl = __ldg((const float4*)te);
            tsum = __ldg(te + 4);
        }
        const bool inmask = p.mask[flat] != 0;
        const Cands<kNvec> cands(p.ovecs + (size_t)flat * (3 * p.nvec),
                                 p.nvec);
        uint32_t w[12];
        if (lcm_step)
            draw_words(p.rk, (uint32_t)st.s, (uint32_t)st.t, w);
        // the conventional angle pick, for the flag and its ok
        float c_ang, ax, ay, az;
        const int ia = cands.best(st.vx, st.vy, st.vz, c_ang, ax, ay, az);
        if (inmask) {
            ivec_ang = ia;
            if (!isfinite(c_ang)) {
                // not saved, whatever the branch
            } else if (same_vox) {
                // continue along the previous index
                float px_, py_, pz_;
                cands.get(st.ivec_prev, px_, py_, pz_);
                const bool pos_side =
                    dot3(st.vx, st.vy, st.vz, px_, py_, pz_) > 0.f;
                wx = pos_side ? px_ : -px_;
                wy = pos_side ? py_ : -py_;
                wz = pos_side ? pz_ : -pz_;
                save = true;
            } else if (lcm_step) {
                float m[kL];
                if (wide) {
#pragma unroll
                    for (int j = 0; j < kL; ++j)
                        m[j] = keep >> j & 1u
                            ? __ldg(p.lcms + (size_t)flat * kL + j) : 0.f;
                    tsum = sum10(m);
                }
                // nothing is saved where the masked row sums to 0; else the
                // draw of the exit edge, then the candidate best aligned
                // with the jump to it
                if (tsum > 0.f) {
                    const int ilcm = wide ? draw_full(w, m, keep, L0)
                                          : draw_pick(w, kpos[entry], tl, L0,
                                                      ceiling);
                    const int e0 = se[0][ilcm], e1 = se[1][ilcm];
                    const int exit_edge = e0 == entry ? e1 : e0;
                    float c_new, bx, by, bz;
                    ivec_next = cands.best((float)sd[0][exit_edge],
                                           (float)sd[1][exit_edge],
                                           (float)sd[2][exit_edge], c_new,
                                           bx, by, bz);
                    const bool pos_side = c_new > 0.f;
                    wx = pos_side ? bx : -bx;
                    wy = pos_side ? by : -by;
                    wz = pos_side ? bz : -bz;
                    save = isfinite(c_new);
                }
            }
        }
    }
    st.n += save;
    const size_t o = (size_t)st.t * p.S + st.s;
    float ox, oy, oz;
    prop::point_out<kDeltas>(save, st.px, st.py, st.pz, st.qx, st.qy, st.qz,
                             p.qscale, p.qstep, p.dmax, ox, oy, oz);
    prop::store3<kDeltas>(p.out, o, ox, oy, oz);
    p.saved[o] = save;
    p.flags[o] = save && ivec_next != ivec_ang;
    ++st.t;

    // no angle threshold in LCM mode (src/stream.jl:668-671)
    bool fin = true;
    if (save && st.n <= p.len_max) {
        st.px = nxt[0];
        st.py = nxt[1];
        st.pz = nxt[2];
        prop::smooth_dir(st.vx, st.vy, st.vz, wx, wy, wz, p.sc, p.sc1,
                         p.smooth);
        st.ivec_prev = ivec_next;
        fin = st.t == p.nsteps;
    }
    if (fin) {
        p.npts[st.s] = st.n;
        p.pos_q[3 * st.s] = st.qx;
        p.pos_q[3 * st.s + 1] = st.qy;
        p.pos_q[3 * st.s + 2] = st.qz;
        p.stop[st.s] = st.t;
    }
    return fin;
}

template <typename Idx, bool kDeltas, int kNvec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lcm_kernel(const LcmParams p)
{
    __shared__ int sd[3][4], se[2][kL];
    __shared__ unsigned keeps[4];           // the elements each edge keeps
    __shared__ int kpos[4][4];              // the first four, -1 past them
    __shared__ Stream pool[kThreads];
    __shared__ int running[kWarps], base;
    if (threadIdx.x < 12) sd[threadIdx.x / 4][threadIdx.x % 4] =
        (int)p.dxyz[threadIdx.x];
    else if (threadIdx.x < 12 + 2 * kL) {
        const int i = threadIdx.x - 12;
        se[i / kL][i % kL] = (int)p.edget[i];
    }
    __syncthreads();
    if (threadIdx.x < 4) {
        const unsigned k = kept_by(se, (int)threadIdx.x);
        keeps[threadIdx.x] = k;
        kept_positions(k, kpos[threadIdx.x]);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float L0 = logf(1e-30f);          // log_clamped of a masked element
    const float ceiling = __fadd_rn(L0, kGumbelMax);

    Stream st;
    st.s = -1;
    bool drained = false;                   // the same in every thread
    for (;;) {
        // every kCompact steps the block moves its running streams to its
        // first threads, and its other threads take the next streams from
        // the counter
        const bool run = st.s >= 0;
        const unsigned b = __ballot_sync(kFull, run);
        if (lane == 0)
            running[warp] = __popc(b);
        __syncthreads();                    // also: the last round's reads
        int before = 0, total = 0;
        for (int w = 0; w < kWarps; ++w) {
            before += w < warp ? running[w] : 0;
            total += running[w];
        }
        if (run)
            pool[before + __popc(b & ((1u << lane) - 1u))] = st;
        if (threadIdx.x == 0)
            base = drained ? p.S : atomicAdd(p.next, kThreads - total);
        __syncthreads();
        const int fresh = max(0, min(kThreads - total, p.S - base));
        drained = fresh < kThreads - total;
        if (total + fresh == 0)
            break;
        const int i = threadIdx.x;
        if (i < total) {
            st = pool[i];
        } else if (i < total + fresh) {
            const int s = base + i - total;
            st.s = s;
            st.px = st.qx = p.pos0[3 * s];
            st.py = st.qy = p.pos0[3 * s + 1];
            st.pz = st.qz = p.pos0[3 * s + 2];
            st.vx = p.vec0[3 * s];
            st.vy = p.vec0[3 * s + 1];
            st.vz = p.vec0[3 * s + 2];
            st.n = p.npts0[s];
            st.t = 0;
            st.ivec_prev = 0;
        } else {
            st.s = -1;
        }
        for (int k = 0; k < kCompact; ++k) {
            const bool fin =
                st.s >= 0
                && step<Idx, kDeltas, kNvec>(p, st, sd, se, keeps, kpos, L0,
                                             ceiling);
            finish<kDeltas>(p, fin, st.s);
            if (fin)
                st.s = -1;
        }
    }
}

template <typename Idx, bool kDeltas, int kNvec>
cudaError_t launch(const LcmParams& p, cudaStream_t st)
{
    const auto kernel = lcm_kernel<Idx, kDeltas, kNvec>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, 0);
    if (!err && per_sm < 1)
        err = cudaErrorInvalidConfiguration;
    if (!err)                   // the stream counter and the group counts
        err = cudaMemsetAsync(p.next, 0,
                              sizeof(int) * (1 + (p.S + 31) / 32), st);
    if (err)
        return err;
    // the resident capacity, fewer when the streams do not fill it
    const int blocks = std::min(per_sm * sms,
                                (p.S + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, 0, st>>>(p);
    return cudaGetLastError();
}

// The self-check's functions of the kernel, one per mode, for element i:
// 0 logf(x[i]); 1 the Gumbel transform of the uniform of word i << 8;
// 2 sum10 of row i of x [n, 10]; 3 argmax10 of that row (int32 out);
// 4 the ten uniforms of stream i at step t under (k0, k1) (out [n, 10]);
// 5 the draw of stream i at step t of row i of x [n, 21]: the LCM row
// x[i, :10] masked to the elements whose bit is set in the integer x[i,
// 10], with the row's logits x[i, 11:] (int32 out).
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
        uint32_t rk[20];
        round_keys(k0, k1, rk);
        if (mode == 4) {
            float u[kL];
            lcm_uniforms(rk, (uint32_t)i, (uint32_t)t, u);
            for (int j = 0; j < kL; ++j) f[kL * i + j] = u[j];
        } else {
            // row i of x [n, 21]: the LCM row, the mask's bits, the logits
            const float* row = x + (2 * kL + 1) * i;
            const unsigned keep = (unsigned)row[kL];
            const float L0 = logf(1e-30f);
            uint32_t w[12];
            draw_words(rk, (uint32_t)i, (uint32_t)t, w);
            if (__popc(keep) > 4) {
                float m[kL];
                for (int j = 0; j < kL; ++j)
                    m[j] = keep >> j & 1u ? row[j] : 0.f;
                ((int*)out)[i] = draw_full(w, m, keep, L0);
            } else {
                int pos[4];
                kept_positions(keep, pos);
                float l[4];
                for (int k = 0; k < 4; ++k)
                    l[k] = pos[k] >= 0 ? row[kL + 1 + pos[k]] : 0.f;
                ((int*)out)[i] = draw_pick(w, pos,
                                           make_float4(l[0], l[1], l[2], l[3]),
                                           L0, __fadd_rn(L0, kGumbelMax));
            }
        }
    }
}

}  // namespace

extern "C" {

// Launch one direction on `stream` (a cudaStream_t): a memset of the
// counters at the head of `scratch` (1 + ceil(S / 32) + S ints of device
// memory: the stream counter, the groups' counts, the streams' steps),
// `lcm_table_kernel` into `table` (nx * ny * nz * 32 floats of device
// memory, 16-byte aligned) and the kernel.  Returns a cudaError_t, 0 when
// all were accepted.  Does not synchronise.  S >= 1, nsteps >= 1; mask,
// ovecs and lcms over nx * ny * nz voxels; (a, b) the two in-plane dims;
// index_bits 32 (fewer than 2^31 voxels, each dimension below 2^29) or 64.
int propagate_lcm_launch(const float* pos0, const float* vec0,
                         const int* npts0, const void* mask,
                         const float* ovecs, const float* lcms,
                         float* table, const long long* dxyz,
                         const long long* edget, int S,
                         int nsteps, int nvec, int nx, int ny, int nz, int a,
                         int b, unsigned k0, unsigned k1, float step,
                         float sc, float sc1, int smooth, int len_max,
                         int deltas, float qscale, float qstep, float dmax,
                         void* out, void* saved, void* flags, int* npts,
                         float* pos_q, int* scratch, int index_bits,
                         void* stream)
{
    int* next = scratch;
    int* done = scratch + 1;
    int* stop = done + (S + 31) / 32;
    LcmParams p{pos0, vec0, npts0, (const uint8_t*)mask, ovecs, lcms, table,
                dxyz, edget, S, nsteps, nvec, nx, ny, nz, a, b, {},
                step, sc, sc1, smooth, len_max, qscale, qstep, dmax, out,
                (uint8_t*)saved, (int8_t*)flags, npts, pos_q, next, done,
                stop};
    round_keys(k0, k1, p.rk);
    const cudaStream_t st = (cudaStream_t)stream;
    const long long nvox = (long long)nx * ny * nz;
    lcm_table_kernel<<<(unsigned)((4 * nvox + 255) / 256), 256, 0, st>>>(
        lcms, edget, table, nvox);
    if (const cudaError_t err = cudaGetLastError())
        return (int)err;
    // two candidates in registers for a field of two, 8-byte aligned
    const bool two = nvec == 2 && (uintptr_t)ovecs % 8 == 0;
    if (index_bits == 32 && two)
        return (int)(deltas ? launch<int, true, 2>(p, st)
                            : launch<int, false, 2>(p, st));
    if (index_bits == 32)
        return (int)(deltas ? launch<int, true, 0>(p, st)
                            : launch<int, false, 0>(p, st));
    if (index_bits == 64)
        return (int)(deltas ? launch<long long, true, 0>(p, st)
                            : launch<long long, false, 0>(p, st));
    return (int)cudaErrorInvalidValue;
}

// Threads an SM holds of the 32-bit kernel for two candidates, points or
// deltas (the occupancy API); -1 on an error.
int propagate_lcm_resident_threads(int deltas)
{
    int n = 0;
    const cudaError_t err = deltas
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, lcm_kernel<int, true, 2>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, lcm_kernel<int, false, 2>, kThreads, 0);
    return err ? -1 : n * kThreads;
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
