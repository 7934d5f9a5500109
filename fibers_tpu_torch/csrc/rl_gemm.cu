// RUMBA-SD's Richardson-Lucy products on Hopper's bf16 tensor cores
// (sm_90a): C[M, N] f32 = A[M, K] f32 @ B[K, N] f32 in the reference's
// matrix-unit arithmetic.
//
// Replaces the three products of the reference's iteration program,
// fibers_tpu/models/rumba.py:343 _rumba_step_core (XLA): rl_num =
// (signal * iratio) @ kernel and rl_den = dodf @ kernel (:360-361), and
// dodf = fodf @ kernel.T (:379), which it runs as jnp.dot(...,
// precision=hp) on the matrix unit (:46-55):
//   passes = 3 (precision "high", the default): each operand splits as
//     x = hi + lo, hi = bf16_rn(x), lo = bf16_rn(x - hi), and each k16
//     step runs three wgmma products, lo_a*hi_b, hi_a*lo_b, hi_a*hi_b
//     (small terms first), into a chunk accumulator that starts from zero
//     (scale-d = 0 at the step's first product); the chunk is then added
//     to the f32 accumulator with an ordinary FADD, so the tensor core's
//     own accumulation rounds over a step's 3 products only and the long
//     sum over K rounds to nearest.  The dropped lo_a*lo_b term and lo's own rounding are
//     ~2^-17 of each product;
//   passes = 1 (precision "default"): hi_a*hi_b only, the product of
//     bf16-rounded operands with f32 accumulation, promoted alike.
// The wrapper's plain version sums in chunks of the same depth, a k16
// step (ops/kernels/rl_gemm.py: STEP).  A row of A holding
// a NaN gives NaN in every column of its C row, as the f32 product does
// (bf16_rn keeps a NaN).  An infinite element of A gives NaN there (its
// lo is inf - inf), where the f32 product gives inf.
//
// What bounds it on an H100: bytes.  At RUMBA config 4 (M = 715,200 rows,
// K x N = 253 x 364 and 364 x 253) an iteration's three products read
// 2.77 GB of A and write 2.53 GB of C: 5.295 GB, 1.581 ms at 3.35 TB/s;
// their 3 x 395 GFLOP take 1.199 ms at bf16's dense 989 TFLOP/s.  So the
// design keeps the bytes streaming while the tensor cores work:
//   - a persistent grid, one block an SM, walks 64-row tiles (of both
//     operands of a two-operand launch: num and den against one B), so a
//     tile's loads and products overlap the last tile's C store;
//   - two consumer warpgroups, each the 64 rows by half of the column
//     block (184 columns at N = 364, 128 at N = 253) as one
//     wgmma.m64nNk16 a product with A from registers: a consumer reads its
//     A fragment as f32 from shared memory and splits it into bf16 hi and
//     lo in registers (no separate pass); B's planes come from shared
//     memory.  With 2 x 92 accumulators a thread at N = 364 they take the
//     registers the producer warpgroup gives up (setmaxnreg);
//   - two rings of stages in shared memory, a k16 step a stage, with full
//     and empty mbarriers: A's, deep (device memory's latency), filled by
//     two producer warps with cp.async of the 16-byte granules that hold
//     each row's 16 floats (a 253-float row is not 16-byte aligned, so it
//     lands shifted by its address mod 16 and the consumer reads it
//     there), and B's, filled by one producer thread with one bulk copy a
//     plane (rl_pack_kernel, once a matrix: each k16 step of a column
//     block is one contiguous run in wgmma's no-swizzle K-major layout);
//   - C leaves through shared memory: the consumers write the tile there
//     and one thread sends its rows, contiguous when one column block
//     covers N, by one bulk store that runs on while the next tile's
//     steps go; else the threads store it.
// Row indices are 64-bit.  Accuracy at config 4, "high", from the float64
// product of the parts over sum|a||b|, on the fit's own operands (num,
// den, dodf): 4.5e-7, 5.88e-7, 5.96e-7 with an FADD every k16 step, as
// mma.sync gave; 7.46e-7, 1.01e-6, 4.88e-7 with one every two steps (on
// uniform operands the whole K in the tensor core reads 1.97e-6).
// What it reaches, and builds without its parts (probe_paths.py --paths
// rlgemm), are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;                   // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;         // two consumer warpgroups
constexpr int THREADS = CONSUMERS + WG;   // and the producers'
constexpr int BM = 64;                    // rows of a tile: wgmma's M
constexpr int SA = 20;                    // floats of a row's slot in A
constexpr int A_STAGE = BM * SA * 4;      // bytes of a stage's A rows
constexpr int MAX_STAGES = 16;            // of A's ring
// B's ring holds up to B_STAGES while A's keeps A_STAGES (the best of
// 3 / 12 and 4 / 8 at config 4)
constexpr int B_STAGES = 4, A_STAGES = 8;
constexpr int SMEM_MAX = 232448;          // a block's shared memory
constexpr int WIDE = 184;                 // a consumer's widest columns
// registers a thread: the consumers take what the producers give up
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// the columns of a consumer warpgroup (its wgmma's N) for an N: the least
// of 32, 64, 128 and WIDE whose pair covers N; past 2 WIDE, column blocks
// of 2 WIDE
int wg_cols(int n)
{
    return n <= 64 ? 32 : n <= 128 ? 64 : n <= 256 ? 128 : WIDE;
}

int col_blocks(int n)
{
    const int w = 2 * wg_cols(n);
    return (n + w - 1) / w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// the bf16 halves of a packed pair as floats (exact)
__device__ __forceinline__ float low_f(uint32_t w)
{
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float high_f(uint32_t w)
{
    return __uint_as_float(w & 0xffff0000u);
}

// a pair of f32 (lower column first) split into packed hi and lo halves
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo)
{
    hi = pack_bf16(x, y);
    lo = pack_bf16(x - low_f(hi), y - high_f(hi));  // exact differences
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// wait until the phase of parity `parity` has completed; a barrier still
// open after 10 s (a fault: the pipeline's waits are memory latencies)
// traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    if (mbar_try(bar, parity)) return;
    uint64_t t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    while (!mbar_try(bar, parity)) {
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        if (t - t0 > 10000000000ull) __trap();
    }
}

// ---- bulk copies -----------------------------------------------------

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 16 bytes global -> shared; the barrier's arrival for them by
// cp_async_arrive
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst), "l"(src) : "memory");
}

// one of the barrier's expected arrivals, once this thread's cp.async
// copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes)
{
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                 "%2;" :: "l"(dst), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the last bulk store has read its shared memory
__device__ __forceinline__ void bulk_store_read()
{
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_store_done()
{
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// the consumers' writes to shared memory, before a bulk store reads them
__device__ __forceinline__ void fence_to_async()
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync()
{
    asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
}

// ---- wgmma -----------------------------------------------------------

// B's planes in shared memory: wgmma's no-swizzle K-major layout, core
// matrices of 8 columns x 8 k (16 bytes a column), the step's two k
// halves 128 bytes apart (LBO), n8 tiles 256 bytes apart (SBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr)
{
    return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)(128 >> 4) << 16)
        | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all()
{
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// the registers wgmma wrote are read only after the wait
template <int NA>
__device__ __forceinline__ void fence_regs(float (&d)[NA])
{
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A B for a warpgroup: A [64 x 16] bf16 in registers (the mma
// fragment of each warp's 16 rows), B [16 x NW] from shared memory
// (`desc`); d [NW / 2] f32 a thread; `accumulate` 0 starts from zero
template <int NW> struct Wgmma;

template <> struct Wgmma<32> {
    static __device__ __forceinline__ void run(
        float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
        uint32_t accumulate)
    {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
            "%10, %11, %12, %13, %14, %15"
            "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(accumulate));
    }
};

template <> struct Wgmma<64> {
    static __device__ __forceinline__ void run(
        float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
        uint32_t accumulate)
    {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
            "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
            "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(accumulate));
    }
};

template <> struct Wgmma<128> {
    static __device__ __forceinline__ void run(
        float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
        uint32_t accumulate)
    {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
            "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
            "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
            "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
            "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
            "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
            "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(accumulate));
    }
};

template <> struct Wgmma<184> {
    static __device__ __forceinline__ void run(
        float (&d)[92], const uint32_t (&a)[4], uint64_t desc,
        uint32_t accumulate)
    {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %97, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
            "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
            "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
            "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
            "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
            "%90, %91"
            "}, {%92, %93, %94, %95}, %96, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
            "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
            "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
            "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
            "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
            "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
            "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
            "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
            "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
            "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
            "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(accumulate));
    }
};

// b [k, n] f32 row-major into its packed planes: for column block cb,
// k16 step s, n8 tile j, k half h and column c of the tile, 16 bytes of
// the 8 values B[16 s + 8 h + e][col], e = 0..7, as bf16, col = 2 nw cb
// + 8 j + c (nw = wg_cols(n)); a 16-byte unit at ((((cb nks + s) (2 nw /
// 8) + j) 2 + h) 8 + c) 16 bytes, hi from bf16_rn(B), lo from bf16_rn(B -
// hi); zero past k and n.  Each (cb, s) is one contiguous run of 64 nw
// bytes: a stage's bulk copy, in the layout b_desc describes.
__global__ void rl_pack_kernel(const float* __restrict__ b,
                               uint4* __restrict__ hi, uint4* __restrict__ lo,
                               int k, int n, int nks, int cbw,
                               long long units)
{
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < units; u += stride) {
        const int c = (int)(u & 7);
        const int h = (int)((u >> 3) & 1);
        const long long q = u >> 4;
        const int j = (int)(q % (cbw / 8));
        const long long r = q / (cbw / 8);
        const int s = (int)(r % nks);
        const int cb = (int)(r / nks);
        const int col = cbw * cb + 8 * j + c;
        const int k0 = 16 * s + 8 * h;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
            v[e] = (col < n && k0 + e < k) ? b[(long long)(k0 + e) * n + col]
                                           : 0.f;
        uint32_t wh[4], wl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            split2(v[2 * e], v[2 * e + 1], wh[e], wl[e]);
        hi[u] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
        lo[u] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
    }
}

struct Params {
    const float* a0;
    const float* a1;
    const unsigned char* bhi;     // planes, rl_pack_kernel's layout
    const unsigned char* blo;
    float* c0;
    float* c1;
    long long m;                  // rows of each operand
    long long mtiles;             // its 64-row tiles
    long long ntiles;             // operands x mtiles x column blocks
    int k, n, nks, nops;
    int nsa, nsb;                 // A stages, B stages
};

struct Tile {
    const float* a;
    float* c;
    long long row0;
    int rows;
    int cb;
};

// tile t: column block, then operand, then 64-row tile
__device__ __forceinline__ Tile tile_at(const Params& p, long long t)
{
    Tile x;
    const long long span = p.nops * p.mtiles;
    x.cb = (int)(t / span);
    const long long r = t - x.cb * span;
    const int op = (int)(r / p.mtiles);
    x.a = op ? p.a1 : p.a0;
    x.c = op ? p.c1 : p.c0;
    x.row0 = (r - op * p.mtiles) * BM;
    x.rows = (int)min((long long)BM, p.m - x.row0);
    return x;
}

// An A producer warp (`half` 0 or 1): for each tile of this block and
// each k16 step, wait for its A stage to be free, then copy into it, by
// cp.async, its half of the 16-byte granules that hold the step's 16
// floats of the tile's rows: a lane a granule, five a row, consecutive
// lanes along a row.
template <int NW>
__device__ __forceinline__ void produce_a(const Params& p, unsigned char* sA,
                                          uint32_t fullA0, uint32_t emptyA0,
                                          int half)
{
    constexpr int NG = BM * 5 / 64;           // granules a lane
    // this warp's first granule
    const int g0 = (threadIdx.x & 31) + 32 * NG * half;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = blockIdx.x; i < p.ntiles; i += gridDim.x) {
        const Tile t = tile_at(p, i);
        // granule g = g0 + 32 i: row g / 5, the row's granule g % 5 from
        // the one that holds its first float, at `off` bytes from the
        // tile's first granule; each step moves it 64 bytes on
        const uintptr_t base = reinterpret_cast<uintptr_t>(
            t.a + t.row0 * p.k) & ~(uintptr_t)15;
        uint32_t off[NG];
        int lim[NG];                          // it holds floats while > 0
#pragma unroll
        for (int i = 0; i < NG; ++i) {
            const int g = g0 + 32 * i, r = g / 5, q = g - 5 * r;
            const uintptr_t b0 = reinterpret_cast<uintptr_t>(
                t.a + (t.row0 + r) * p.k);
            off[i] = (uint32_t)((b0 & ~(uintptr_t)15) - base) + 16 * q;
            // granule q holds some of the row's floats [kc, kc + kn) when
            // 16 q < (b0 mod 16) + 4 kn; none past the tile's rows
            lim[i] = r < t.rows ? (int)(b0 & 15) - 16 * q : -4096;
        }
        const char* src = reinterpret_cast<const char*>(base);
        for (int s = 0; s < p.nks; ++s) {
            mbar_wait(emptyA0 + 8 * stage, phase ^ 1);
            const int kn4 = 4 * min(16, p.k - 16 * s);
            const uint32_t dA = smem_u32(sA + stage * A_STAGE);
#pragma unroll
            for (int i = 0; i < NG; ++i) {
                const int g = g0 + 32 * i, r = g / 5, q = g - 5 * r;
                if (lim[i] + kn4 > 0)
                    cp_async16(dA + r * SA * 4 + 16 * q, src + off[i]);
            }
            src += 64;
            cp_async_arrive(fullA0 + 8 * stage);
            if (++stage == p.nsa) {
                stage = 0;
                phase ^= 1;
            }
        }
    }
}

// The B producer (one thread): for each tile and k16 step, wait for the B
// stage to be free, then copy the step's hi and lo planes into it.
template <int PASSES, int NW>
__device__ __forceinline__ void produce_b(const Params& p, unsigned char* sB,
                                          uint32_t fullB0, uint32_t emptyB0)
{
    constexpr int PLANE = 64 * NW;            // bytes a plane a step
    constexpr int PLANES = PASSES > 1 ? 2 : 1;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = blockIdx.x; i < p.ntiles; i += gridDim.x) {
        const Tile t = tile_at(p, i);
        long long off = (long long)t.cb * p.nks * PLANE;
        for (int s = 0; s < p.nks; ++s, off += PLANE) {
            mbar_wait(emptyB0 + 8 * stage, phase ^ 1);
            const uint32_t full = fullB0 + 8 * stage;
            mbar_expect(full, PLANES * PLANE);
            const uint32_t dB = smem_u32(sB + stage * PLANES * PLANE);
            bulk_load(dB, p.bhi + off, PLANE, full);
            if (PASSES > 1) bulk_load(dB + PLANE, p.blo + off, PLANE, full);
            if (++stage == p.nsb) {
                stage = 0;
                phase ^= 1;
            }
        }
    }
}

// A consumer warpgroup `w`: the tile's 64 rows by columns [w NW, w NW +
// NW) of the column block, then its part of the epilogue.
template <int PASSES, int NW>
__device__ __forceinline__ void consume(const Params& p, float* sC,
                                        unsigned char* sA, unsigned char* sB,
                                        uint32_t bars, int w)
{
    constexpr int NA = NW / 2;                    // accumulators a thread
    constexpr int PLANE = 64 * NW;
    constexpr int PLANES = PASSES > 1 ? 2 : 1;
    const int ctid = threadIdx.x;                 // 0..255
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g;   // rows r0, r0 + 8
    const uint32_t fullA0 = bars, emptyA0 = fullA0 + 8 * p.nsa;
    const uint32_t fullB0 = emptyA0 + 8 * p.nsa;
    const uint32_t emptyB0 = fullB0 + 8 * p.nsb;
    float acc[NA], chunk[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) chunk[i] = 0.f;
    int sa = 0, sb = 0;
    uint32_t pa = 0, pb = 0;
    for (long long i = blockIdx.x; i < p.ntiles; i += gridDim.x) {
        const Tile t = tile_at(p, i);
        // where each of the thread's rows starts in its slot: the row's
        // address mod 16, in floats (the same at every step)
        const int sh0 = (int)((reinterpret_cast<uintptr_t>(
            t.a + (t.row0 + r0) * p.k) >> 2) & 3);
        const int sh1 = (int)((reinterpret_cast<uintptr_t>(
            t.a + (t.row0 + r0 + 8) * p.k) >> 2) & 3);
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll 1
        for (int s = 0; s < p.nks; ++s) {
            mbar_wait(fullA0 + 8 * sa, pa);
            const float* As =
                reinterpret_cast<const float*>(sA + sa * A_STAGE);
            const float* q0 = As + r0 * SA + sh0 + 2 * tq;
            const float* q1 = As + (r0 + 8) * SA + sh1 + 2 * tq;
            // the mma fragment: rows r0, r0 + 8 of k 2tq, 2tq + 1 and
            // 2tq + 8, 2tq + 9
            float v[8] = {q0[0], q0[1], q1[0], q1[1],
                          q0[8], q0[9], q1[8], q1[9]};
            const int kl = p.k - 16 * s;
            if (kl < 16) {
                // past K the slot holds the next row's floats or older
                // ones: zeros there (B's planes are zero there too)
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    if (2 * tq + (e & 1) + 8 * (e >> 2) >= kl) v[e] = 0.f;
            }
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (PASSES > 1)
                    split2(v[2 * e], v[2 * e + 1], ahi[e], alo[e]);
                else
                    ahi[e] = pack_bf16(v[2 * e], v[2 * e + 1]);
            }
            const uint32_t bh = smem_u32(sB + sb * PLANES * PLANE)
                + w * NW * 32;
            // each step's chunk starts from zero: scale-d 0
            const uint32_t more = 0;
            mbar_wait(fullB0 + 8 * sb, pb);
            wg_fence();
            if (PASSES > 1) {
                Wgmma<NW>::run(chunk, alo, b_desc(bh), more);
                Wgmma<NW>::run(chunk, ahi, b_desc(bh + PLANE), 1);
                Wgmma<NW>::run(chunk, ahi, b_desc(bh), 1);
            } else {
                Wgmma<NW>::run(chunk, ahi, b_desc(bh), more);
            }
            wg_commit();
            wg_wait_all();
            fence_regs(chunk);
            // the stages are read: free them
            if (lane == 0) {
                mbar_arrive(emptyA0 + 8 * sa);
                mbar_arrive(emptyB0 + 8 * sb);
            }
            // the chunk into the f32 accumulator: an FADD a step
#pragma unroll
            for (int i = 0; i < NA; ++i) acc[i] += chunk[i];
            if (++sa == p.nsa) {
                sa = 0;
                pa ^= 1;
            }
            if (++sb == p.nsb) {
                sb = 0;
                pb ^= 1;
            }
        }
        if (t.rows == 0) continue;

        // the epilogue: the tile into sC [64][ncols] once the last bulk
        // store has read it, then out
        const int col0 = 2 * NW * t.cb;
        const int ncols = min(2 * NW, p.n - col0);
        if (ctid == 0) bulk_store_read();
        consumers_sync();
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
            const int col = w * NW + 8 * j + 2 * tq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float* dst = sC + (r0 + 8 * h) * ncols + col;
                if (col < ncols) dst[0] = acc[4 * j + 2 * h];
                if (col + 1 < ncols) dst[1] = acc[4 * j + 2 * h + 1];
            }
        }
        fence_to_async();
        consumers_sync();
        float* dst = t.c + t.row0 * p.n + col0;
        const long long bytes = 4ll * t.rows * ncols;
        if (ncols == p.n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0
            && (bytes & 15) == 0) {
            // the tile's rows are contiguous in C: one bulk store, which
            // runs on while the next tile's steps go
            if (ctid == 0) bulk_store(dst, smem_u32(sC), (uint32_t)bytes);
        } else {
            for (int i = ctid; i < t.rows * ncols; i += CONSUMERS) {
                const int r = i / ncols, q = i - r * ncols;
                __stcs(t.c + (t.row0 + r) * p.n + col0 + q, sC[i]);
            }
        }
    }
    if (ctid == 0) bulk_store_done();
}

template <int PASSES, int NW>
__global__ void __launch_bounds__(THREADS, 1)
rl_gemm_kernel(const Params p)
{
    constexpr int PLANES = PASSES > 1 ? 2 : 1;
    extern __shared__ __align__(1024) unsigned char smem[];
    // [B stages][A stages][C tile][A full, A empty, B full, B empty]
    unsigned char* sB = smem;
    unsigned char* sA = sB + p.nsb * PLANES * 64 * NW;
    float* sC = reinterpret_cast<float*>(sA + p.nsa * A_STAGE);
    const uint32_t bars = smem_u32(sC + BM * 2 * NW);
    const uint32_t fullA0 = bars, emptyA0 = fullA0 + 8 * p.nsa;
    const uint32_t fullB0 = emptyA0 + 8 * p.nsa;
    const uint32_t emptyB0 = fullB0 + 8 * p.nsb;
    if (threadIdx.x == 0) {
        for (int i = 0; i < p.nsa; ++i) {
            mbar_init(fullA0 + 8 * i, 64);    // each A producer lane
            mbar_init(emptyA0 + 8 * i, 8);    // a lane of each consumer warp
        }
        for (int i = 0; i < p.nsb; ++i) {
            mbar_init(fullB0 + 8 * i, 1);     // the expected bytes
            mbar_init(emptyB0 + 8 * i, 8);    // a lane of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    // the block's tiles: blockIdx.x, then every gridDim.x-th.  The
    // consumers take the registers the producer warpgroup gives up.
    if (threadIdx.x < CONSUMERS) {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                     :: "n"(CONSUMER_REGS));
        consume<PASSES, NW>(p, sC, sA, sB, bars, threadIdx.x / WG);
    } else {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        // warps 0 and 2 copy A, a thread of warp 1 copies B
        const int warp = (threadIdx.x - CONSUMERS) >> 5;
        if (warp == 0 || warp == 2)
            produce_a<NW>(p, sA, fullA0, emptyA0, warp / 2);
        else if (warp == 1 && (threadIdx.x & 31) == 0)
            produce_b<PASSES, NW>(p, sB, fullB0, emptyB0);
    }
}

template <int PASSES, int NW>
int launch(const float* a0, const float* a1, const void* hi, const void* lo,
           float* c0, float* c1, long long m, int k, int n, int nops,
           cudaStream_t st)
{
    constexpr int PLANES = PASSES > 1 ? 2 : 1;
    const int tile = 4 * BM * 2 * NW;                // the C tile
    const int bstage = PLANES * 64 * NW + 16;        // and its barriers
    const int astage = A_STAGE + 16;
    const int room = SMEM_MAX - tile;
    // B's stages (from L2) up to B_STAGES while A keeps A_STAGES; A's
    // (from device memory) as many as fit, up to MAX_STAGES
    int nsb = (room - A_STAGES * astage) / bstage;
    nsb = nsb < B_STAGES ? nsb : B_STAGES;
    int nsa = (room - nsb * bstage) / astage;
    nsa = nsa < MAX_STAGES ? nsa : MAX_STAGES;
    if (nsb < 2 || nsa < 2) return -1;
    const int smem = tile + nsb * bstage + nsa * astage;
    auto kern = rl_gemm_kernel<PASSES, NW>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    Params p;
    p.a0 = a0;
    p.a1 = a1;
    p.bhi = static_cast<const unsigned char*>(hi);
    p.blo = static_cast<const unsigned char*>(lo);
    p.c0 = c0;
    p.c1 = c1;
    p.m = m;
    p.mtiles = (m + BM - 1) / BM;
    p.ntiles = nops * p.mtiles * col_blocks(n);
    p.k = k;
    p.n = n;
    p.nks = (k + 15) / 16;
    p.nops = nops;
    p.nsa = nsa;
    p.nsb = nsb;
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int grid = (int)(p.ntiles < sms ? p.ntiles : sms);
    kern<<<grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
}

template <int PASSES>
int launch_passes(const float* a0, const float* a1, const void* hi,
                  const void* lo, float* c0, float* c1, long long m, int k,
                  int n, int nops, cudaStream_t st)
{
    switch (wg_cols(n)) {
    case 32:
        return launch<PASSES, 32>(a0, a1, hi, lo, c0, c1, m, k, n, nops,
                                  st);
    case 64:
        return launch<PASSES, 64>(a0, a1, hi, lo, c0, c1, m, k, n, nops,
                                  st);
    case 128:
        return launch<PASSES, 128>(a0, a1, hi, lo, c0, c1, m, k, n, nops,
                                   st);
    default:
        return launch<PASSES, WIDE>(a0, a1, hi, lo, c0, c1, m, k, n, nops,
                                    st);
    }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Return a cudaError_t, 0 when the
// launch was accepted, or -1 for a shape the kernel does not take.  Do
// not synchronise.

// uint2 words in each packed plane of a [k, n] B; -1 unless k and n are
// positive.
long long rl_gemm_plane_words(int k, int n)
{
    if (k < 1 || n < 1) return -1;
    // 16 bf16 (32 bytes, 4 words) a column of a k16 step
    return (long long)col_blocks(n) * ((k + 15) / 16) * 2 * wg_cols(n) * 4;
}

// b [k, n] f32 row-major into the planes hi, lo (rl_gemm_plane_words
// uint2 each, 16-byte aligned).
int rl_pack_launch(const float* b, void* hi, void* lo, int k, int n,
                   void* stream)
{
    const long long words = rl_gemm_plane_words(k, n);
    if (words < 0) return -1;
    const long long units = words / 2;
    const int threads = 256;
    const long long want = (units + threads - 1) / threads;
    const int blocks = (int)(want < 65536 ? want : 65536);
    rl_pack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        b, (uint4*)hi, (uint4*)lo, k, n, (k + 15) / 16, 2 * wg_cols(n),
        units);
    return (int)cudaGetLastError();
}

// c0 [m, n] = a0 [m, k] @ B and, when a1 is not NULL, c1 = a1 @ B in the
// same launch; B's planes from rl_pack_launch of the same k and n.  All
// f32 row-major and contiguous, 4-byte aligned; passes 1 or 3.
int rl_gemm_launch(const float* a0, const float* a1, const void* hi,
                   const void* lo, float* c0, float* c1, long long m, int k,
                   int n, int passes, void* stream)
{
    if (rl_gemm_plane_words(k, n) < 0 || m < 0 || (passes != 1 && passes != 3)
        || (a1 == nullptr) != (c1 == nullptr))
        return -1;
    if (m == 0) return 0;
    const int nops = a1 != nullptr ? 2 : 1;
    if (nops == 1) {
        a1 = a0;
        c1 = c0;
    }
    cudaStream_t st = (cudaStream_t)stream;
    return passes == 3
        ? launch_passes<3>(a0, a1, hi, lo, c0, c1, m, k, n, nops, st)
        : launch_passes<1>(a0, a1, hi, lo, c0, c1, m, k, n, nops, st);
}

}  // extern "C"
