// The DiT block's multi-head attention, forward only, written for Hopper
// (sm_90a):
//
//     out[b, t, h DH + n] = sum_s softmax_s(q_t . k_s / sqrt(DH)) v_s[n]
//
// per sample b and head h, non-causal, no mask, with q, k and v read in
// place from a bf16 (B, T, 3 D) buffer, D = H DH (DiT's split: q at h DH, k
// at D + h DH, v at 2 D + h DH of a token's row): the qkv Linear's output
// in a DiT block, the joint sequence that qk_norm_rope.cu writes in a FLUX
// block. The output is bf16 (B, T, D). No TPU kernel corresponds: the JAX
// package holds no transformer, and its U-Net's attention is a single-head
// pair of einsums with the T x T scores in memory (meshdiffusion_tpu/models/
// layers.py, AttnBlock).
//
// Two head dimensions, one body (attention<>, below) instantiated twice:
// dit_attention_kernel at DH 72 (DiT-XL's 1152 / 16) and
// dit_attention_dh128_kernel at DH 128 (FLUX's 3072 / 24).
//
// What bounds it on the H100: the tensor cores, and beside them the
// exponentials. A head's two products are 2 T^2 DH FLOP each against 8 T DH
// bytes of q, k, v and output: at T 4096 and DH 72, ~2,300 operations a
// byte against the card's ~295 at its ridge; the scores never reach device
// memory. A score costs 304 tensor FLOP at DH 72 (Q K^T over the padded
// depth 80, P V over 72; 512 at DH 128) at 4,096 a clock an SM, and one ex2
// at 16 a clock an SM: at DH 72 the softmax needs ~85 % of the products'
// time (~50 % at DH 128), so it has to run under them (run one after
// another, loads, softmax and products took 0.95 ms a DH-72 b4 call, the
// products alone 0.39).
//
// Design: one persistent block an SM, warp-specialised.
// * Work items are (sample, head, BQ-query tile), walked by block i as
//   items i, i + grid, ... with the query tile fastest, so neighbouring
//   blocks share a head's K and V in L2. The grid is min(items, SMs): the
//   call's B, T, H and the card's SM count decide it. An item reads its
//   head's K and V once for BQ queries (DH 72: BQ 192, 1.66 GB a b4 call;
//   128-query items read 2.42).
// * Producer: one warp (its warpgroup's registers cut by setmaxnreg)
//   issues every copy by TMA from four tensor maps over the qkv tensor in
//   place, (DH, 3 H heads, T, B) with T and B as dimensions of their own,
//   so rows past T read as zeros. Q comes once an item into one of two
//   buffers; K and V in tiles of 64 keys into a ring of STAGES, each with
//   its own full and empty mbarriers, so a stage's K is free again once
//   Q K^T has read it and its V once P V has.
//   - K and Q: dh 0-63 as one 128-byte-swizzled box (rows of 128 bytes,
//     the layout wgmma's K-major SW128 descriptor reads), and dh 64 .. DH-1
//     as a second box (the "tail"). At DH 72 the tail is a 16-byte box
//     (rows of 16 bytes: unswizzled 8 x 16-byte core matrices), whose k16
//     step reads dh 72-79 from 1 KB of zeros written once (the descriptor's
//     leading offset points there). At DH 128 it is a second swizzled box
//     of 128-byte rows: four more k16 steps, no padding.
//   - V: dh 0-63 as a swizzled box, and dh 64-127 as a second (at DH 72 its
//     dh 72-127 lie past the tensor map's DH and arrive as zeros): the two
//     64-column blocks of the N-major SW128 descriptor of O += P V.
// * Consumers: WGS warpgroups of 64 queries take turns on WGS named
//   barriers to issue their products, so that one's softmax runs while the
//   others' products do. In its turn a warpgroup issues S_j = Q K_j^T
//   (wgmma m64n64k16, Q and K both from shared memory, no registers held
//   for Q) and O += P_{j-1} V_{j-1} (m64nDHk16, P from registers); it then
//   runs S_j's softmax while P_{j-1} V_{j-1} runs (FlashAttention-3's
//   two-stage pipeline within a warpgroup).
//   - DH 72: three warpgroups at 160 registers (the producer's at 32),
//     BQ 192, a 5-stage ring.
//   - DH 128: O takes 64 fp32 registers a thread (36 at DH 72), so three
//     warpgroups at 160 would spill; two warpgroups at 240 registers (the
//     producer's at 24: 128 x 24 + 256 x 240 = 384 x 168), BQ 128, and a
//     4-stage ring (Q's and K's rows are 256 bytes: 199 KB of shared
//     memory).
// * The arithmetic: scores in fp32, the online softmax in registers (a
//   row's four threads reduce its maximum by shuffles; the scale and
//   log2(e) folded into one fma before ex2.approx; row sums per thread,
//   reduced at the end), P rounded to bf16 once as the A operand of P V, O
//   in fp32, divided by the row sums and stored as bf16. An item's epilogue
//   overlaps the producer's loads of the next item.
// Each block owns its rows' sums, nothing is atomic: reruns agree bit for
// bit. DH 72: 0.68 ms a b4 call, 0.19 at b1, on an H100 at 700 W.
//
// Variants timed on the same card at DH 72 (CUDA events, b4): 128-key
// tiles with three warpgroups need more than 160 registers (spills, wgmma
// serialised: 1.67 ms); two warpgroups of 240 registers with 128-key tiles
// run as fast (0.67) but read K and V for 128 queries only; without the
// turns 0.73; S_{j+1} issued before S_j's softmax (two S buffers) spills
// with the turns (1.42) and is slower without (0.71-0.74); Q's fragments in
// registers spill with the turns; a rescale of O skipped when no maximum
// moved, and P rounded by integer operations, gave nothing or lost.
//
// Requirements (checked by the Python wrapper): DH 72 or 128, contiguous
// qkv and output, 16-byte aligned pointers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace sm90;

constexpr int BM = 64;                  // queries a consumer warpgroup: wgmma's m64
constexpr int BN = 64;                  // keys a tile
// ROW: a 128-byte swizzled row (dh 0-63); CELL: a 16-byte row (DH 72's dh 64-71)
constexpr int ROW = 128, CELL = 16;

// One instantiation's shape. Shared memory, from a 1024-byte aligned base:
// two Q buffers, the ring, the zeros, the mbarriers.
template <int DH_, int WGS_, int STAGES_, int PRODUCER_REGS_, int CONSUMER_REGS_>
struct Shape {
    static constexpr int DH = DH_;                   // head dimension
    static constexpr int WGS = WGS_;                 // consumer warpgroups
    static constexpr int STAGES = STAGES_;           // K/V ring
    static constexpr int PRODUCER_REGS = PRODUCER_REGS_, CONSUMER_REGS = CONSUMER_REGS_;
    static constexpr int BQ = BM * WGS;              // queries a work item
    static constexpr int THREADS = 128 * (WGS + 1);  // and the producer's warpgroup
    static constexpr int TAIL = 2 * (DH - 64);       // bytes of a row's dh 64 .. DH-1
    static constexpr bool SWIZZLED_TAIL = TAIL == ROW;
    static constexpr int Q_TAIL = BQ * ROW, Q_BYTES = BQ * (ROW + TAIL);
    static constexpr int K_MAIN = 0, V_MAIN = BN * ROW, V_TAIL = 2 * BN * ROW, K_TAIL = 3 * BN * ROW;
    static constexpr int STAGE_BYTES = 3 * BN * ROW + BN * TAIL;
    static constexpr int K_TX = BN * (ROW + TAIL), V_TX = 2 * BN * ROW;   // bytes a K tile, a V tile brings
    static constexpr int RING = 2 * Q_BYTES;
    static constexpr int ZEROS = RING + STAGES * STAGE_BYTES;
    static constexpr int BARS = ZEROS + BN * CELL;
    static constexpr int SMEM_BYTES = 1024 + BARS + (4 * STAGES + 4) * 8;
    static_assert(TAIL == CELL || TAIL == ROW, "the tail is a 16-byte cell or a swizzled row");
    static_assert(Q_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzled boxes need 1024-byte alignment");
    static_assert(BN * CELL >= BM * CELL, "the zeros serve Q's k16 step too");
    static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");
    static_assert(128 * PRODUCER_REGS + 128 * WGS * CONSUMER_REGS <= 65536, "more registers than an SM has");
};

using Dh72 = Shape<72, 3, 5, 32, 160>;     // 128 * 32 + 384 * 160 = 512 * 128
using Dh128 = Shape<128, 2, 4, 24, 240>;   // 128 * 24 + 256 * 240 = 384 * 168

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi)
{
    __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// S = Q K^T: four k16 steps along the swizzled rows of dh 0-63 (32 bytes
// each), then the tail's. DH 72: one step over the padded depth 80, from the
// 16-byte rows and the zeros (q_tail a descriptor). DH 128: four more steps
// along the second swizzled block (q_tail its address).
template <class S>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_main, uint64_t q_tail, uint32_t st,
                                         uint32_t zeros)
{
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
        WgmmaSS<BN, 0>::run(s, desc_sw128_k_major(q_main + 32 * j),
                            desc_sw128_k_major(st + S::K_MAIN + 32 * j), j > 0);
    const uint32_t kt = st + S::K_TAIL;
    if constexpr (S::SWIZZLED_TAIL) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            WgmmaSS<BN, 0>::run(s, desc_sw128_k_major((uint32_t)q_tail + 32 * j),
                                desc_sw128_k_major(kt + 32 * j));
    } else {
        WgmmaSS<BN, 0>::run(s, q_tail, desc_none_k_major(kt, zeros - kt, 8 * CELL));
    }
    wgmma_commit();
}

// O += P V: k16 step j takes keys 16 j .. 16 j + 15 (2 KB further along V's
// rows); N = DH spans V's dh 0-63 block and its dh 64-127 block
template <class S>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*p)[4], uint32_t st)
{
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
        Wgmma<S::DH, 1>::run(o, p[j], desc_sw128_n_major(st + S::V_MAIN + j * 2048, S::V_TAIL - S::V_MAIN));
    wgmma_commit();
}

// The online softmax of a tile's scores, in place: s[4 q + e] is row g + 8
// (e >> 1), key key0 + 8 q + 2 t4 + (e & 1); keys past T are masked out. The
// running maxima m (scaled, log2 domain) and sums l are updated, c is the
// factor O has to be scaled by before this tile's P V.
__device__ __forceinline__ void softmax(float* s, int key0, int T, int t4, float scale_log2,
                                        float& m0, float& m1, float& l0, float& l1, float& c0,
                                        float& c1)
{
    if (key0 + BN > T) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
            if (key0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= T) s[i] = -INFINITY;
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
        x0 = fmaxf(x0, fmaxf(s[4 * q], s[4 * q + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * q + 2], s[4 * q + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
    }
    const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
    c0 = ex2(m0 - n0);
    c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
        s[4 * q] = ex2(fmaf(s[4 * q], scale_log2, -n0));
        s[4 * q + 1] = ex2(fmaf(s[4 * q + 1], scale_log2, -n0));
        s[4 * q + 2] = ex2(fmaf(s[4 * q + 2], scale_log2, -n1));
        s[4 * q + 3] = ex2(fmaf(s[4 * q + 3], scale_log2, -n1));
        s0 += s[4 * q] + s[4 * q + 1];
        s1 += s[4 * q + 2] + s[4 * q + 3];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
}

// P as the A fragments of O += P V: step j (keys 16 j .. 16 j + 15) takes
// the probabilities of q = 2 j (registers 0, 1) and q = 2 j + 1 (2, 3)
__device__ __forceinline__ void to_bf16(uint32_t (*p)[4], const float* s)
{
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = bf16x2(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
}

// o[4 q + e]: row g + 8 (e >> 1), dh 8 q + 2 t4 + (e & 1)
template <int DH>
__device__ __forceinline__ void rescale(float* o, float c0, float c1)
{
#pragma unroll
    for (int q = 0; q < DH / 8; ++q) {
        o[4 * q] *= c0;
        o[4 * q + 1] *= c0;
        o[4 * q + 2] *= c1;
        o[4 * q + 3] *= c1;
    }
}

// The kernel's body, for one instantiation's shape S.
template <class S>
__device__ __forceinline__ void attention(const CUtensorMap& tm_q, const CUtensorMap& tm_qtail,
                                          const CUtensorMap& tm_kv, const CUtensorMap& tm_ktail,
                                          bf16* __restrict__ out, int T, int H, int items, float scale_log2)
{
    constexpr int DH = S::DH, WGS = S::WGS, STAGES = S::STAGES, BQ = S::BQ, THREADS = S::THREADS;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t base = smem_u32(smem);
    uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + S::BARS);
    uint64_t* empty_k = full_k + STAGES;
    uint64_t* full_v = full_k + 2 * STAGES;
    uint64_t* empty_v = full_k + 3 * STAGES;
    uint64_t* q_full = full_k + 4 * STAGES;
    uint64_t* q_empty = q_full + 2;

    const int tid = threadIdx.x, wg = tid >> 7;
    const int qtiles = (T + BQ - 1) / BQ, tiles = (T + BN - 1) / BN;
    const uint32_t zeros = base + S::ZEROS;

    for (int i = tid; i < BN * CELL / 16; i += THREADS)
        reinterpret_cast<uint4*>(smem + S::ZEROS)[i] = make_uint4(0u, 0u, 0u, 0u);
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k + s, 1);
            mbar_init(empty_k + s, WGS * 4);
            mbar_init(full_v + s, 1);
            mbar_init(empty_v + s, WGS * 4);
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(q_full + i, 1);
            mbar_init(q_empty + i, WGS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the zeros, visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (wg == WGS) {
        // ---- the producer: one thread issues every copy ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(S::PRODUCER_REGS));
        if (tid == WGS * 128) {
            int kv = 0, local = 0;
            for (int item = blockIdx.x; item < items; item += gridDim.x, ++local) {
                const int qt = item % qtiles, bh = item / qtiles, h = bh % H, b = bh / H;
                const int qb = local & 1;
                const uint32_t q = base + qb * S::Q_BYTES;
                mbar_wait(q_empty + qb, ((local >> 1) & 1) ^ 1);
                mbar_expect_tx(q_full + qb, S::Q_BYTES);
                tma_load_4d(q, &tm_q, 0, h, qt * BQ, b, q_full + qb);
                tma_load_4d(q + S::Q_TAIL, &tm_qtail, 64, h, qt * BQ, b, q_full + qb);
                for (int j = 0; j < tiles; ++j, ++kv) {
                    const int s = kv % STAGES;
                    const uint32_t ph = ((kv / STAGES) & 1) ^ 1;
                    const uint32_t st = base + S::RING + s * S::STAGE_BYTES;
                    mbar_wait(empty_k + s, ph);
                    mbar_expect_tx(full_k + s, S::K_TX);
                    tma_load_4d(st + S::K_MAIN, &tm_kv, 0, H + h, j * BN, b, full_k + s);
                    tma_load_4d(st + S::K_TAIL, &tm_ktail, 64, H + h, j * BN, b, full_k + s);
                    mbar_wait(empty_v + s, ph);
                    mbar_expect_tx(full_v + s, S::V_TX);
                    tma_load_4d(st + S::V_MAIN, &tm_kv, 0, 2 * H + h, j * BN, b, full_v + s);
                    tma_load_4d(st + S::V_TAIL, &tm_kv, 64, 2 * H + h, j * BN, b, full_v + s);
                }
            }
        }
    } else {
        // ---- the consumers: warpgroup wg takes queries 64 wg .. 64 wg + 63 of an item ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(S::CONSUMER_REGS));
        const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
        const int D = H * DH;
        const int turn = 1 + wg, next = 1 + (wg + 1) % WGS;     // named barriers 1 .. WGS
        float o[DH / 2], s[BN / 2];
        uint32_t p[BN / 16][4];
        if (wg == WGS - 1) bar_arrive<256>(1);                  // the first turn is warpgroup 0's
        int kv = 0, local = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x, ++local) {
            const int qt = item % qtiles, bh = item / qtiles, h = bh % H, b = bh / H;
            const int qb = local & 1;
            const uint32_t q_main = base + qb * S::Q_BYTES + wg * BM * ROW;
            const uint32_t qt_addr = base + qb * S::Q_BYTES + S::Q_TAIL + wg * BM * S::TAIL;
            const uint64_t q_tail = S::SWIZZLED_TAIL ? (uint64_t)qt_addr
                                                     : desc_none_k_major(qt_addr, zeros - qt_addr, 8 * CELL);
            float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, c0 = 0.0f, c1 = 0.0f;
#pragma unroll
            for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
            mbar_wait(q_full + qb, (local >> 1) & 1);

            // tile 0: S_0 alone
            {
                const int sk = kv % STAGES;
                mbar_wait(full_k + sk, (kv / STAGES) & 1);
                bar_sync<256>(turn);
                issue_qk<S>(s, q_main, q_tail, base + S::RING + sk * S::STAGE_BYTES, zeros);
                bar_arrive<256>(next);
                wgmma_wait<0>();
                fence_regs<BN / 2>(s);
                if (lane == 0) {
                    mbar_arrive(empty_k + sk);
                    if (tiles == 1) mbar_arrive(q_empty + qb);
                }
                softmax(s, 0, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
                to_bf16(p, s);
            }
            // tile j: S_j and P_{j-1} V_{j-1} issued in one turn; S_j's softmax under P V
            for (int j = 1; j < tiles; ++j) {
                const int kj = kv + j, sk = kj % STAGES, sv = (kj - 1) % STAGES;
                mbar_wait(full_k + sk, (kj / STAGES) & 1);
                bar_sync<256>(turn);
                issue_qk<S>(s, q_main, q_tail, base + S::RING + sk * S::STAGE_BYTES, zeros);
                rescale<DH>(o, c0, c1);
                mbar_wait(full_v + sv, ((kj - 1) / STAGES) & 1);
                issue_pv<S>(o, p, base + S::RING + sv * S::STAGE_BYTES);
                bar_arrive<256>(next);
                wgmma_wait<1>();
                fence_regs<BN / 2>(s);
                if (lane == 0) {
                    mbar_arrive(empty_k + sk);
                    if (j == tiles - 1) mbar_arrive(q_empty + qb);
                }
                softmax(s, j * BN, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
                wgmma_wait<0>();
                fence_regs<DH / 2>(o);
                fence_regs<BN / 2>(s);
                if (lane == 0) mbar_arrive(empty_v + sv);
                to_bf16(p, s);
            }
            // the last tile's P V
            {
                const int kl = kv + tiles - 1, sv = kl % STAGES;
                rescale<DH>(o, c0, c1);
                mbar_wait(full_v + sv, (kl / STAGES) & 1);
                issue_pv<S>(o, p, base + S::RING + sv * S::STAGE_BYTES);
                wgmma_wait<0>();
                fence_regs<DH / 2>(o);
                if (lane == 0) mbar_arrive(empty_v + sv);
            }
            kv += tiles;

#pragma unroll
            for (int w = 1; w < 4; w <<= 1) {
                l0 += __shfl_xor_sync(0xffffffffu, l0, w);
                l1 += __shfl_xor_sync(0xffffffffu, l1, w);
            }
            const float inv[2] = {1.0f / l0, 1.0f / l1};
            const int r0 = qt * BQ + wg * BM + warp * 16 + g;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = r0 + half * 8;
                if (r >= T) continue;
                bf16* orow = out + ((long long)b * T + r) * D + h * DH + 2 * t4;
#pragma unroll
                for (int q = 0; q < DH / 8; ++q)
                    *reinterpret_cast<uint32_t*>(orow + 8 * q) =
                        bf16x2(o[4 * q + 2 * half] * inv[half], o[4 * q + 2 * half + 1] * inv[half]);
            }
        }
        if (wg == 0) bar_sync<256>(1);          // the last warpgroup's last hand-over
    }
}

__global__ void __launch_bounds__(Dh72::THREADS, 1)
dit_attention_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_qtail,
                     const __grid_constant__ CUtensorMap tm_kv, const __grid_constant__ CUtensorMap tm_ktail,
                     bf16* __restrict__ out, int T, int H, int items, float scale_log2)
{
    attention<Dh72>(tm_q, tm_qtail, tm_kv, tm_ktail, out, T, H, items, scale_log2);
}

__global__ void __launch_bounds__(Dh128::THREADS, 1)
dit_attention_dh128_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_qtail,
                           const __grid_constant__ CUtensorMap tm_kv, const __grid_constant__ CUtensorMap tm_ktail,
                           bf16* __restrict__ out, int T, int H, int items, float scale_log2)
{
    attention<Dh128>(tm_q, tm_qtail, tm_kv, tm_ktail, out, T, H, items, scale_log2);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver library, through the runtime (no -lcuda)
EncodeTiled encoder()
{
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                                 cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                                        &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !f) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(f);
    }
    return fn;
}

// A tensor map over qkv as (dh, 3 H heads, T, B) whose box is (box0, 1,
// rows, 1) elements, 128-byte swizzled or not.
bool encode(EncodeTiled fn, CUtensorMap* m, const void* qkv, int B, int T, int H, int dh, uint32_t box0,
            uint32_t rows, bool swizzle)
{
    const cuuint64_t row = 3ull * H * dh * sizeof(bf16);
    const cuuint64_t dims[4] = {(cuuint64_t)dh, 3ull * H, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[3] = {dh * sizeof(bf16), row, row * T};
    const cuuint32_t box[4] = {box0, 1, rows, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(qkv), dims, strides, box, step,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*Kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap, bf16*, int,
                       int, int, float);

// Launch one instantiation: the tensor maps, the grid from the card's SMs.
template <class S>
int launch(Kernel kernel, const void* qkv, void* out, int B, int T, int H, void* stream)
{
    constexpr int DH = S::DH, BQ = S::BQ, TAIL_BOX = S::TAIL / 2;
    const long long items = (long long)B * H * ((T + BQ - 1) / BQ);
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const EncodeTiled fn = encoder();
    if (!fn) return (int)cudaErrorSymbolNotFound;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    static bool smem_set = false;
    if (!smem_set) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    CUtensorMap tq, tqt, tkv, tkt;
    if (!encode(fn, &tq, qkv, B, T, H, DH, 64, BQ, true)
        || !encode(fn, &tqt, qkv, B, T, H, DH, TAIL_BOX, BQ, S::SWIZZLED_TAIL)
        || !encode(fn, &tkv, qkv, B, T, H, DH, 64, BN, true)
        || !encode(fn, &tkt, qkv, B, T, H, DH, TAIL_BOX, BN, S::SWIZZLED_TAIL))
        return (int)cudaErrorInvalidValue;
    const int grid = (int)(items < sms ? items : sms);
    kernel<<<grid, S::THREADS, S::SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(
        tq, tqt, tkv, tkt, static_cast<bf16*>(out), T, H, (int)items, 1.4426950408889634f / sqrtf((float)DH));
    return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, T, 3 H dh) bf16; out (B, T, H dh) bf16; dh must be 72 or 128.
extern "C" int dit_attention_bf16(const void* qkv, void* out, int B, int T, int H, int dh,
                                  void* stream)
{
    if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
    if (dh == Dh72::DH) return launch<Dh72>(dit_attention_kernel, qkv, out, B, T, H, stream);
    if (dh == Dh128::DH) return launch<Dh128>(dit_attention_dh128_kernel, qkv, out, B, T, H, stream);
    return (int)cudaErrorInvalidValue;
}
