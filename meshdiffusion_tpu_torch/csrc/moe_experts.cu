// The routed experts of a sparse-expert FFN (DiT-MoE's SparseMoeBlock) as
// two grouped products, forward only, written for Hopper (sm_90a):
//
//     H[r, f]   = bf16(SiLU(x[tok(r)] . Wg[e(r), f]) * (x[tok(r)] . Wu[e(r), f]))
//     out[d, n] = p[d] * (H[r] . Wd[e(r), n])                      d = order[r]
//
// over the permuted rows r of the (token, slot) pairs: ``order`` lists the
// pairs (token * k + slot) sorted by expert, expert e's rows are
// [offsets[e], offsets[e + 1]), tok(r) = order[r] / k, and p the routing
// weight of the pair. Operands bf16, sums fp32; H bf16 in permuted order,
// out fp32 in pair order. No TPU kernel corresponds: the JAX package has no
// transformer and no routed layer. No library call computes a product over
// a partition of rows that lives on the device (the plain version is a loop
// of one product an expert, which needs the partition on the host).
//
// What bounds it on the H100: the tensor cores. At DiT-MoE-XL's widths (D
// 1152, F 4608) a row costs 6 D F = 31.9 MFLOP against ~16 KB moved; the
// experts' 170 + 85 MB of weights are read once a call.
//
// Design: one source, two modes (``moe_gate_up_kernel``, ``moe_down_kernel``),
// one mainloop. A block is two warpgroups on a tile of 128 rows of one
// expert (64 a warpgroup) by BN output columns; the grid is the N tiles by an
// upper bound of the row tiles, ceil(rows / 128) + E, and each block finds
// its (expert, row tile) from the device offsets, or exits: no count
// reaches the host. A 4-stage cp.async ring over K in 64-deep chunks; A and
// B both K-major with the 128-byte swizzle, both read by wgmma from shared
// memory by descriptor (m64nBNk16, fp32 sums). In the gate/up mode A's rows
// are gathered by the copies themselves, each row's token read from
// ``order`` once (no permuted copy of x); B is the expert's gate and up
// weights packed so that each 128 rows hold 64 gate and then 64 up rows of
// the same hidden units, so that a thread holds both of a unit's sums (the
// accumulator's column c and c + 64) and the epilogue writes SiLU(g) u to H
// as bf16. In the down mode A is H (contiguous rows per expert) and the
// epilogue scales each row by its routing weight and writes it once to its
// pair's row of out. Each chunk's products are one group; the next group is
// issued before the previous one is waited on, and a stage is refilled only
// two chunks after its products were issued (both warpgroups past a barrier
// since), so the tensor cores are not drained each chunk. No split-K and no
// atomics: every sum is one block's, so reruns agree bit for bit.
//
// Requirements (checked by the Python wrapper): D % 192 == 0 (the down
// mode's N tiles), F % 128 == 0 (the gate/up mode's N tiles of 256 packed
// rows), contiguous tensors, 16-byte aligned pointers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace sm90;

constexpr int BM = 128;               // rows a block: two warpgroups' m64
constexpr int BK = 64;                // k a stage: one 128-byte row of bf16
constexpr int STAGES = 4;             // the ring
constexpr int AHEAD = STAGES - 2;     // chunks loaded ahead of the one multiplied
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB

template <int BN>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + BN * BK * 2; }

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi)
{
    __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&r);
}

// Block ``t``'s expert and rows [row0, row_end) from the offsets: expert e's
// row tiles follow those of experts 0..e-1. False for a block past the last.
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets, int E, int t,
                                          int& e, int& row0, int& row_end)
{
    int start = 0;
    for (int i = 0; i < E; ++i) {
        const int lo = __ldg(offsets + i), hi = __ldg(offsets + i + 1);
        const int n = (hi - lo + BM - 1) / BM;
        if (t < start + n) {
            e = i;
            row0 = lo + (t - start) * BM;
            row_end = hi;
            return true;
        }
        start += n;
    }
    return false;
}

// GATE_UP: A rows gathered from x (N, K = D), B the packed gate/up weights
// (E, 2F, D), H written (rows, F). Otherwise A = H (rows, K = F), B the down
// weights (E, D, F), out written (rows, D).
template <int BN, bool GATE_UP>
__device__ __forceinline__ void
moe_tile(unsigned char* smem_raw, const bf16* __restrict__ a_src, const bf16* __restrict__ w,
         const int* __restrict__ order, const int* __restrict__ offsets,
         const float* __restrict__ weights, bf16* __restrict__ h_out, float* __restrict__ out,
         int K, int Nw, int E, int k)
{
    constexpr int STAGE = stage_bytes<BN>();
    constexpr int A_PER = BM * 8 / THREADS;     // 16-byte cells of A a thread loads: 4
    constexpr int B_PER = BN * 8 / THREADS;     // of B: BN / 32
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t smem_s = smem_u32(smem);

    int e, row0, row_end;
    if (!find_tile(offsets, E, blockIdx.y, e, row0, row_end)) return;
    const int n0 = blockIdx.x * BN;              // the tile's first row of the expert's B
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2;
    const int chunks = K / BK;

    // this thread's copies: A rows tid / 8 + 32 j, B rows the same + 32 j,
    // 16-byte cell tid % 8 of each, XOR-swizzled by the row
    const int c = tid & 7, r_lo = tid >> 3;
    const uint32_t cell = (uint32_t)((c ^ (r_lo & 7)) << 4);
    const bf16* a_row[A_PER];
    bool a_live[A_PER];
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
        const int r = row0 + r_lo + 32 * j;
        a_live[j] = r < row_end;
        long long src_row = 0;
        if (a_live[j]) src_row = GATE_UP ? (long long)(__ldg(order + r) / k) : (long long)r;
        a_row[j] = a_src + src_row * K + c * 8;
    }
    const bf16* b_base = w + ((long long)e * Nw + n0 + r_lo) * K + c * 8;

    auto load = [&](int kc, int s) {
        const uint32_t as = smem_s + s * STAGE, bs = as + A_BYTES;
#pragma unroll
        for (int j = 0; j < A_PER; ++j)
            cp_async16(as + (r_lo + 32 * j) * 128 + cell, a_row[j] + kc * BK, a_live[j] ? 16 : 0);
#pragma unroll
        for (int j = 0; j < B_PER; ++j)
            cp_async16(bs + (r_lo + 32 * j) * 128 + cell,
                       b_base + (long long)32 * j * K + kc * BK, 16);
    };

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    fence_regs<BN / 2>(acc);

#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < chunks) load(s, s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int kc = 0; kc < chunks; ++kc) {
        asm volatile("cp.async.wait_group %0;\n" :: "n"(AHEAD - 1) : "memory");
        // the chunk's cp.async writes, visible to wgmma's reads (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        const uint32_t as = smem_s + (kc % STAGES) * STAGE, bs = as + A_BYTES;
        const uint32_t aw = as + wg * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
            WgmmaSS<BN, 0>::run(acc, desc_sw128_k_major(aw + 32 * j), desc_sw128_k_major(bs + 32 * j));
        wgmma_commit();
        // the stage of chunk kc - 2, whose products both warpgroups have
        // waited on before the barrier above
        if (kc + AHEAD < chunks) load(kc + AHEAD, (kc + AHEAD) % STAGES);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);

    // acc[4 q + v] holds row 16 (warp % 4) + g + 8 (v >> 1) of the
    // warpgroup's 64, column 8 q + 2 t4 + (v & 1)
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = row0 + wg * 64 + (warp & 3) * 16 + g + half * 8;
        if (r >= row_end) continue;
        if constexpr (GATE_UP) {
            // each 128 columns: 64 gate and then 64 up of the same units
            const int F = Nw / 2;
            bf16* hr = h_out + (long long)r * F + n0 / 2 + 2 * t4;
#pragma unroll
            for (int grp = 0; grp < BN / 128; ++grp)
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const int ig = 4 * (16 * grp + q) + 2 * half, iu = ig + 32;
                    const float g0 = acc[ig], g1 = acc[ig + 1];
                    const float h0 = g0 / (1.0f + expf(-g0)) * acc[iu];
                    const float h1 = g1 / (1.0f + expf(-g1)) * acc[iu + 1];
                    *reinterpret_cast<uint32_t*>(hr + 64 * grp + 8 * q) = bf16x2(h0, h1);
                }
        } else {
            const int d = __ldg(order + r);
            const float p = __ldg(weights + d);
            float* orow = out + (long long)d * Nw + n0 + 2 * t4;
#pragma unroll
            for (int q = 0; q < BN / 8; ++q)
                *reinterpret_cast<float2*>(orow + 8 * q) =
                    make_float2(p * acc[4 * q + 2 * half], p * acc[4 * q + 2 * half + 1]);
        }
    }
}

constexpr int BN_GATE_UP = 256;       // packed gate/up rows a block: 128 hidden units
constexpr int BN_DOWN = 192;          // output columns a block: D 1152 in six

__global__ void __launch_bounds__(THREADS, 1)
moe_gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_gu,
                   const int* __restrict__ order, const int* __restrict__ offsets,
                   bf16* __restrict__ h, int D, int F2, int E, int k)
{
    extern __shared__ unsigned char smem_raw[];
    moe_tile<BN_GATE_UP, true>(smem_raw, x, w_gu, order, offsets, nullptr, h, nullptr,
                               D, F2, E, k);
}

__global__ void __launch_bounds__(THREADS, 1)
moe_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w_down,
                const int* __restrict__ order, const int* __restrict__ offsets,
                const float* __restrict__ weights, float* __restrict__ out, int F, int D, int E)
{
    extern __shared__ unsigned char smem_raw[];
    moe_tile<BN_DOWN, false>(smem_raw, h, w_down, order, offsets, weights, nullptr, out,
                             F, D, E, 1);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed)
{
    if (smem > allowed) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
        allowed = smem;
    }
    return cudaSuccess;
}

}  // namespace

// x (N, D) bf16; w_gu (E, 2F, D) bf16, packed; w_down (E, D, F) bf16;
// order (rows,) int32; offsets (E + 1,) int32; weights (rows,) fp32 in pair
// order; h (rows, F) bf16 scratch; out (rows, D) fp32. rows = N k.
extern "C" int moe_experts_bf16(const void* x, const void* w_gu, const void* w_down,
                                const void* order, const void* offsets, const void* weights,
                                void* h, void* out, int rows, int D, int F, int E, int k,
                                void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (rows <= 0 || E <= 0 || k <= 0 || D % BN_DOWN || F % (BN_GATE_UP / 2))
        return (int)cudaErrorInvalidValue;
    static size_t gu_allowed = 0, down_allowed = 0;   // raised on demand
    const size_t gu_smem = 1024 + (size_t)STAGES * stage_bytes<BN_GATE_UP>();
    const size_t down_smem = 1024 + (size_t)STAGES * stage_bytes<BN_DOWN>();
    cudaError_t err = allow_smem(moe_gate_up_kernel, gu_smem, gu_allowed);
    if (err == cudaSuccess) err = allow_smem(moe_down_kernel, down_smem, down_allowed);
    if (err != cudaSuccess) return (int)err;
    // the grid: the N tiles by an upper bound of the row tiles over the experts
    const unsigned tiles = (unsigned)((rows + BM - 1) / BM + E);
    moe_gate_up_kernel<<<dim3((unsigned)(2 * F / BN_GATE_UP), tiles), THREADS, gu_smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_gu),
        static_cast<const int*>(order), static_cast<const int*>(offsets),
        static_cast<bf16*>(h), D, 2 * F, E, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    moe_down_kernel<<<dim3((unsigned)(D / BN_DOWN), tiles), THREADS, down_smem, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w_down),
        static_cast<const int*>(order), static_cast<const int*>(offsets),
        static_cast<const float*>(weights), static_cast<float*>(out), F, D, E);
    return (int)cudaGetLastError();
}
