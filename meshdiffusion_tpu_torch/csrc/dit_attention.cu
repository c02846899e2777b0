// The DiT block's multi-head attention, forward only, written for Hopper
// (sm_90a):
//
//     out[b, t, h DH + n] = sum_s softmax_s(q_t . k_s / sqrt(DH)) v_s[n]
//
// per sample b and head h, non-causal, no mask, with q, k and v read in
// place from the qkv Linear's bf16 output (B, T, 3 D), D = H DH (DiT's
// split: q at h DH, k at D + h DH, v at 2 D + h DH of a token's row), and
// the bf16 output (B, T, D). No TPU kernel corresponds: the JAX package
// holds no transformer, and its U-Net's attention is a single-head pair of
// einsums with the T x T scores in memory (meshdiffusion_tpu/models/
// layers.py, AttnBlock).
//
// What bounds it on the H100: the tensor cores. A head's two products are
// 2 T^2 DH FLOP each against 8 T DH bytes of q, k, v and output: at T 4096
// and DH 72, ~2,300 operations a byte against the card's ~295 at its
// ridge. The scores never reach device memory.
//
// Design: a block of two warpgroups takes 128 queries of one (sample,
// head), 64 a warpgroup, and walks the keys in tiles of 64 through a
// 3-stage cp.async ring that both warpgroups fill and read.
// * Q stays in registers for the whole walk as wgmma A fragments, loaded
//   once from global memory; dh 72 to 79 are zero, since wgmma's k step is
//   16: S = Q K^T is five k16 steps of wgmma m64n64k16.
// * A stage holds the tile's K as two K-major, 128-byte-swizzled blocks of
//   64 rows (dh 0-63; dh 64-71 in each row's first 16 bytes and zeros in
//   its second, written once, which the ring never overwrites) and its V as
//   two N-major blocks (dh 0-63; dh 64-71), V's own layout, so that
//   O += P V is wgmma m64n72k16 with B transposed by the descriptor.
//   Keys past T are zero-filled by the copies and masked out of the scores.
// * The online softmax runs in registers in fp32: a row's four threads
//   reduce its maximum by shuffles, the scale and log2(e) are folded into
//   one fma before exp2, the row sums are kept per thread and reduced at
//   the end. P is rounded to bf16 and fed back from registers as the A
//   fragments of the second product (the accumulator's layout is the A
//   operand's).
// * O (fp32, in registers) is divided by the row sums and stored as bf16.
// * Two blocks an SM (128 registers a thread, 2 x 97 KB of shared memory):
//   the two warpgroups of a block run in step (one barrier a tile), so a
//   second block's products fill the tensor cores while one block's
//   softmax runs. 1.21 ms a b4 call at one block an SM, 0.95 at two, on an
//   H100; of the 0.95, a variant that skips the tile loads takes 0.66 and
//   one that skips the softmax 0.69 (L2 -> shared memory traffic: every
//   block reads its head's K and V whole, ~2.4 GB a b4 call).
// Each block owns its rows' sums: reruns agree bit for bit.
//
// Requirements (checked by the Python wrapper): DH 72, contiguous qkv and
// output, 16-byte aligned pointers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace sm90;

constexpr int DH = 72;                  // head dimension
constexpr int DH_CELLS = DH / 8;        // 16-byte cells of a head's row
constexpr int KSTEPS = 5;               // k16 steps of Q K^T: DH padded to 80
constexpr int BM = 64;                  // queries a warpgroup: wgmma's m64
constexpr int WGS = 2;                  // warpgroups a block
constexpr int BQ = BM * WGS;            // queries a block
constexpr int BN = 64;                  // keys a tile
constexpr int STAGES = 3;
constexpr int THREADS = 128 * WGS;
constexpr int TILE = BN * 128;          // one 64-row block of 128-byte swizzled rows
constexpr int STAGE_BYTES = 4 * TILE;   // K dh 0-63 | K dh 64-79 | V dh 0-63 | V dh 64-71
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;

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

__global__ void __launch_bounds__(THREADS, 2)
dit_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int H,
                     float scale_log2)
{
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t smem_s = smem_u32(smem);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int D = H * DH;
    const long long stride = 3LL * D;                 // elements from one token's row to the next
    const int h = blockIdx.y, b = blockIdx.z;
    const bf16* qbase = qkv + (long long)b * T * stride + h * DH;
    const bf16* kbase = qbase + D;
    const bf16* vbase = qbase + 2 * D;
    const int tiles = (T + BN - 1) / BN;

    // the zeros of K's dh 72-79 in every stage: each row's second 16-byte cell
    // of its dh 64-79 block, after the swizzle
    for (int i = tid; i < STAGES * BN; i += THREADS) {
        const int s = i / BN, r = i % BN;
        *reinterpret_cast<uint4*>(smem + s * STAGE_BYTES + TILE + r * 128 + ((1 ^ (r & 7)) << 4)) =
            make_uint4(0u, 0u, 0u, 0u);
    }

    // key tile kt into stage s: a row's nine 16-byte cells of K and of V, cell
    // c < 8 into the block's first 64 columns, cell 8 into the second block's
    // cell 0, each XOR-swizzled by the row; rows past T are zero-filled
    auto load = [&](int kt, int s) {
        const uint32_t st = smem_s + s * STAGE_BYTES;
        for (int i = tid; i < 2 * BN * DH_CELLS; i += THREADS) {
            const int v = i / (BN * DH_CELLS), j = i % (BN * DH_CELLS);
            const int r = j / DH_CELLS, c = j % DH_CELLS;
            const int t = kt * BN + r;
            const bool live = t < T;
            const bf16* src = (v ? vbase : kbase) + (live ? (long long)t * stride : 0) + c * 8;
            cp_async16(st + (2 * v + (c >> 3)) * TILE + r * 128 + (((c & 7) ^ (r & 7)) << 4), src,
                       live ? 16 : 0);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < tiles) load(s, s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // Q's A fragments: rows r0 and r0 + 8 of the warp's 16; register e of
    // step j holds row r0 + 8 (e & 1), dh 16 j + 2 t4 + 8 (e >> 1) and the next
    const int r0 = blockIdx.x * BQ + (warp >> 2) * BM + (warp & 3) * 16 + g;
    uint32_t qa[KSTEPS][4];
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = r0 + (e & 1) * 8, k = 16 * j + 2 * t4 + (e >> 1) * 8;
            qa[j][e] = (r < T && k < DH)
                ? __ldg(reinterpret_cast<const uint32_t*>(qbase + (long long)r * stride + k)) : 0u;
        }

    // o[4 q + e]: row r0 + 8 (e >> 1), dh 8 q + 2 t4 + (e & 1); the same
    // layout for the scores s, key 8 q + 2 t4 + (e & 1) of the tile
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    fence_regs<DH / 2>(o);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    for (int kt = 0; kt < tiles; ++kt) {
        asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
        // the tile's cp.async writes (and the zeros), visible to wgmma's reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (kt + STAGES - 1 < tiles) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        const uint32_t st = smem_s + (kt % STAGES) * STAGE_BYTES;

        float s[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
        fence_regs<BN / 2>(s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KSTEPS - 1; ++j)
            Wgmma<BN, 0>::run(s, qa[j], desc_sw128_k_major(st + 32 * j));
        Wgmma<BN, 0>::run(s, qa[KSTEPS - 1], desc_sw128_k_major(st + TILE));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN / 2>(s);

        if ((kt + 1) * BN > T) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
                if (kt * BN + 8 * (i >> 2) + 2 * t4 + (i & 1) >= T) s[i] = -INFINITY;
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
        const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
        m0 = n0;
        m1 = n1;

        // P as the A fragments of O += P V: step j (keys 16 j .. 16 j + 15)
        // takes the scores of q = 2 j (registers 0, 1) and q = 2 j + 1 (2, 3)
        uint32_t pa[BN / 16][4];
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
            const float p0 = ex2(fmaf(s[4 * q], scale_log2, -n0));
            const float p1 = ex2(fmaf(s[4 * q + 1], scale_log2, -n0));
            const float p2 = ex2(fmaf(s[4 * q + 2], scale_log2, -n1));
            const float p3 = ex2(fmaf(s[4 * q + 3], scale_log2, -n1));
            s0 += p0 + p1;
            s1 += p2 + p3;
            pa[q >> 1][2 * (q & 1)] = bf16x2(p0, p1);
            pa[q >> 1][2 * (q & 1) + 1] = bf16x2(p2, p3);
        }
        l0 = l0 * c0 + s0;
        l1 = l1 * c1 + s1;
#pragma unroll
        for (int q = 0; q < DH / 8; ++q) {
            o[4 * q] *= c0;
            o[4 * q + 1] *= c0;
            o[4 * q + 2] *= c1;
            o[4 * q + 3] *= c1;
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
            Wgmma<DH, 1>::run(o, pa[j], desc_sw128_n_major(st + 2 * TILE + j * 2048, TILE));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DH / 2>(o);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, w);
        l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float inv[2] = {1.0f / l0, 1.0f / l1};
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

}  // namespace

// qkv (B, T, 3 H dh) bf16; out (B, T, H dh) bf16; dh must be 72.
extern "C" int dit_attention_bf16(const void* qkv, void* out, int B, int T, int H, int dh,
                                  void* stream)
{
    if (B <= 0 || T <= 0 || H <= 0 || dh != DH) return (int)cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
        cudaError_t err = cudaFuncSetAttribute(dit_attention_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    const dim3 grid((unsigned)((T + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
    dit_attention_kernel<<<grid, THREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, H,
        1.4426950408889634f / sqrtf((float)DH));
    return (int)cudaGetLastError();
}
