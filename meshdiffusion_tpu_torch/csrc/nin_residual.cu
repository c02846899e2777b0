// A ResnetBlock's NIN shortcut and its residual sum in one pass, forward
// only, written for Hopper (sm_90a):
//
//     out[m, n] = (sum_k bf16(x[m, k]) * W[k, n], in fp32) + b[n] + float(h[m, n])
//
// over the voxels m of a channels-last x (M, K), fp32 or bf16, with the bf16
// weight W (K, N), the fp32 bias b (N,), the bf16 h (M, N) and an fp32
// output (M, N). No TPU kernel corresponds: the JAX package computes the
// shortcut as a plain jnp.dot of bf16 operands with fp32 sums plus b, and the
// residual sum after it (meshdiffusion_tpu/models/layers.py:65-67, :275-276).
// The product of two bf16 values is exact in fp32, so the result differs
// from the plain version only in the order of the sum over k.
//
// What bounds it on the H100: memory. K is 128 to 1024 and N 128 to 512, at
// most ~60 operations a byte against the card's ~295 at its ridge. x and h
// are read once, the output written once; W (at most 1 MiB) comes from L2
// after the first blocks.
//
// Design: one warpgroup a block, a tile of 64 voxels by 128 output
// channels (a wider output: its N tiles of a row tile launched side by
// side, so that all but the first read x from L2). A 3-stage cp.async ring
// over K in 64-deep chunks: the x chunk as it is stored (rows of 256 bytes
// fp32 or 128 bf16), the W chunk as two blocks of 64 k-rows x 128 bytes (64
// columns), both with their 16-byte cells XOR-swizzled by the row. A comes
// from registers: ldmatrix for a bf16 x; for an fp32 x each thread reads
// its fragment's pairs and rounds them to bf16 (to nearest even, as
// .to(torch.bfloat16) does). B comes from shared memory by descriptor,
// N-major (W's own layout) with the 128-byte swizzle. wgmma m64n128k16 with
// fp32 sums in registers; each chunk's four are one group, retired before
// the next chunk's barrier. The tile's h rows are prefetched into L2 before
// the loop; the epilogue, from registers, adds b and then h, in the plain
// version's order, and stores fp32. No split-K: reruns agree bit for bit.
//
// The tile is the fastest of eight (64 or 128 voxels, 128 or 256 channels,
// 2 to 4 stages) over the shortcuts of a res64 batch-4 and a res128 batch-7
// forward on an H100: two blocks an SM (up to 99 KB of shared memory and
// 156 registers a thread each) keep enough of x in flight, where a wider or
// deeper tile holds one.
//
// Requirements (checked by the Python wrapper): K % 64 == 0, N % 128 == 0,
// contiguous tensors, 16-byte aligned pointers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace sm90;

constexpr int BM = 64;                // voxels a block: one warpgroup's m64
constexpr int BN = 128;               // output channels a block
constexpr int BK = 64;                // k a stage
constexpr int STAGES = 3;             // the ring: two chunks in flight while one is multiplied
constexpr int THREADS = 128;
constexpr int W_BLOCK = BK * 128;     // one 64-column block of a W chunk, bytes

__device__ __forceinline__ uint32_t bf16x2(float2 v)
{
    __nv_bfloat162 r = __floats2bfloat162_rn(v.x, v.y);
    return *reinterpret_cast<uint32_t*>(&r);
}

template <typename XT>
__global__ void __launch_bounds__(THREADS, 1)
nin_residual_kernel(const XT* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, const bf16* __restrict__ h,
                    float* __restrict__ out, int M, int K, int N)
{
    constexpr int X_ROW = BK * (int)sizeof(XT);     // bytes of a voxel's chunk: 256 or 128
    constexpr int X_CELLS = X_ROW / 16;
    constexpr int X_BYTES = BM * X_ROW;
    constexpr int STAGE_BYTES = X_BYTES + BK * BN * 2;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t smem_s = smem_u32(smem);

    const int nt = N / BN;
    const long long m0 = (long long)(blockIdx.x / nt) * BM;
    const int n0 = (blockIdx.x % nt) * BN;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int chunks = K / BK;

    // chunk kc of x and W into stage s; rows past M are zero-filled
    auto load = [&](int kc, int s) {
        const uint32_t xs = smem_s + s * STAGE_BYTES, ws = xs + X_BYTES;
#pragma unroll
        for (int i = tid; i < BM * X_CELLS; i += THREADS) {
            const int r = i / X_CELLS, c = i % X_CELLS;
            const bool live = m0 + r < M;
            const XT* src = x + (live ? (m0 + r) * K + kc * BK : 0) + c * (16 / (int)sizeof(XT));
            cp_async16(xs + r * X_ROW + ((c ^ (r & 7)) << 4), src, live ? 16 : 0);
        }
#pragma unroll
        for (int i = tid; i < BK * BN / 8; i += THREADS) {
            const int k = i / (BN / 8), c = i % (BN / 8);
            const bf16* src = w + (long long)(kc * BK + k) * N + n0 + c * 8;
            cp_async16(ws + (c >> 3) * W_BLOCK + k * 128 + (((c & 7) ^ (k & 7)) << 4), src, 16);
        }
    };

    // the tile's h rows into L2 now, so that the epilogue does not wait on DRAM
    for (int i = tid; i < BM * BN / 64; i += THREADS) {
        const long long m = m0 + i / (BN / 64);
        if (m < M)
            asm volatile("prefetch.global.L2 [%0];\n" :: "l"(h + m * N + n0 + (i % (BN / 64)) * 64));
    }

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    fence_regs<BN / 2>(acc);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < chunks) load(s, s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int g = lane >> 2, t4 = lane & 3;
    for (int kc = 0; kc < chunks; ++kc) {
        asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
        // the chunk's cp.async writes, visible to wgmma's reads (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (kc + STAGES - 1 < chunks) load(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
        asm volatile("cp.async.commit_group;\n" ::: "memory");

        const int s = kc % STAGES;
        const uint32_t xs = smem_s + s * STAGE_BYTES, ws = xs + X_BYTES;
        uint32_t afr[BK / 16][4];
        if constexpr (sizeof(XT) == 2) {
            const int r = warp * 16 + (lane & 15), hi = lane >> 4;
#pragma unroll
            for (int j = 0; j < BK / 16; ++j)
                ldsm_x4(xs + r * X_ROW + (((2 * j + hi) ^ (r & 7)) << 4), afr[j]);
        } else {
            // rows g and g + 8 of the warp's 16, k pairs 2 t4 and 2 t4 + 8
            const unsigned char* xp = smem + s * STAGE_BYTES;
#pragma unroll
            for (int j = 0; j < BK / 16; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = warp * 16 + g + (e & 1) * 8, k = 16 * j + 2 * t4 + (e >> 1) * 8;
                    const float2 v = *reinterpret_cast<const float2*>(
                        xp + r * X_ROW + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4);
                    afr[j][e] = bf16x2(v);
                }
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
            Wgmma<BN, 1>::run(acc, afr[j], desc_sw128_n_major(ws + j * 2048, W_BLOCK));
        wgmma_commit();
        wgmma_wait<0>();
    }
    fence_regs<BN / 2>(acc);

    // epilogue: acc[4q + e] holds row g (+ 8 for e >= 2) of the warp's 16,
    // column 8q + 2 t4 + (e & 1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp * 16 + g + half * 8;
        if (m >= M) continue;
        const bf16* hr = h + m * N + n0 + 2 * t4;
        float* orow = out + m * N + n0 + 2 * t4;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * q + 2 * t4));
            const float2 hh = __bfloat1622float2(
                __ldg(reinterpret_cast<const __nv_bfloat162*>(hr + 8 * q)));
            *reinterpret_cast<float2*>(orow + 8 * q) =
                make_float2((acc[4 * q + 2 * half] + bb.x) + hh.x,
                            (acc[4 * q + 2 * half + 1] + bb.y) + hh.y);
        }
    }
}

template <typename XT>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* h, void* out,
                   int M, int K, int N, cudaStream_t s)
{
    const size_t smem = 1024 + (size_t)STAGES * (BM * BK * sizeof(XT) + BK * BN * 2);
    auto kernel = nin_residual_kernel<XT>;
    static size_t smem_allowed = 0;   // per instantiation; raised on demand
    if (smem > smem_allowed) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
        smem_allowed = smem;
    }
    const unsigned grid = (unsigned)((M + BM - 1) / BM) * (unsigned)(N / BN);
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const XT*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
        static_cast<const bf16*>(h), static_cast<float*>(out), M, K, N);
    return cudaGetLastError();
}

}  // namespace

// x (M, K) fp32 (x_bf16 0) or bf16 (1); w (K, N) bf16; bias (N,) fp32;
// h (M, N) bf16; out (M, N) fp32.
extern "C" int nin_residual_bf16(const void* x, int x_bf16, const void* w, const void* bias,
                                 const void* h, void* out, int M, int K, int N, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (M <= 0 || K <= 0 || K % BK || N <= 0 || N % BN) return (int)cudaErrorInvalidValue;
    return (int)(x_bf16 ? launch<bf16>(x, w, bias, h, out, M, K, N, s)
                        : launch<float>(x, w, bias, h, out, M, K, N, s));
}
