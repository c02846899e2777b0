// GroupNorm statistics folded into a per-(sample, channel) affine, in one
// launch.
//
// Replaces the statistics phase of the TPU kernel
// meshdiffusion_tpu/ops/groupnorm.py (fused_groupnorm_silu, pallas_call at
// :114), which carries its sums in scratch memory from one grid step to the
// next. Given channels-last x (B, S, C), GroupNorm scale and bias (C,), it
// writes fp32 a, b (B, C) with GroupNorm(x) = x * a + b:
//
//     a[b,c] = scale[c] / sqrt(var[b,g] + eps),  b[b,c] = bias[c] - mean[b,g] * a[b,c]
//
// with the fp32 mean and (biased) variance of each (sample, group). Given
// an fp32 x and an output xb, it also writes x rounded to bf16 into xb as it
// reads x: the conv kernel (csrc/gn_silu_conv3d.cu) streams its operand in
// bf16, and taking the rounding here spares it a second fp32 read.
//
// What bounds it on the H100: reading x once (3.35 TB/s). At the U-Net's
// 16^3 and smaller levels that read takes under 4 us, so the launch itself
// sets the time, which is why this is one launch and not two.
//
// Design: a block owns R rows x CC channels of one sample (CC a multiple of 8
// and of the group width). Each thread reads 8 channels with 16-byte loads
// and keeps a per-channel Welford (count, mean, M2) over its rows; the block
// merges its threads' triples per channel, then the channels of each group,
// with Chan's formula in a fixed order. When one block covers every row of
// its channels (the small levels) it writes a and b itself. Otherwise it
// writes its per-group (mean, M2) to a workspace, fences, and takes a ticket
// from a global counter; the block that draws the last ticket merges every
// block's pair (at most 256 blocks a sample: several threads a group, each
// over a fixed slice of the blocks, then the slices in order), writes a and
// b, and resets the counter for the next launch. The result does not depend
// on which block finishes last, so it is deterministic, needs no memset, and
// takes one launch. CUDA and not Triton:
// the last-block merge needs an explicit fence and ticket.
//
// Moments mode (given an output `moments` (B, G, 2)): the same passes, but
// the merged fp32 (mean, M2) of each (sample, group) is written instead of
// a and b: M2 the sum of squared deviations from the mean over the
// (sample, group)'s S * C / G elements. A rank that holds one depth slab
// of a grid computes its slab's moments so; the slabs' moments are then
// merged across ranks (ops/groupnorm.py merge_moments) and folded into a
// and b (affine_from_moments), so that every slab is normalised with the
// whole grid's statistics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Round 8 fp32 values to bf16 and store them (16 bytes).
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* p, const float* v)
{
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

template <typename T> struct Load8;
template <> struct Load8<float> {
    static __device__ __forceinline__ void get(const float* p, float* v) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    }
};
template <> struct Load8<__nv_bfloat16> {
    static __device__ __forceinline__ void get(const __nv_bfloat16* p, float* v) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
    }
};
template <> struct Load8<__half> {
    static __device__ __forceinline__ void get(const __half* p, float* v) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const __half* e = reinterpret_cast<const __half*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __half2float(e[j]);
    }
};

// (n, mean, m2) <- (n, mean, m2) + (nb, mb, m2b), Chan's formula
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb, float m2b)
{
    const float t = n + nb;
    if (t == 0.0f) return;
    const float d = mb - mean;
    const float w = nb / t;
    mean += d * w;
    m2 += m2b + d * d * n * w;
    n = t;
}

// a and b of channel c from its group's mean and 1/std
__device__ __forceinline__ void write_affine(const float* scale, const float* bias, float* ga,
                                             float* gb, int b, int C, int c, float mean, float rstd)
{
    const float a = rstd * __ldg(scale + c);
    ga[(size_t)b * C + c] = a;
    gb[(size_t)b * C + c] = __ldg(bias + c) - mean * a;
}

// grid (NBr, C / CC, B); block THREADS
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ ga, float* __restrict__ gb,
                float* __restrict__ work, unsigned int* __restrict__ ticket,
                __nv_bfloat16* __restrict__ xb, float* __restrict__ moments, int S, int C, int G,
                int CC, int R, float eps)
{
    __shared__ float s_mean[2048], s_m2[2048];   // (row lane, channel): RP * CC <= 2048
    __shared__ float s_n[THREADS];
    __shared__ float s_gmean[THREADS], s_grstd[THREADS];   // a group's mean, 1/std
    __shared__ bool s_last;
    const int NBr = gridDim.x, rb = blockIdx.x, cc = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int TPR = CC / 8, RP = THREADS / TPR;   // threads a row, rows in parallel
    const int gw = C / G;
    const int r_lo = rb * R, r_hi = min(S, r_lo + R);

    // per-thread Welford over rows r_lo + lane_r, + RP, ...
    if (tid < RP * TPR) {
        const int lr = tid / TPR, ch = (tid - lr * TPR) * 8;
        const size_t base = ((size_t)b * S) * C + (size_t)cc * CC + ch;
        const T* px = x + base;
        float n = 0.0f, mean[8], m2[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) mean[j] = m2[j] = 0.0f;
        int r = r_lo + lr;
        for (; r + 3 * RP < r_hi; r += 4 * RP) {      // four rows in flight
            float v[4][8];
#pragma unroll
            for (int u = 0; u < 4; ++u) Load8<T>::get(px + (size_t)(r + u * RP) * C, v[u]);
            if (xb != nullptr) {
#pragma unroll
                for (int u = 0; u < 4; ++u) store8_bf16(xb + base + (size_t)(r + u * RP) * C, v[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                n += 1.0f;
                const float inv = 1.0f / n;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float d = v[u][j] - mean[j];
                    mean[j] += d * inv;
                    m2[j] += d * (v[u][j] - mean[j]);
                }
            }
        }
        for (; r < r_hi; r += RP) {
            float v[8];
            Load8<T>::get(px + (size_t)r * C, v);
            if (xb != nullptr) store8_bf16(xb + base + (size_t)r * C, v);
            n += 1.0f;
            const float inv = 1.0f / n;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float d = v[j] - mean[j];
                mean[j] += d * inv;
                m2[j] += d * (v[j] - mean[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            s_mean[lr * CC + ch + j] = mean[j];
            s_m2[lr * CC + ch + j] = m2[j];
        }
        if (ch == 0) s_n[lr] = n;
    }
    __syncthreads();

    // merge the row lanes of each channel, in lane order
    float cn = 0.0f, cmean = 0.0f, cm2 = 0.0f;
    if (tid < CC) {
        for (int lr = 0; lr < RP; ++lr) chan(cn, cmean, cm2, s_n[lr], s_mean[lr * CC + tid], s_m2[lr * CC + tid]);
    }
    __syncthreads();
    if (tid < CC) {
        s_mean[tid] = cmean;
        s_m2[tid] = cm2;
    }
    __syncthreads();

    // merge the channels of each group (equal counts), in channel order
    const int groups = CC / gw;
    const float rows = (float)(r_hi - r_lo);
    if (tid < groups) {
        const int c0 = tid * gw;
        float mean = 0.0f;
        for (int c = 0; c < gw; ++c) mean += s_mean[c0 + c];
        mean /= (float)gw;
        float m2 = 0.0f;
        for (int c = 0; c < gw; ++c) {
            const float d = s_mean[c0 + c] - mean;
            m2 += s_m2[c0 + c] + rows * d * d;
        }
        const int g = cc * groups + tid;
        if (NBr == 1 && moments != nullptr) {
            moments[((size_t)b * G + g) * 2] = mean;
            moments[((size_t)b * G + g) * 2 + 1] = m2;
        } else if (NBr == 1) {
            s_gmean[tid] = mean;
            s_grstd[tid] = 1.0f / sqrtf(m2 / (rows * gw) + eps);
        } else {
            float* wk = work + (((size_t)b * NBr + rb) * G + g) * 2;
            wk[0] = mean;
            wk[1] = m2;
        }
    }
    if (NBr == 1) {           // one block covers these channels: a and b, a thread a channel
        if (moments != nullptr) return;
        __syncthreads();
        if (tid < CC) write_affine(scale, bias, ga, gb, b, C, cc * CC + tid, s_gmean[tid / gw], s_grstd[tid / gw]);
        return;
    }

    // the last block to finish merges every block's pairs
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const unsigned int total = gridDim.x * gridDim.y * gridDim.z;
        s_last = atomicAdd(ticket, 1u) == total - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // ks threads a (sample, group) pair, each over every ks-th block with
    // eight loads in flight, then the ks partial merges in slice order
    const int P = gridDim.z * G;
    const int ks = max(1, min(32, THREADS / P)), npr = THREADS / ks;
    for (int base = 0; base < P; base += npr) {
        const int pl = tid % npr, slice = tid / npr, pair = base + pl;
        const int pb = pair / G, g = pair - pb * G;
        float n = 0.0f, mean = 0.0f, m2 = 0.0f;
        if (pair < P) {
            for (int k = slice; k < NBr; k += 8 * ks) {
                float2 v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int kk = k + u * ks;
                    v[u] = kk < NBr ? __ldcg(reinterpret_cast<const float2*>(
                                          work + (((size_t)pb * NBr + kk) * G + g) * 2))
                                    : make_float2(0.0f, 0.0f);
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int kk = k + u * ks;
                    if (kk < NBr) chan(n, mean, m2, (float)(min(S, (kk + 1) * R) - kk * R) * gw, v[u].x, v[u].y);
                }
            }
        }
        s_n[tid] = n;
        s_mean[tid] = mean;
        s_m2[tid] = m2;
        __syncthreads();
        if (slice == 0 && pair < P) {
            for (int sl = 1; sl < ks; ++sl)
                chan(n, mean, m2, s_n[sl * npr + pl], s_mean[sl * npr + pl], s_m2[sl * npr + pl]);
            if (moments != nullptr) {
                moments[(size_t)pair * 2] = mean;
                moments[(size_t)pair * 2 + 1] = m2;
            }
            s_gmean[pl] = mean;
            s_grstd[pl] = 1.0f / sqrtf(m2 / n + eps);
        }
        __syncthreads();
        // a and b of the round's pairs' channels, a thread a channel
        const int np = moments != nullptr ? 0 : min(npr, P - base);
        for (int i = tid; i < np * gw; i += THREADS) {
            const int q = base + i / gw;
            write_affine(scale, bias, ga, gb, q / G, C, (q % G) * gw + i % gw, s_gmean[i / gw], s_grstd[i / gw]);
        }
        __syncthreads();
    }
    if (tid == 0) *ticket = 0u;
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* a, void* b,
                   void* work, void* ticket, void* xb, void* moments, int B, int S, int C, int G,
                   int CC, int R, float eps, cudaStream_t s)
{
    const dim3 grid((unsigned)((S + R - 1) / R), (unsigned)(C / CC), (unsigned)B);
    gn_stats_kernel<T><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(a), static_cast<float*>(b), static_cast<float*>(work),
        static_cast<unsigned int*>(ticket), static_cast<__nv_bfloat16*>(xb),
        static_cast<float*>(moments), S, C, G, CC, R, eps);
    return cudaGetLastError();
}

}  // namespace

// x (B, S, C) contiguous, dtype 0 fp32 / 1 bf16 / 2 fp16; scale, bias (C,)
// fp32; a, b (B, C) fp32 out; work (B, ceil(S / R), G, 2) fp32 scratch and
// ticket one uint32 that is 0 between launches (both unused when R >= S);
// xb (B, S, C) bf16, x rounded, written when not null (fp32 x only).
// moments (B, G, 2) fp32 (mean, M2): when not null, written in the place of
// a and b (scale, bias, a and b then unused, and may be null).
// CC: channels a block (a multiple of 8 and of C / G, dividing C, at most
// 256); R: rows a block.
extern "C" int gn_stats(const void* x, int dtype, const void* scale, const void* bias, void* a,
                        void* b, void* work, void* ticket, void* xb, void* moments, int B, int S,
                        int C, int G, int CC, int R, float eps, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (xb != nullptr && dtype != 0) return (int)cudaErrorInvalidValue;
    switch (dtype) {
    case 0: return (int)launch<float>(x, scale, bias, a, b, work, ticket, xb, moments, B, S, C, G, CC, R, eps, s);
    case 1: return (int)launch<__nv_bfloat16>(x, scale, bias, a, b, work, ticket, xb, moments, B, S, C, G, CC, R, eps, s);
    case 2: return (int)launch<__half>(x, scale, bias, a, b, work, ticket, xb, moments, B, S, C, G, CC, R, eps, s);
    default: return (int)cudaErrorInvalidValue;
    }
}
