// FLUX's QK normalisation and 3-axis rotary positions, forward only, written
// for Hopper (sm_90a), one launch a transformer block:
//
//     q'[h] = rope(q[h] * rsqrt(mean(q[h]^2) + 1e-6) * q_scale, pe[l])
//     k'[h] = rope(k[h] * rsqrt(mean(k[h]^2) + 1e-6) * k_scale, pe[l])
//     v'[h] = v[h]
//
// for every token l of the joint sequence and head h (DH 128), where rope
// turns each adjacent pair (2 i, 2 i + 1) of a head by the angle whose
// cosine and sine are pe[l, i]: out_0 = cos x_0 - sin x_1, out_1 = sin x_0 +
// cos x_1. q, k and v are read where a Linear wrote them, (B, T, stride)
// bf16 rows with q, k and v in the first 3 D columns (DiT's split: q at
// h DH, k at D + h DH, v at 2 D + h DH): in a double-stream block from two
// sources, the txt stream's qkv (rows 0 .. T1 - 1 of the joint sequence, its
// own scales) and the img stream's (rows T1 .., its own scales), each 3 D
// wide; in a single-stream block from one, linear1's 7 D wide output. The
// result is the joint (B, T1 + T2, 3 D) bf16 buffer that dit_attention.cu
// reads in place. No TPU kernel corresponds: the JAX package has no
// transformer.
//
// What bounds it on the H100: bytes. A token row of FLUX-dev is 3 D = 9,216
// values read and written once in bf16 (36 KB) for ~10 FLOP a value: at the
// b4 cell's 18,432 rows, 0.68 GB a call, 0.203 ms at 3.35 TB/s. In plain
// torch the same takes ~10 passes over q and k (fp32 casts, the mean of
// squares, the scale, the rotation's products and sums, the concatenation).
//
// Design: one block of 256 threads a row at a time (a grid-stride loop over
// the B (T1 + T2) rows, at most 8 blocks an SM). A thread takes 8 adjacent
// values (one 16-byte load and store) at a time: 16 threads cover one head,
// so a head's mean of squares is a reduction over 16 lanes by shuffles, and
// a warp (32 threads, 2 heads) never straddles q, k and v, since D is a
// multiple of 2 DH. A thread issues all of a row's loads before it computes
// (up to MAX_VECS in flight). RMS, scale and rotation in fp32, one bf16
// rounding of the result. The rotation's table (T1 + T2, DH / 2) of (cos,
// sin) fp32 pairs is read from L2 (2.4 MB for 4,608 tokens), the scales
// (4 x 128 fp32) likewise.
//
// Requirements (checked by the Python wrapper): DH 128; 16-byte aligned
// sources and output, row strides multiples of 8; 3 D at most 256 x 8 x
// MAX_VECS values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 128;                 // head dimension
constexpr int THREADS = 256;
constexpr int LANES = DH / 8;           // threads a head
constexpr int MAX_VECS = 8;             // 16-byte vectors a thread holds of a row
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float2 unpack(uint32_t u)
{
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi)
{
    __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&r);
}

__global__ void __launch_bounds__(THREADS)
qk_norm_rope_kernel(const bf16* __restrict__ x, int T1, int stride1,
                    const bf16* __restrict__ x2, int stride2,
                    const float* __restrict__ qs1, const float* __restrict__ ks1,
                    const float* __restrict__ qs2, const float* __restrict__ ks2,
                    const float2* __restrict__ pe, bf16* __restrict__ out, long long rows, int L, int D)
{
    const int vecs = 3 * D / 8, qk_vecs = 2 * D / 8;
    const int tid = threadIdx.x;
    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
        const int l = (int)(row % L);
        const long long b = row / L;
        const bool first = l < T1;
        const bf16* src = first ? x + (b * T1 + l) * stride1 : x2 + (b * (L - T1) + (l - T1)) * stride2;
        const float* qs = first ? qs1 : qs2;
        const float* ks = first ? ks1 : ks2;
        bf16* dst = out + row * 3 * D;

        uint4 v[MAX_VECS];
#pragma unroll
        for (int j = 0; j < MAX_VECS; ++j) {
            const int i = tid + j * THREADS;
            if (i < vecs) v[j] = *reinterpret_cast<const uint4*>(src + 8 * i);
        }
#pragma unroll
        for (int j = 0; j < MAX_VECS; ++j) {
            const int i = tid + j * THREADS;
            if (i >= vecs) break;
            if (i >= qk_vecs) {                 // v: copied
                *reinterpret_cast<uint4*>(dst + 8 * i) = v[j];
                continue;
            }
            // q or k: 8 values d0 .. d0 + 7 of one head
            const int d0 = 8 * (i % LANES);
            const float* scale = (i < D / 8 ? qs : ks) + d0;
            const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[j]);
            float f[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 t = unpack(w[e]);
                f[2 * e] = t.x;
                f[2 * e + 1] = t.y;
            }
            float ss = 0.0f;
#pragma unroll
            for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
#pragma unroll
            for (int m = 1; m < LANES; m <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
            const float rrms = rsqrtf(ss * (1.0f / DH) + 1e-6f);
            const float4 sa = *reinterpret_cast<const float4*>(scale);
            const float4 sb = *reinterpret_cast<const float4*>(scale + 4);
            const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
            const float2* rot = pe + (long long)l * (DH / 2) + d0 / 2;
            uint4 o;
            uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 cs = rot[e];
                const float y0 = f[2 * e] * rrms * sc[2 * e];
                const float y1 = f[2 * e + 1] * rrms * sc[2 * e + 1];
                ow[e] = pack(cs.x * y0 - cs.y * y1, cs.y * y0 + cs.x * y1);
            }
            *reinterpret_cast<uint4*>(dst + 8 * i) = o;
        }
    }
}

}  // namespace

// x (B, T1, stride1) bf16 with q, k, v in its first 3 H dh columns; x2 the
// same (B, T2, stride2), or null with T2 0; q/k scales (dh) fp32 each source;
// pe (T1 + T2, dh / 2) (cos, sin) fp32; out (B, T1 + T2, 3 H dh) bf16; dh
// must be 128.
extern "C" int qk_norm_rope_bf16(const void* x, int T1, int stride1, const void* x2, int T2,
                                 int stride2, const void* qs1, const void* ks1, const void* qs2,
                                 const void* ks2, const void* pe, void* out, int B, int H, int dh,
                                 void* stream)
{
    const int D = H * dh;
    if (B <= 0 || T1 <= 0 || T2 < 0 || H <= 0 || dh != DH || 3 * D > 8 * THREADS * MAX_VECS
        || (T2 > 0 && !x2))
        return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int L = T1 + T2;
    const long long rows = (long long)B * L;
    const long long cap = (long long)sms * BLOCKS_PER_SM;
    const int grid = (int)(rows < cap ? rows : cap);
    qk_norm_rope_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), T1, stride1, static_cast<const bf16*>(x2), stride2,
        static_cast<const float*>(qs1), static_cast<const float*>(ks1),
        static_cast<const float*>(T2 > 0 ? qs2 : qs1), static_cast<const float*>(T2 > 0 ? ks2 : ks1),
        static_cast<const float2*>(pe), static_cast<bf16*>(out), rows, L, D);
    return (int)cudaGetLastError();
}
