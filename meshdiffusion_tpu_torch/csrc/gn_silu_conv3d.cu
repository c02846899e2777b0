// Fused GroupNorm-affine + SiLU + SAME 3x3x3 conv (+ bias), forward only,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel meshdiffusion_tpu/ops/gn_silu_conv.py
// (gn_silu_conv3d_pallas, pallas_call at :171). The GroupNorm statistics are
// reduced beforehand (csrc/gn_stats.cu through ops/groupnorm.py::gn_affine)
// and folded into a per-(batch, channel) affine a, b, so this kernel computes
//
//     y[b,d,h,w,o] = bias[o] + sum_{tap, c} silu(x[b,d',h',w',c] * a[b,c] + b[b,c]) * W[tap, c, o]
//
// over channels-last (NDHWC) x, with zero where (d',h',w') falls outside the
// volume: SAME padding applies AFTER normalize+SiLU, so an outside tap adds 0,
// not silu(b). x is read in bf16 (an fp32 x arrives rounded by the
// statistics pass, which reads it anyway), silu(x*a+b) is computed in fp32
// and stored as a bf16 operand, the sums are fp32, the fp32 bias is added and
// the output is rounded to bf16 once.
//
// What bounds it on the H100: an implicit GEMM with M = B*D*H*W voxels,
// N = O, K = 27*C: 2*M*27*C*O FLOP, from 64^3 x 128 -> 128 (232 GFLOP a call)
// down to 4^3 x 1024 -> 512. From 64^3 to 8^3 the tensor cores bound it
// (989 TFLOP/s bf16); at 4^3 the 14-28 MB of weights do (3.35 TB/s).
//
// Design (one block an SM, persistent over work items; warp-specialised):
// * two consumer warpgroups issue wgmma.mma_async m64nNk16 (N = 128 or 256)
//   with fp32 sums in registers; B comes from shared memory by descriptor
//   (K-major, 128-byte swizzle). A is the normalized input brick in shared
//   memory, and a tap is only an offset into it. Two routes take A (the plan,
//   ops/gn_silu_conv.py _plan, picks one from the shape):
//   - descriptor route (tiling 0 with a 4 x 8 x 8 tile: every O = 128 conv of
//     both presets, 92 % of K3's FLOP). The brick is voxel-major: each
//     8-channel cell of every voxel in one run, 16 bytes a voxel, no swizzle.
//     Then 8 output voxels along w are one contiguous 8 x 16-byte core
//     matrix at any tap, an m64 tile is one depth plane (8 h-rows of 8, the
//     rows BW voxels apart: the descriptor's SBO), the next 8 channels lie
//     cell_vox voxels on (its LBO), and a tap or a k16 step is a start
//     address offset. A comes by descriptor (wgmma SS): no ldmatrix, no A
//     registers, so each consumer keeps the next tap's group in flight
//     behind the current one (wgmma.wait_group 1) and frees a weight stage
//     (and at a chunk's end its brick) one tap later.
//   - register route (every other shape: tilings 1 and 2, a tile narrower
//     than 8 in H or W). Brick rows of 128 bytes, 64 channels a voxel, their
//     16-byte cells XOR-swizzled by the voxel, read into registers by
//     ldmatrix: there a tap's rows are not the 8-row groups at one stride a
//     descriptor needs. A tap's four k16 steps are one wgmma group, issued
//     after all its A fragments are in registers and retired
//     (wgmma.wait_group 0) before the next tap's ldmatrix: ptxas serializes
//     wgmmas whose input registers are written while a group is in flight.
//     The two consumers overlap instead: one's ldmatrix and waits run under
//     the other's products.
// * the producers' first warp streams the weights, one B tile per
//   (tap, 64-channel chunk, N block), through a 4-stage ring with one
//   cp.async.bulk a tile (no tensor map: the tiles are pre-laid contiguous in
//   the swizzled image the descriptor expects, ops/gn_silu_conv.py
//   pack_conv_weights), completing on a full mbarrier; the consumers free a
//   stage through an empty mbarrier once the wgmma group that read it has
//   retired. There is no block-wide barrier in the main loop.
// * the other producer warps build the next chunk's halo'd brick (TD+2) x
//   (TH+2) x (TW+2) x 64 channels into a double-buffered brick (full/empty
//   mbarriers) while the consumers run the current chunk's 27 taps: every
//   16-byte cell of it is copied in by cp.async at once (zero-filled outside
//   the volume), then normalized in place, silu(x*a+b) in fp32 stored as
//   bf16; eight neighbouring threads take the eight cells of one voxel. With
//   its loads one at a time a thread, the brick and not the tensor cores set
//   the pace. Both layouts keep the builder's stores and the consumers' reads
//   free of bank conflicts: the register route by its swizzle (ldmatrix of 8
//   consecutive voxels), the descriptor route by an odd cell_vox (a voxel's 8
//   cells in 8 different bank quads). The descriptor route's builder fences
//   its stores to the async proxy (wgmma reads the brick through it).
// * the register route has one producer warpgroup (its warps 1-3 build the
//   brick; 384 threads), the descriptor route two (warps 1-7; 512 threads):
//   with three warps the brick took longer than the SS products. setmaxnreg
//   moves registers from the producers (72) to the consumers (216, and 184
//   on the descriptor route, which holds no A fragments).
// * three tilings (ops/gn_silu_conv.py _plan): 256 voxels x 128 channels
//   (4x8x8 bricks of 6x10x10, each input element normalized ~2.3x), 128 x 256
//   (4x4x8), and at 4^3 64 x 256 with the two consumers splitting N, so no
//   wgmma row is wasted. When the output tiles alone cannot fill the card, the
//   (chunk, tap) sequence is split into contiguous ranges over blocks (each a
//   contiguous slab of packed weights); the fp32 partials go to a scratch
//   buffer the wrapper keeps, and a second kernel sums them in split order
//   (deterministic, no atomics), adds the bias and rounds to bf16.
//
// * depth-halo mode (lo, hi planes, each 0 or 1): for a rank that holds one
//   depth slab of the grid. The input holds D + lo + hi planes, the slab's
//   own D with its neighbours' boundary planes before and after it, and the
//   kernel writes the D planes of the slab. The brick builder reads output
//   tap plane dd (-1 .. D) from input plane dd + lo, and treats it as inside
//   the volume iff -lo <= dd < D + hi: zero padding applies only where the
//   slab meets the grid's ends, and the halo planes are normalised with the
//   same (whole-grid) a and b as the rest. lo = hi = 0 is the SAME conv.
//
// What holds it now (H100 80GB HBM3, 700 W, CUDA events, K3 alone):
// * descriptor route: (4, 64^3, 128) -> 128 in 1.45 ms, 65 % of its 0.938 ms
//   bound, and (7, 128^3, 128) -> 128 in 21.4 ms, 61 % of 13.13, against the
//   register route's 1.98 and 25.7 ms at the same shapes (bit-equal results).
//   ptxas: 128 registers at launch, no spills, no wgmma serialization. With
//   three brick warps the brick bounded it (the consumers waited for it 43 %
//   of their time, 2.24 ms; without the normalization 1.41 ms), hence the
//   second producer warpgroup; with seven it runs as fast as with no
//   normalization at all, so what holds it is the consumers' own loop: the
//   SS products read A and B from shared memory (6 KB a 64-clock wgmma), and
//   the epilogue does not overlap the next item's products.
// * register route: 168 registers at launch (tiling 2 spills 16 bytes).
//   Ablations of it at (4, 64^3, 128): the per-tap wait_group 0 holds 5-8 %
//   of its time (1.86 ms with wait_group 1, wrong results, against 2.03);
//   ldmatrix itself gives nothing back (A from stale registers: 2.41 ms).
//   Tilings 1 and 2 (O = 256, 512: 8 % of the U-Nets' K3 FLOP) stay on it.
//
// Requirements (checked by the Python wrapper, which also picks the tiling,
// the split and the grid): C % 32 == 0 (a 32-channel tail chunk is zero
// padded), O % 8 == 0, contiguous tensors, 16-byte aligned pointers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace sm90;

constexpr int BK = 64;                // channels a chunk: one 128-byte swizzle row of bf16
constexpr int TAPS = 27;
constexpr int STAGES = 4;             // weight ring
constexpr int CONSUMERS = 2;          // consumer warpgroups
constexpr int BRICK_THREADS = 96;     // the register route's producer warps 1-3
constexpr int ROW_BYTES = BK * 2;     // one brick voxel, one B tile row

// The block's roles by route: the register route has one producer warpgroup
// (384 threads, 168 registers each at launch: 128 * 72 + 256 * 216 = 384 *
// 168), the descriptor route two, so seven warps build the brick (512
// threads, 128 registers each: 256 * 72 + 256 * 184 = 512 * 128).
template <bool DESC>
struct Roles {
    static constexpr int PRODUCER_WGS = DESC ? 2 : 1;
    static constexpr int THREADS = 128 * (CONSUMERS + PRODUCER_WGS);
    static constexpr int BRICK_THREADS = 128 * PRODUCER_WGS - 32;    // every producer warp but the first
    static constexpr int PRODUCER_REGS = 72;
    static constexpr int CONSUMER_REGS = DESC ? 184 : 216;
};

struct Params {
    int B, D, H, W, C, O;             // D: output planes
    int Din, lo, hi;                  // input planes D + lo + hi: lo before the output's first
    int TD, TH, TW;                   // output tile
    int ntd, nth, ntw, tiles;         // tiles a sample, over every sample
    int NB, CK, KS;                   // N blocks, 64-channel chunks, KS = 27 * CK k-steps
    int splits, per, items;           // k-step ranges, their length, work items
};

struct Item {
    int b, d0, h0, w0, nb, split, k0, k1;
};

__device__ __forceinline__ Item decode(const Params& p, int item)
{
    Item it;
    int t = item % p.tiles;
    const int rest = item / p.tiles;
    it.nb = rest % p.NB;
    it.split = rest / p.NB;
    it.w0 = (t % p.ntw) * p.TW; t /= p.ntw;
    it.h0 = (t % p.nth) * p.TH; t /= p.nth;
    it.d0 = (t % p.ntd) * p.TD;
    it.b = t / p.ntd;
    it.k0 = it.split * p.per;
    it.k1 = min(p.KS, it.k0 + p.per);
    return it;
}

// The byte offset of 16-byte cell q8 (channels 8 q8 .. 8 q8 + 7) of brick
// voxel v. Register route: a 128-byte row a voxel, its cells XOR-swizzled by
// the voxel. Descriptor route: the cells voxel-major, cell q8 of every voxel
// in a run of cell_vox 16-byte slots (cell_vox odd: the 8 cells of one voxel
// fall in 8 different bank quads).
template <bool DESC>
__device__ __forceinline__ uint32_t cell_offset(int v, int q8, int cell_vox)
{
    return DESC ? (uint32_t)(q8 * cell_vox + v) << 4 : (uint32_t)(v * ROW_BYTES + ((q8 ^ (v & 7)) << 4));
}

// MW m64 tiles of NW columns a consumer warpgroup; the two consumers split
// M (SPLIT_N false: a block is 2*MW*64 voxels x NW channels) or N (a block
// is MW*64 voxels x 2*NW channels). DESC: the consumers read A from the
// voxel-major brick by descriptor (8 x 8 in H and W, one m64 a depth plane).
template <int MW, int NW, bool SPLIT_N, bool DESC>
__global__ void __launch_bounds__(Roles<DESC>::THREADS, 1)
gn_silu_conv3d_kernel(const bf16* __restrict__ x, const float* __restrict__ ga,
                      const float* __restrict__ gb, const bf16* __restrict__ wp,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      float* __restrict__ partial, const Params p)
{
    constexpr int BN = SPLIT_N ? CONSUMERS * NW : NW;      // channels a block (B tile rows)
    constexpr int STAGE_BYTES = BN * ROW_BYTES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const int BW = p.TW + 2, BH = p.TH + 2;
    const int brick_vox = (p.TD + 2) * BH * BW;
    const int cell_vox = DESC ? brick_vox | 1 : brick_vox;    // a brick is cell_vox * 128 bytes
    const int brick_bytes = cell_vox * ROW_BYTES;
    unsigned char* bricks = ring + STAGES * STAGE_BYTES;
    uint64_t* wfull = reinterpret_cast<uint64_t*>(bricks + 2 * brick_bytes);
    uint64_t* wempty = wfull + STAGES;
    uint64_t* bfull = wempty + STAGES;
    uint64_t* bempty = bfull + 2;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(wfull + s, 1);
            mbar_init(wempty + s, CONSUMERS * 4);
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(bfull + i, Roles<DESC>::BRICK_THREADS);
            mbar_init(bempty + i, CONSUMERS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg >= CONSUMERS) {
        // ------------------------------ producers -----------------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(Roles<DESC>::PRODUCER_REGS));
        const int pt = threadIdx.x - CONSUMERS * 128;
        if (pt == 0) {
            // the weight ring: one bulk copy a (tap, chunk) k-step
            uint32_t q = 0;
            for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
                const Item it = decode(p, item);
                const unsigned char* src = reinterpret_cast<const unsigned char*>(wp)
                    + ((size_t)it.nb * p.KS + it.k0) * STAGE_BYTES;
                for (int kk = it.k0; kk < it.k1; ++kk, ++q, src += STAGE_BYTES) {
                    const int s = q % STAGES;
                    mbar_wait(wempty + s, ((q / STAGES) & 1) ^ 1);
                    mbar_expect_tx(wfull + s, STAGE_BYTES);
                    bulk_g2s(ring + s * STAGE_BYTES, src, STAGE_BYTES, wfull + s);
                }
            }
        } else if (pt >= 32) {
            // the bricks: every raw 16-byte chunk of the chunk's halo'd brick
            // copied in at once (zeros outside the volume), then silu(x*a+b)
            // in place, once per voxel and channel; a thread touches only the
            // chunks it copied, so no barrier is needed between the two
            const int bt = pt - 32;
            const int q8 = bt & 7;                    // this thread's 8-channel group
            constexpr int VSTEP = Roles<DESC>::BRICK_THREADS / 8;   // voxels a pass
            uint32_t n = 0;                           // chunks built
            for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
                const Item it = decode(p, item);
                for (int ck = it.k0 / TAPS; ck <= (it.k1 - 1) / TAPS; ++ck, ++n) {
                    const int buf = n & 1;
                    mbar_wait(bempty + buf, ((n >> 1) & 1) ^ 1);
                    const int c = ck * BK + q8 * 8;
                    const bool live = c < p.C;        // a zero-padded tail chunk
                    unsigned char* brick = bricks + buf * brick_bytes;
                    const uint32_t brick_s = smem_u32(brick);
                    uint64_t inside = 0;              // bit i: this thread's i-th voxel is in the volume
                    {
                        const int v0 = bt >> 3;
                        int bw = v0 % BW, bh = (v0 / BW) % BH, bd = v0 / (BW * BH);
                        for (int v = v0, i = 0; v < brick_vox; v += VSTEP, ++i) {
                            const int dd = it.d0 + bd - 1, hh = it.h0 + bh - 1, ww = it.w0 + bw - 1;
                            const bool in = live && dd >= -p.lo && dd < p.D + p.hi && hh >= 0
                                            && hh < p.H && ww >= 0 && ww < p.W;
                            const bf16* src = in ? x + ((((size_t)it.b * p.Din + dd + p.lo) * p.H + hh)
                                                        * p.W + ww) * p.C + c : x;
                            cp_async16(brick_s + cell_offset<DESC>(v, q8, cell_vox), src, in ? 16 : 0);
                            inside |= (uint64_t)in << i;
                            for (bw += VSTEP; bw >= BW;) {
                                bw -= BW;
                                if (++bh == BH) { bh = 0; ++bd; }
                            }
                        }
                        asm volatile("cp.async.commit_group;\n" ::: "memory");
                    }
                    float av[8], bv[8];
                    if (live) {
                        const float4* pa = reinterpret_cast<const float4*>(ga + (size_t)it.b * p.C + c);
                        const float4* pb = reinterpret_cast<const float4*>(gb + (size_t)it.b * p.C + c);
                        const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
                        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
                        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
                        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
                        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
                    }
                    asm volatile("cp.async.wait_all;\n" ::: "memory");
                    for (int v = bt >> 3, i = 0; v < brick_vox; v += VSTEP, ++i) {
                        if (!((inside >> i) & 1)) continue;      // stays zero
                        uint4* cell = reinterpret_cast<uint4*>(brick + cell_offset<DESC>(v, q8, cell_vox));
                        uint4 raw = *cell;
                        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            const float t = __bfloat162float(e[j]) * av[j] + bv[j];
                            e[j] = __float2bfloat16(__fdividef(t, 1.0f + __expf(-t)));
                        }
                        *cell = raw;
                    }
                    // the consumers' wgmma reads the brick through the async proxy
                    if (DESC) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                    mbar_arrive(bfull + buf);
                }
            }
        }
    } else {
        // ------------------------------ consumers -----------------------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Roles<DESC>::CONSUMER_REGS));
        const int lane = threadIdx.x & 31, warp4 = (threadIdx.x >> 5) & 3;
        const int row0 = SPLIT_N ? 0 : wg * MW * 64;
        const int col0 = SPLIT_N ? wg * NW : 0;
        const int tile_vox = p.TD * p.TH * p.TW;
        const uint32_t ring_s = smem_u32(ring) + col0 * ROW_BYTES;
        const uint32_t bricks_s = smem_u32(bricks);
        uint32_t q = 0, n = 0;               // k-steps consumed, chunks consumed
        for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
            const Item it = decode(p, item);
            float acc[MW][NW / 2];
#pragma unroll
            for (int f = 0; f < MW; ++f)
#pragma unroll
                for (int i = 0; i < NW / 2; ++i) acc[f][i] = 0.0f;
#pragma unroll
            for (int f = 0; f < MW; ++f) fence_regs<NW / 2>(acc[f]);

            int cur_ck = -1, buf = 0;
            uint32_t brick_s = 0;
            if constexpr (DESC) {
                // A by descriptor: m64 tile f is depth plane row0 / 64 + f of
                // the output tile, its 8 h-rows of 8 voxels 8 core matrices
                // BW voxels apart (SBO), the next 8 channels cell_vox voxels
                // on (LBO); a tap or a k16 step is a start-address offset
                const uint32_t lbo = cell_vox * 16, sbo = BW * 16;
                const int plane = (row0 / 64) * BH * BW;
                int held_s = -1, held_buf = -1;   // the previous tap's stage, and its brick if it ended a chunk
                auto release_held = [&]() {       // once the group that read them has retired
                    if (held_s < 0) return;
                    __syncwarp();
                    if (lane == 0) {
                        mbar_arrive(wempty + held_s);
                        if (held_buf >= 0) mbar_arrive(bempty + held_buf);
                    }
                };
                for (int kk = it.k0; kk < it.k1; ++kk, ++q) {
                    const int ck = kk / TAPS, tap = kk - ck * TAPS;
                    if (ck != cur_ck) {
                        cur_ck = ck;
                        buf = n & 1;
                        mbar_wait(bfull + buf, (n >> 1) & 1);
                        brick_s = bricks_s + buf * brick_bytes;
                    }
                    const bool chunk_end = tap == TAPS - 1 || kk == it.k1 - 1;
                    n += chunk_end;
                    const int toff = ((tap / 9) * BH + (tap / 3) % 3) * BW + tap % 3;
                    const uint64_t adesc = desc_none_k_major(brick_s + (plane + toff) * 16, lbo, sbo);
                    const int s = q % STAGES;
                    mbar_wait(wfull + s, (q / STAGES) & 1);
                    const uint64_t bdesc = desc_sw128_k_major(ring_s + s * STAGE_BYTES);
                    // one wgmma group a tap, the previous tap's still in flight
                    wgmma_fence();
#pragma unroll
                    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
                        for (int f = 0; f < MW; ++f)
                            WgmmaSS<NW, 0>::run(acc[f], adesc + f * BH * BW + j * 2 * cell_vox, bdesc + 2 * j);
                    wgmma_commit();
                    wgmma_wait<1>();              // the previous tap's group has retired
                    release_held();
                    held_s = s;
                    held_buf = chunk_end ? buf : -1;
                }
                wgmma_wait<0>();
                release_held();
            } else {
                // the brick voxel of this lane's ldmatrix row in each m64 tile, tap (0,0,0)
                const int hi = lane >> 4;
                int vb[MW];
#pragma unroll
                for (int f = 0; f < MW; ++f) {
                    int r = row0 + f * 64 + warp4 * 16 + (lane & 15);
                    if (r >= tile_vox) r = 0;     // rows past the tile: computed, never stored
                    const int td = r / (p.TH * p.TW), rem = r - td * p.TH * p.TW;
                    const int th = rem / p.TW, tw = rem - th * p.TW;
                    vb[f] = (td * BH + th) * BW + tw;
                }
                uint32_t afr[BK / 16][MW][4];
                for (int kk = it.k0; kk < it.k1; ++kk, ++q) {
                    const int ck = kk / TAPS, tap = kk - ck * TAPS;
                    if (ck != cur_ck) {
                        cur_ck = ck;
                        buf = n & 1;
                        mbar_wait(bfull + buf, (n >> 1) & 1);
                        brick_s = bricks_s + buf * brick_bytes;
                    }
                    // this tap's A fragments: a row offset into the brick
                    const int toff = ((tap / 9) * BH + (tap / 3) % 3) * BW + tap % 3;
#pragma unroll
                    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
                        for (int f = 0; f < MW; ++f) {
                            const int v = vb[f] + toff;
                            ldsm_x4(brick_s + v * ROW_BYTES + (((2 * j + hi) ^ (v & 7)) << 4), afr[j][f]);
                        }
                    if (tap == TAPS - 1 || kk == it.k1 - 1) {   // the brick is no longer read
                        __syncwarp();
                        if (lane == 0) mbar_arrive(bempty + buf);
                        ++n;
                    }
                    const int s = q % STAGES;
                    mbar_wait(wfull + s, (q / STAGES) & 1);
                    __syncwarp();
                    // one wgmma group a tap; no register is written while it runs
                    // (ptxas would serialize the wgmmas), the other consumer
                    // warpgroup's group keeps the tensor cores busy meanwhile
                    const uint64_t desc = desc_sw128_k_major(ring_s + s * STAGE_BYTES);
                    wgmma_fence();
#pragma unroll
                    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
                        for (int f = 0; f < MW; ++f) Wgmma<NW, 0>::run(acc[f], afr[j][f], desc + 2 * j);
                    wgmma_commit();
                    wgmma_wait<0>();
                    __syncwarp();
                    if (lane == 0) mbar_arrive(wempty + s);
                }
            }
#pragma unroll
            for (int f = 0; f < MW; ++f) fence_regs<NW / 2>(acc[f]);

            // epilogue: acc[f][4k + e] holds row (g, g+8 for e >= 2), column
            // 8k + 2t + (e & 1). Row offsets first, then one bias pair a
            // column group for all of the thread's rows.
            const int g = lane >> 2, t4 = lane & 3;
            long long mrow[MW][2];            // the row's output offset, -1 outside the volume
#pragma unroll
            for (int f = 0; f < MW; ++f)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = row0 + f * 64 + warp4 * 16 + g + half * 8;
                    const int td = r / (p.TH * p.TW), rem = r - td * p.TH * p.TW;
                    const int th = rem / p.TW, tw = rem - th * p.TW;
                    const int dd = it.d0 + td, hh = it.h0 + th, ww = it.w0 + tw;
                    mrow[f][half] = (r < tile_vox && dd < p.D && hh < p.H && ww < p.W)
                        ? ((((long long)it.b * p.D + dd) * p.H + hh) * p.W + ww) * p.O : -1;
                }
            const int n0 = it.nb * BN + col0 + 2 * t4;
            float* part = partial == nullptr ? nullptr
                : partial + (long long)it.split * p.B * p.D * p.H * p.W * p.O;
#pragma unroll
            for (int k = 0; k < NW / 8; ++k) {
                const int nn = n0 + k * 8;
                if (nn >= p.O) break;         // O % 8 == 0: the warp's 8 columns are all in or all out
                const float2 bb = part == nullptr ? __ldg(reinterpret_cast<const float2*>(bias + nn))
                                                  : make_float2(0.0f, 0.0f);
#pragma unroll
                for (int f = 0; f < MW; ++f)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        if (mrow[f][half] < 0) continue;
                        const float v0 = acc[f][4 * k + 2 * half] + bb.x;
                        const float v1 = acc[f][4 * k + 2 * half + 1] + bb.y;
                        if (part == nullptr)
                            *reinterpret_cast<__nv_bfloat162*>(out + mrow[f][half] + nn) =
                                __floats2bfloat162_rn(v0, v1);
                        else
                            *reinterpret_cast<float2*>(part + mrow[f][half] + nn) = make_float2(v0, v1);
                    }
            }
        }
    }
}

// Sum the split partials in split order, add the bias, round to bf16; four
// outputs a thread (O % 8 == 0).
__global__ void splitk_reduce_kernel(const float4* __restrict__ partial,
                                     const float* __restrict__ bias,
                                     bf16* __restrict__ out, long long MO4, int O, int splits)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= MO4) return;
    float4 s = __ldg(partial + i);
    for (int z = 1; z < splits; ++z) {
        const float4 v = __ldg(partial + z * MO4 + i);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const int n = (int)((4 * i) % O);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + 4 * i);
    o[0] = __floats2bfloat162_rn(s.x + __ldg(bias + n), s.y + __ldg(bias + n + 1));
    o[1] = __floats2bfloat162_rn(s.z + __ldg(bias + n + 2), s.w + __ldg(bias + n + 3));
}

template <int MW, int NW, bool SPLIT_N, bool DESC>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* out, float* part, const Params& p, int grid, cudaStream_t s)
{
    constexpr int BN = SPLIT_N ? CONSUMERS * NW : NW;
    const int brick_vox = (p.TD + 2) * (p.TH + 2) * (p.TW + 2);
    const int cell_vox = DESC ? brick_vox | 1 : brick_vox;
    const size_t smem = 1024 + (size_t)STAGES * BN * ROW_BYTES + 2 * (size_t)cell_vox * ROW_BYTES
                        + (2 * STAGES + 4) * sizeof(uint64_t);
    auto kernel = gn_silu_conv3d_kernel<MW, NW, SPLIT_N, DESC>;
    static size_t smem_allowed = 0;   // per instantiation; raised on demand
    if (smem > smem_allowed) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
        smem_allowed = smem;
    }
    kernel<<<grid, Roles<DESC>::THREADS, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(out),
        part, p);
    return cudaGetLastError();
}


}  // namespace

// x (B, D + lo + hi, H, W, C) bf16; a, b (B, C) fp32; w the packed
// weights (NB, CK, 27, BN, 64) bf16 in the swizzled image; bias (O,) fp32;
// out (B, D, H, W, O) bf16; partial (splits, M, O) fp32 scratch when
// splits > 1. tiling: 0 = 256 voxels x 128 channels, 1 = 128 x 256,
// 2 = 64 x 256; route: 0 = A from registers, 1 = A by descriptor (tiling 0
// with a 4 x 8 x 8 tile only); (TD, TH, TW) the output tile; grid the
// persistent block count; lo, hi the depth halo (0 0: the SAME conv over D
// planes).
extern "C" int gn_silu_conv3d_bf16(const void* x, const void* a,
                                   const void* b, const void* w, const void* bias,
                                   void* out, void* partial, int B, int D, int H, int W,
                                   int C, int O, int tiling, int route, int TD, int TH, int TW,
                                   int splits, int grid, int lo, int hi, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int BN = tiling == 0 ? 128 : 256;
    if (lo < 0 || lo > 1 || hi < 0 || hi > 1) return (int)cudaErrorInvalidValue;
    if (route != 0 && (route != 1 || tiling != 0 || TD != 4 || TH != 8 || TW != 8))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.B = B; p.D = D; p.H = H; p.W = W; p.C = C; p.O = O;
    p.Din = D + lo + hi; p.lo = lo; p.hi = hi;
    p.TD = TD; p.TH = TH; p.TW = TW;
    p.ntd = (D + TD - 1) / TD; p.nth = (H + TH - 1) / TH; p.ntw = (W + TW - 1) / TW;
    p.tiles = B * p.ntd * p.nth * p.ntw;
    p.NB = (O + BN - 1) / BN;
    p.CK = (C + BK - 1) / BK;
    p.KS = TAPS * p.CK;
    p.per = (p.KS + splits - 1) / splits;
    p.splits = splits;
    p.items = p.tiles * p.NB * splits;
    if ((TD + 2) * (TH + 2) * (TW + 2) > 64 * (BRICK_THREADS / 8))   // a 64-bit mask a thread
        return (int)cudaErrorInvalidValue;
    float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
    cudaError_t err;
    switch (tiling) {
    case 0: err = route ? launch<2, 128, false, true>(x, a, b, w, bias, out, part, p, grid, s)
                        : launch<2, 128, false, false>(x, a, b, w, bias, out, part, p, grid, s); break;
    case 1: err = launch<1, 256, false, false>(x, a, b, w, bias, out, part, p, grid, s); break;
    case 2: err = launch<1, 128, true, false>(x, a, b, w, bias, out, part, p, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || splits == 1) return (int)err;
    const long long MO4 = (long long)B * D * H * W * O / 4;
    splitk_reduce_kernel<<<(unsigned)((MO4 + 255) / 256), 256, 0, s>>>(
        reinterpret_cast<const float4*>(part), static_cast<const float*>(bias),
        static_cast<bf16*>(out), MO4, O, splits);
    return (int)cudaGetLastError();
}

extern "C" const char* mdt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
