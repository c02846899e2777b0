// The rasterizer's per-tile z-min candidate test, every depth layer in one
// launch, forward only.
//
// Replaces the TPU kernel meshdiffusion_tpu/ops/tile_raster.py
// (tile_zmin_pallas, pallas_call at :153). Each 32 x 32 screen tile tests
// the live entries of its binned list and of its view's big-triangle list at
// every pixel centre and keeps the nearest (z, id) above the depth-peel
// floor, for each of L layers; the semantics, tie-break included, are
// written out in ops/tile_zmin.py, whose plain version (tile_zmin_reference)
// this kernel must match to the bit.
//
// What bounds it on the H100: instructions. Of a (candidate, pixel) pair's
// edge functions only the three final differences are per pixel (the
// products are formed once a row or a column, the edge deltas once a
// candidate), and none may be fused (see below); the inside test's six
// compares and their combination run on the ALU pipe at half the fp32 rate
// and set the bound (ops/tile_zmin.py::tile_zmin_cost). The inputs are an
// id list and an L2-resident coords table, the outputs 8 bytes a pixel and
// layer.
//
// Design:
// * one cluster of 4 blocks of 256 threads a tile, clusters launched
//   heaviest tile first (``order``, sorted by the wrapper). A live list of
//   at most 64 candidates is tested by the first block alone (the other
//   three exit at once); a longer one is cut into 4 contiguous ranges, one a
//   block, so that the long tiles (256 candidates of a GT render, 2,500 of a
//   noise-soup mesh) do not set the tail on one SM. After each layer the
//   blocks merge their partial (z, group, id) of every pixel through
//   distributed shared memory, in rank order, and all go on with the same
//   floor;
// * each thread holds a 2 x 2 pixel patch: a staged candidate is read from
//   shared memory once for four pixels, and of each edge function
//   e_x * (py - v_y) - e_y * (px - v_x) the first product is formed once a
//   row and the second once a column;
// * only live slots are read: slots [0, count) of the tile's list, then
//   slots [0, gcount) of the view's global list (slot K + j of the padded
//   layout). Nothing past a count is touched, so the capacities K and Kg
//   cost nothing;
// * staging: each thread stages one candidate of a 256-candidate chunk. It
//   reads the id, copies the nine coords from the view's table straight
//   into the candidate's record with cp.async while the block tests the
//   previous chunk, then completes the record (edge deltas and 1/area; a
//   candidate that cannot win, id < 0 or |area| <= 1e-12, gets a NaN edge
//   delta, which no pixel passes, so the test loop needs no branch on it);
// * three chunk buffers (768 candidates, 51 KB) and the 12 KB of partials:
//   three blocks an SM. A block whose range fits keeps it resident and
//   tests later layers from shared memory; a longer range streams through
//   the buffers as a ring, once a layer;
// * tie-break: candidates come in slot order, so the group rule of the
//   plain version (smallest z in a group of 8 slots, smallest id on a tie,
//   strict < across groups) is the lexicographic minimum of (z, slot / 8,
//   id). In slot order a hit replaces the best if its z is smaller, or
//   equal within the same group with a smaller id; the cluster's merge
//   takes the minimum of the partials over all three keys;
// * layers: a thread keeps its pixels' (z, id) in registers; the next
//   layer's floor is its own z where it hit, else 1e30 (and 1e30 past the
//   image). A pixel whose floor is 1e30 cannot hit, so a thread with four
//   such pixels tests nothing, and a layer no pixel of the tile can hit is
//   skipped. The loop over a chunk's candidates is unrolled by two;
// * every product, sum and quotient goes through __fmul_rn / __fadd_rn /
//   __fsub_rn / __fdiv_rn, in the plain version's order. nvcc would
//   otherwise contract a*b - c*d into an FMA, which rounds the edge
//   functions differently from PyTorch's op-by-op arithmetic and moves
//   pixels that lie exactly on an edge to the neighbouring triangle.
//
// Requirements: coords (B, F, 9) f32, tris (N, K), counts (N,), gtris
// (B, Kg), gcount (B,), order (N,) int32, zfloor (N, 32, 32) f32 or null,
// all contiguous, N = B * tpv (the Python wrapper checks these); counts <=
// K and gcount <= Kg (the wrapper clamps them); every listed id < F (as
// bin_triangles gives them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;
constexpr int PIX = TILE * TILE;
constexpr int THREADS = 256;        // a 2 x 2 pixel patch each
constexpr int PATCHES_X = TILE / 2;
constexpr int CH = THREADS;         // candidates a chunk, one staged by each thread
constexpr int NBUF = 3;             // chunk buffers
constexpr int GROUP = 8;            // tie-break group of slots
constexpr int SPLIT = 4;            // blocks a cluster; a long list is split over them
constexpr int SPLIT_MIN = 64;       // lists longer than this are split
constexpr float BIG = 1e30f;
// a staged candidate: 4 float4 [ax ay bx by][cx cy e0x e0y][e1x e1y e2x e2y]
// [az bz cz 1/area], e0 = c - b, e1 = a - c, e2 = b - a; and its id. Then a
// split tile's partial (z, id, group) of every pixel, read by the cluster.
constexpr size_t SMEM = (size_t)NBUF * CH * (4 * sizeof(float4) + sizeof(int))
                        + (size_t)PIX * (sizeof(float) + 2 * sizeof(int));

struct Params {
    const float* coords;    // (B, F, 9)
    const int* tris;        // (N, K)
    const int* counts;      // (N,)
    const int* gtris;       // (B, Kg)
    const int* gcount;      // (B,)
    const float* zfloor;    // (N, 32, 32), or null: -1e30
    const int* order;       // (N,) tiles, heaviest first
    int* out_tri;           // (L, N, 32, 32)
    float* out_z;           // (L, N, 32, 32)
    int N, F, K, Kg, ntx, tpv, H, W, L;
};

// what one block knows of its tile and its share of the live list
struct Tile {
    const int* list;        // the tile's ids
    const int* glist;       // its view's global ids
    const float* coords;    // its view's coords table
    int count;              // live tile slots; list position p >= count is global p - count
    int lo, hi;             // this block's list positions [lo, hi)
    int K;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}

// Start staging chunk c: this thread's candidate id, its coords copied into
// its record asynchronously. Returns the id (-1 past the range).
__device__ __forceinline__ int stage_issue(const Tile& tl, float4* rec, int c)
{
    const int pos = tl.lo + c * CH + threadIdx.x;
    int id = -1;
    if (pos < tl.hi) {
        id = pos < tl.count ? tl.list[pos] : tl.glist[pos - tl.count];
        if (id >= 0) {
            float* r = reinterpret_cast<float*>(rec + ((c % NBUF) * CH + threadIdx.x) * 4);
            const float* s = tl.coords + (size_t)id * 9;
            cp_async4(r + 0, s + 0);        // ax
            cp_async4(r + 1, s + 1);        // ay
            cp_async4(r + 12, s + 2);       // az
            cp_async4(r + 2, s + 3);        // bx
            cp_async4(r + 3, s + 4);        // by
            cp_async4(r + 13, s + 5);       // bz
            cp_async4(r + 4, s + 6);        // cx
            cp_async4(r + 5, s + 7);        // cy
            cp_async4(r + 14, s + 8);       // cz
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return id;
}

// Finish staging chunk c once this thread's copies have landed: the edge
// deltas, 1/area and the id, -1 where the candidate cannot win.
__device__ __forceinline__ void stage_complete(const Tile& tl, float4* rec, int* s_id, int c,
                                               int id)
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (tl.lo + c * CH + (int)threadIdx.x >= tl.hi)
        return;
    const int i = (c % NBUF) * CH + threadIdx.x;
    if (id >= 0) {
        float* r = reinterpret_cast<float*>(rec + i * 4);
        const float ax = r[0], ay = r[1], bx = r[2], by = r[3], cx = r[4], cy = r[5];
        const float area = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                                     __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
        const bool ok = fabsf(area) > 1e-12f;
        // a dead candidate gets e0x = NaN: every w0 is NaN, no pixel inside
        rec[i * 4 + 1] = make_float4(cx, cy, ok ? __fsub_rn(cx, bx) : __int_as_float(0x7fc00000),
                                     __fsub_rn(cy, by));
        rec[i * 4 + 2] = make_float4(__fsub_rn(ax, cx), __fsub_rn(ay, cy),
                                     __fsub_rn(bx, ax), __fsub_rn(by, ay));
        r[15] = __fdiv_rn(1.0f, ok ? area : 1.0f);
    } else {
        reinterpret_cast<float*>(rec + i * 4)[6] = __int_as_float(0x7fc00000);
    }
    s_id[i] = id;
}

// Test chunk c against this thread's 2 x 2 pixels (pixel k at row k / 2,
// column k % 2), updating the running (z, id, group) of each.
__device__ __forceinline__ void test_chunk(const Tile& tl, const float4* rec, const int* s_id,
                                           int c, const float (&px)[2], const float (&py)[2],
                                           const float (&zf)[4], float (&bz)[4], int (&bt)[4],
                                           int (&bg)[4])
{
    const int base = (c % NBUF) * CH;
    const int n = min(CH, tl.hi - tl.lo - c * CH);
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
        const float4 v0 = rec[(base + j) * 4 + 0];     // ax ay bx by
        const float4 v1 = rec[(base + j) * 4 + 1];     // cx cy e0x e0y
        const float4 v2 = rec[(base + j) * 4 + 2];     // e1x e1y e2x e2y
        // w0 = (cx-bx)*(py-by) - (cy-by)*(px-bx), w1 = (ax-cx)*(py-cy) -
        // (ay-cy)*(px-cx), w2 = (bx-ax)*(py-ay) - (by-ay)*(px-ax)
        float r0[2], r1[2], r2[2], q0[2], q1[2], q2[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            r0[i] = __fmul_rn(v1.z, __fsub_rn(py[i], v0.w));
            r1[i] = __fmul_rn(v2.x, __fsub_rn(py[i], v1.y));
            r2[i] = __fmul_rn(v2.z, __fsub_rn(py[i], v0.y));
            q0[i] = __fmul_rn(v1.w, __fsub_rn(px[i], v0.z));
            q1[i] = __fmul_rn(v2.y, __fsub_rn(px[i], v1.x));
            q2[i] = __fmul_rn(v2.w, __fsub_rn(px[i], v0.x));
        }
        float w0[4], w1[4];
        bool in[4];
        bool any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            w0[k] = __fsub_rn(r0[k >> 1], q0[k & 1]);
            w1[k] = __fsub_rn(r1[k >> 1], q1[k & 1]);
            const float w2 = __fsub_rn(r2[k >> 1], q2[k & 1]);
            in[k] = (w0[k] >= 0.0f && w1[k] >= 0.0f && w2 >= 0.0f)
                    || (w0[k] <= 0.0f && w1[k] <= 0.0f && w2 <= 0.0f);
            any |= in[k];
        }
        if (!any)
            continue;
        const float4 v3 = rec[(base + j) * 4 + 3];     // az bz cz 1/area
        const int id = s_id[base + j];
        const int pos = tl.lo + c * CH + j;
        const int grp = (pos < tl.count ? pos : tl.K + pos - tl.count) / GROUP;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (!in[k])
                continue;
            const float l0 = __fmul_rn(w0[k], v3.w);
            const float l1 = __fmul_rn(w1[k], v3.w);
            // z = l0*az + l1*bz + (1 - l0 - l1)*cz, left to right
            const float z = __fadd_rn(__fadd_rn(__fmul_rn(l0, v3.x), __fmul_rn(l1, v3.y)),
                                      __fmul_rn(__fsub_rn(__fsub_rn(1.0f, l0), l1), v3.z));
            if (z > zf[k] && z >= -1.0f && z <= 1.0f
                    && (z < bz[k] || (z == bz[k] && grp == bg[k] && id < bt[k]))) {
                bz[k] = z;
                bt[k] = id;
                bg[k] = grp;
            }
        }
    }
}

// One cluster of SPLIT blocks a tile, clusters launched heaviest tile first.
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 3)
tile_zmin_kernel(const Params p)
{
    extern __shared__ float4 smem[];
    float4* rec = smem;                                           // [NBUF * CH][4]
    int* s_id = reinterpret_cast<int*>(smem + NBUF * CH * 4);     // [NBUF * CH]
    float* s_pz = reinterpret_cast<float*>(s_id + NBUF * CH);     // [PIX] partials
    int* s_pt = reinterpret_cast<int*>(s_pz + PIX);
    int* s_pg = s_pt + PIX;

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int t = p.order[blockIdx.x / SPLIT];
    const int b = t / p.tpv, local = t % p.tpv;
    Tile tl;
    tl.list = p.tris + (size_t)t * p.K;
    tl.glist = p.gtris + (size_t)b * p.Kg;
    tl.coords = p.coords + (size_t)b * p.F * 9;
    tl.count = p.counts[t];
    tl.K = p.K;
    const int total = tl.count + p.gcount[b];
    // every block of the cluster reads the same total, so they agree on it
    const bool split = total > SPLIT_MIN;
    if (!split && rank != 0)
        return;                     // one block tests a short list; no cluster barrier follows
    tl.lo = split ? (int)((long long)total * rank / SPLIT) : 0;
    tl.hi = split ? (int)((long long)total * (rank + 1) / SPLIT) : total;
    const int nch = (tl.hi - tl.lo + CH - 1) / CH;
    const bool resident = nch <= NBUF;

    // the patch: top-left pixel (x0, y0) in the view, offset lp in the tile
    const int lx = (threadIdx.x % PATCHES_X) * 2, ly = (threadIdx.x / PATCHES_X) * 2;
    const int lp = ly * TILE + lx;
    const int x0 = (local % p.ntx) * TILE + lx, y0 = (local / p.ntx) * TILE + ly;
    const float px[2] = {(float)x0 + 0.5f, (float)(x0 + 1) + 0.5f};
    const float py[2] = {(float)y0 + 0.5f, (float)(y0 + 1) + 0.5f};

    float zf[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int o = lp + (k >> 1) * TILE + (k & 1);
        zf[k] = __fadd_rn(p.zfloor ? p.zfloor[(size_t)t * PIX + o] : -BIG, 1e-7f);
    }

    bool staged = false;            // a resident range is in shared memory
    for (int layer = 0; layer < p.L; ++layer) {
        float bz[4] = {BIG, BIG, BIG, BIG};
        int bt[4] = {-1, -1, -1, -1};
        int bg[4] = {-1, -1, -1, -1};
        // a floor of 1e30 (+ 1e-7, still 1e30) admits no z <= 1; the floors
        // are the same in every block of a split tile, so is this test
        const bool active = zf[0] < BIG || zf[1] < BIG || zf[2] < BIG || zf[3] < BIG;
        if (__syncthreads_or(active)) {
            if (nch > 0) {
                const bool stage = !(resident && staged);
                if (stage) {
                    const int id = stage_issue(tl, rec, 0);
                    stage_complete(tl, rec, s_id, 0, id);
                    __syncthreads();
                }
                for (int c = 0; c < nch; ++c) {
                    const bool next = stage && c + 1 < nch;     // uniform in the block
                    const int id = next ? stage_issue(tl, rec, c + 1) : -1;
                    if (active)
                        test_chunk(tl, rec, s_id, c, px, py, zf, bz, bt, bg);
                    if (next) {
                        stage_complete(tl, rec, s_id, c + 1, id);
                        __syncthreads();
                    }
                }
                staged = true;
            }
            if (split) {
                // the lexicographic minimum of (z, group, id) over the
                // cluster's partials, in rank order: the same in every block
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int o = lp + (k >> 1) * TILE + (k & 1);
                    s_pz[o] = bz[k];
                    s_pt[o] = bt[k];
                    s_pg[o] = bg[k];
                }
                cluster.sync();
                for (int r = 0; r < SPLIT; ++r) {
                    const float* rz = cluster.map_shared_rank(s_pz, r);
                    const int* rt = cluster.map_shared_rank(s_pt, r);
                    const int* rg = cluster.map_shared_rank(s_pg, r);
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int o = lp + (k >> 1) * TILE + (k & 1);
                        const float z = rz[o];
                        const int g = rg[o], id = rt[o];
                        if (z < bz[k]
                                || (z == bz[k] && (g < bg[k] || (g == bg[k] && id < bt[k])))) {
                            bz[k] = z;
                            bt[k] = id;
                            bg[k] = g;
                        }
                    }
                }
                cluster.sync();     // every partial read before it is rewritten, or its block exits
            }
        }
        if (rank == 0) {
            const size_t o = ((size_t)layer * p.N + t) * PIX + lp;
            *reinterpret_cast<int2*>(p.out_tri + o) = make_int2(bt[0], bt[1]);
            *reinterpret_cast<int2*>(p.out_tri + o + TILE) = make_int2(bt[2], bt[3]);
            *reinterpret_cast<float2*>(p.out_z + o) = make_float2(bz[0], bz[1]);
            *reinterpret_cast<float2*>(p.out_z + o + TILE) = make_float2(bz[2], bz[3]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const bool in_image = x0 + (k & 1) < p.W && y0 + (k >> 1) < p.H;
            zf[k] = __fadd_rn(in_image ? bz[k] : BIG, 1e-7f);
        }
    }
}

}  // namespace

// See Params for the layouts. One cluster a tile, every layer in one launch.
extern "C" int tile_zmin(const void* coords, const void* tris, const void* counts,
                         const void* gtris, const void* gcount, const void* zfloor,
                         const void* order, void* out_tri, void* out_z, int N, int F, int K,
                         int Kg, int ntx, int tpv, int H, int W, int L, void* stream)
{
    static bool smem_allowed = false;     // set at the first launch
    if (!smem_allowed) {
        cudaError_t err = cudaFuncSetAttribute(tile_zmin_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)SMEM);
        if (err != cudaSuccess)
            return (int)err;
        smem_allowed = true;
    }
    Params p;
    p.coords = static_cast<const float*>(coords);
    p.tris = static_cast<const int*>(tris);
    p.counts = static_cast<const int*>(counts);
    p.gtris = static_cast<const int*>(gtris);
    p.gcount = static_cast<const int*>(gcount);
    p.zfloor = static_cast<const float*>(zfloor);
    p.order = static_cast<const int*>(order);
    p.out_tri = static_cast<int*>(out_tri);
    p.out_z = static_cast<float*>(out_z);
    p.N = N; p.F = F; p.K = K; p.Kg = Kg; p.ntx = ntx; p.tpv = tpv; p.H = H; p.W = W; p.L = L;
    tile_zmin_kernel<<<N * SPLIT, THREADS, SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}
