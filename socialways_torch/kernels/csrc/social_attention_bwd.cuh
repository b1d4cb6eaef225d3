#pragma once

// Social-attention backward for Hopper (sm_90a): the dq and dkv kernels.
//
// Replace the Pallas TPU kernels of socialways_tpu/kernels/social_attention.py
// `_bwd_dq_kernel` (:317-369) and `_bwd_dkv_kernel` (:372-461), driven by
// `_pallas_backward` (:464-591).  The forward (social_attention_fwd.cuh) saved
// the per-row softmax stats (m_i, l_i) and u_j = W3 wh_j [64], c_j = b3 . wh_j.
// For every same-scene pair (i, j), both valid, i != j, the kernels rebuild
//   a1 = relu(W1 feat_ij + b1), a2 = relu(W2 a1 + b2)   (3->32->64)
//   s_ij = a2 . u_j + c_j   (= f_ij . wh_j)
//   a_ij = exp(s_ij - m_i) / max(l_i, 1e-20)
//   ds_ij = a_ij (g_i . h_j - r_i),  r_i = g_i . out_i
// and pull ds_ij back through the pair MLP (df_ij = ds_ij wh_j, so the
// cotangent of a2 is ds_ij u_j) and the pair features:
//   dq  (a block per tile of rows i, all threads over its pairs):
//        dx_i = sum_j d s_ij / d x_i
//   dkv (a block per tile of columns j, all threads over its pairs):
//        dh_j = sum_i a_ij g_i,   dx_j = sum_i d s_ij / d x_j,
//        A_j = sum_i ds_ij a2_ij [64], S_j = sum_i ds_ij,
//        dwh_j = A_j W3 + S_j b3 (= sum_i ds_ij f_ij),
//        one partial sum per block of dW2, db2, dW1, db1;
//   finalize: dW3 = sum_j A_j (x) wh_j, db3 = sum_j S_j wh_j, and the
//        blocks' partials added, parallel over outputs and slices.
// The TPU kernel summed the weight gradients across its sequential grid;
// here the blocks run in parallel, so each keeps its own partial sums and
// the finalize pass adds them: every sum in a fixed order, no atomics, so
// two runs give equal bits.
//
// Design (social_attention_pairs.cuh has the pair machinery both share with
// the forward).  A block owns kTile = 2 agents at a time: query rows in dq
// (one block per tile), columns in dkv (128 blocks at N = 256, at most 528
// in all); each walks tiles with the grid's stride, finds the
// tile's same-scene partners by id tests and takes the pairs in batches of
// 32.  Per batch, in shared memory and registers only, both kernels run
// (the helpers below):
//   layer 1 and the register-tiled layer 2 (4 pairs x 4 outputs a thread);
//   s, then a and ds from g_i . h_j (pair_ds; dq reads g_i from shared
//   memory and h_j, u_j, c_j from device memory, dkv the other way round);
//   dz2 = [z2 > 0] ds u_j, stored transposed (dz2_of, store_dz2);
//   dz1 = [z1 > 0] dz2 W2^T, register-tiled, 4 pairs x 2 outputs (dz1_tile);
//   one thread a pair: gf = W1 dz1 and the feature backward (pair_dx).
// dq forms g_i . h_j one thread a pair, in the plain version's order
// (gh_serial), beside the features; dkv over a half warp (gh_half_warp).
// dq then adds each row's dx_i over the batch, thread t < kTile for tile
// row t in ring order (ascending j), and writes it once per row: one
// launch, no atomics, no scratch.  dkv also sums ds a2 per column, dW2 +=
// a1^T dz2 as a register tile (4 x 4 a thread, 4 pairs a step), db2, dW1,
// db1, A_j, S_j, dh_j and (when asked) dx_j, each in a fixed order; its
// weight-gradient partials live in registers for the block's life and are
// written once, and the finalize is launched as its programmatic dependent
// and waits for it before its first read.  No per-lane arrays of a pair's
// activations in either kernel.
//
// bf16 operands (the _bf16 entries): h, wh and the weights bf16, the
// scores rebuilt with the forward's rounding and its layer-2 + score
// routine (social_attention_pairs.cuh, layer2_scores), so a_ij renormalizes
// exactly against the forward's (m, l).  The bf16 kernels are their own
// (below): dq_mma (a warp a query row; the score and da1 = dz2 W2^T on the
// tensor cores) and dkv_mma (a warp a column, every product on the tensor
// cores), with a finalize of its own.  The relu masks come from the float
// pre-activations; dW2 = a1^T dz2 and dW1 take the rounded a1 and
// features, A_j the rounded a2.  Every cotangent stays float.  JAX's vjp
// rounds some per-tile cotangents to bf16 (the transpose of a bf16 dot
// returns bf16: the cotangents of a2, a1 and the features, and each tile's
// weight-gradient terms); these kernels keep them float, the more exact of
// the two.
//
// Widths.  The narrow kernels (kWide false) take H and F in multiples of
// 16 up to kNarrowWidth = 128 and are the code they were; the wide ones
// (kWide, entries social_attention_bwd_wide*.cu, translation units of
// their own) take any multiple of 16: dq reads g_i from device memory
// instead of staging it and forms g_i . h_j exactly (gh_exact; the bf16 dq
// likewise, over two lanes, gh_wide), dkv
// stages h_j whole up to kStageWidth = 512 columns and above that
// kStageWidth columns at a time (gh_chunked), and keeps dh past the first
// 2 kThreads elements of a tile in the tile's own rows of dh (dh_wide).
//
// Bound on this card: operations.  Per same-scene pair dq does ~4.4k FMA
// (features, 3->32->64 recompute, score, g_i . h_j, the 64->32 and 32->3
// cotangents), dkv ~6.5k (the same plus the dW2 outer product); both are
// f32 FMA work against ~2 KB of bytes a row (bf16: dq's 64->32 and
// dkv's products on the tensor cores, the rest FFMA).  The pair
// intermediates never reach device memory, and pairs outside a scene cost
// one id test.

#include <cuda_runtime.h>

#include <type_traits>

#include "social_attention_pairs.cuh"

namespace {

using namespace sa;

constexpr int kGStride = kNarrowWidth + 16;   // dq's two g_i rows, padded
                                              // so they start in other banks
constexpr int kPartial = kH1 * kH2 + kH2 + kIn * kH1 + kH1;   // 2240
constexpr int kW2Stride = kH2 + 4;         // padded W2 rows
constexpr int kDz2Stride = kBatch + 4;     // dz2^T [kH2][kBatch], padded
constexpr int kDz1Stride = kH1 + 1;        // dz1 [kBatch][kH1], padded
constexpr int kPairGroups = kThreads / 16;
constexpr int kFinThreads = 1024;
constexpr int kGroup = 8;                  // slices added per step of the tree
constexpr int kW3Rows = 4;                 // rows of [dW3; db3] a finalize block
constexpr int kW3Tiles = (kH2 + 1 + kW3Rows - 1) / kW3Rows;
constexpr int kW3Slices = kFinThreads / 16;                 // 64
constexpr int kPartCols = 32;              // partial elements a finalize block
constexpr int kPartSlices = kFinThreads / kPartCols;        // 32
constexpr int kPartBlocks = (kPartial + kPartCols - 1) / kPartCols;
constexpr int kW3RowsM = 2;                // the bf16 finalize's rows a block
constexpr int kW3TilesM = (kH2 + 1 + kW3RowsM - 1) / kW3RowsM;   // 33
static_assert(kW3Slices % kGroup == 0 && kPartSlices % kGroup == 0, "tree");
// W1, b1, b2 and W2 (rows padded to kW2Stride) into shared memory, as float.
template <typename T>
__device__ __forceinline__ void stage_mlp12(const T* w1, const T* b1,
                                            const T* w2, const T* b2,
                                            float* s_w1, float* s_b1,
                                            float* s_w2, float* s_b2) {
    for (int t = threadIdx.x; t < kH1 * kH2 / 4; t += kThreads)
        reinterpret_cast<float4*>(s_w2)[(t / (kH2 / 4)) * (kW2Stride / 4) + t % (kH2 / 4)] =
            ld4(w2, t);
    for (int t = threadIdx.x; t < kH2; t += kThreads) s_b2[t] = ld(b2[t]);
    for (int t = threadIdx.x; t < kIn * kH1; t += kThreads) s_w1[t] = ld(w1[t]);
    for (int t = threadIdx.x; t < kH1; t += kThreads) s_b1[t] = ld(b1[t]);
}

struct PairDs {
    float a, ds;
};

// g_i . h_j over the 16 lanes of a half warp (dkv): lane og = lane & 15
// adds gi[16 q] hj[16 q] (gi, hj point at element og; chunk = H / 16), then
// the 16 partials in a fixed tree.  A pair past the batch gives 0.
__device__ __forceinline__ float gh_half_warp(const float* gi, const float* hj,
                                              const int chunk, const bool act) {
    float gh = 0.f;
    if (act)
        for (int q = 0; q < chunk; ++q) gh = fmaf(gi[16 * q], hj[16 * q], gh);
    return half_warp_sum(gh);
}

// g_i . h_j of this half warp's four pairs (4 pg + i) in the wide dkv when
// H is above kStageWidth: the tile's h_j columns staged kStageWidth at a
// time into s_h (block-wide, every thread calls it), each lane's partial
// carried from chunk to chunk in gh_half_warp's order (d = og + 16 q) and
// then summed in its tree, so the bits are those of one whole stage.
template <typename T>
__device__ __forceinline__ void gh_chunked(
        float (&gh)[4], const T* __restrict__ h, const float* __restrict__ g,
        const int mrow, const int col0, const int n, const int hdim,
        const int nb, const int* s_row, const int* s_slot, float* s_h) {
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int d0 = 0; d0 < hdim; d0 += kStageWidth) {
        const int wd = hdim - d0 < kStageWidth ? hdim - d0 : kStageWidth;
        __syncthreads();         // the chunk before is read
        for (int e = threadIdx.x; e < kTile * wd; e += kThreads) {
            const int c = e / wd, d = e - c * wd;
            s_h[c * kStageWidth + d] =
                col0 + c < n ? ld(h[(size_t)(mrow + col0 + c) * hdim + d0 + d])
                             : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int p = 4 * pg + i;
            if (p < nb) {
                const float* gi = g + (size_t)(mrow + s_row[p]) * hdim + d0 + og;
                const float* hj = s_h + s_slot[p] * kStageWidth + og;
                for (int q = 0; q < wd / 16; ++q)
                    part[i] = fmaf(gi[16 * q], hj[16 * q], part[i]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) gh[i] = half_warp_sum(part[i]);
}

// g_i . h_j by one thread (dq), one FMA after another over d = 0 .. H - 1:
// the order of the plain version's g h^T on the card.  In a row where
// sum_j a_ij (g_i . h_j - r_i) nearly cancels, dx_i is set by how g . h is
// rounded; in this order the kernel's rounding is the plain version's.
// gi 16-byte aligned, hj aligned to 4 elements, H a multiple of 4; bf16
// h_j (the bf16 dq, one lane a pair) is read 8 elements (16 bytes) at a
// time, so hj aligned to 8 and H a multiple of 8.
template <typename T>
__device__ __forceinline__ float gh_serial(const float* gi, const T* hj,
                                           const int hdim) {
    const float4* g4 = reinterpret_cast<const float4*>(gi);
    float gh = 0.f;
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll 4
        for (int q = 0; q < hdim / 4; ++q) {
            const float4 a = g4[q], b = ld4(hj, q);
            gh = fmaf(a.x, b.x, gh);
            gh = fmaf(a.y, b.y, gh);
            gh = fmaf(a.z, b.z, gh);
            gh = fmaf(a.w, b.w, gh);
        }
    } else {
#pragma unroll 2
        for (int q = 0; q < hdim / 8; ++q) {
            const uint4 hv = reinterpret_cast<const uint4*>(hj)[q];
            const float4 a = g4[2 * q], b = g4[2 * q + 1];
            gh = fmaf(a.x, lo_bf16(hv.x), gh);
            gh = fmaf(a.y, hi_bf16(hv.x), gh);
            gh = fmaf(a.z, lo_bf16(hv.y), gh);
            gh = fmaf(a.w, hi_bf16(hv.y), gh);
            gh = fmaf(b.x, lo_bf16(hv.z), gh);
            gh = fmaf(b.y, hi_bf16(hv.z), gh);
            gh = fmaf(b.z, lo_bf16(hv.w), gh);
            gh = fmaf(b.w, hi_bf16(hv.w), gh);
        }
    }
    return gh;
}

// g_i . h_j of the wide dq (H above kNarrowWidth): exact float products
// summed in double, one rounding at the end.  Past 128 a serial float sum
// no longer follows the plain version's cuBLAS order, and on rows where
// dx_i cancels it strayed further from the f64 oracle than the plain
// version does (chip_smoke's dx witness at H = 256); the double sum is the
// correctly rounded dot product up to its last rounding.
template <typename T>
__device__ __forceinline__ float gh_exact(const float* gi, const T* hj,
                                          const int hdim) {
    const float4* g4 = reinterpret_cast<const float4*>(gi);
    double gh = 0.0;
#pragma unroll 4
    for (int q = 0; q < hdim / 4; ++q) {
        const float4 a = g4[q], b = ld4(hj, q);
        gh = fma((double)a.x, (double)b.x, gh);
        gh = fma((double)a.y, (double)b.y, gh);
        gh = fma((double)a.z, (double)b.z, gh);
        gh = fma((double)a.w, (double)b.w, gh);
    }
    return (float)gh;
}

// a_ij and ds_ij of one pair from g_i . h_j, computed by the 16 lanes of a
// half warp: s = a2 . u_j + c_j from this lane's four outputs (a2i,
// u4 = u_j + 4 og).  A pair past the batch (act false) gives a = ds = 0.
// Every lane ends with the same bits.
__device__ __forceinline__ PairDs pair_ds(const float (&a2i)[4],
                                          const float4 u4, const float c,
                                          const float gh, const bool act,
                                          const float m, const float l,
                                          const float r) {
    const float s = half_warp_sum(dot4(a2i, u4)) + c;
    const float a = act ? expf(s - m) / fmaxf(l, 1e-20f) : 0.f;
    return {a, a * (gh - r)};
}

// dz2 = [z2 > 0] ds u_j over this lane's four outputs, written over a2i.
__device__ __forceinline__ void dz2_of(float (&a2i)[4], const float4 u4,
                                       const float ds) {
    const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int o = 0; o < 4; ++o) a2i[o] = a2i[o] > 0.f ? ds * uv[o] : 0.f;
}

// The layer-2 tile's dz2 (pairs 4 pg + i, outputs 4 og + o) into
// dz2^T [kH2][kDz2Stride].
__device__ __forceinline__ void store_dz2(float* s_dz2,
                                          const float (&dz2)[4][4]) {
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
#pragma unroll
    for (int o = 0; o < 4; ++o)
        reinterpret_cast<float4*>(s_dz2 + (4 * og + o) * kDz2Stride)[pg] =
            make_float4(dz2[0][o], dz2[1][o], dz2[2][o], dz2[3][o]);
}

// dz1 [kBatch][kDz1Stride] = [a1 > 0] dz2 W2^T, register-tiled: thread
// (pg, og) takes pairs 4 pg + i and outputs k = og, og + 16, so two float4
// loads of W2 and four of dz2^T feed 32 FMA.
__device__ __forceinline__ void dz1_tile(const float* s_w2,
                                         const float* s_dz2,
                                         const float* s_a1, float* s_dz1) {
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
    float z[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i][0] = z[i][1] = 0.f;
#pragma unroll 4
    for (int o = 0; o < kH2; o += 4) {
        const float4 wa = *reinterpret_cast<const float4*>(s_w2 + og * kW2Stride + o);
        const float4 wb = *reinterpret_cast<const float4*>(s_w2 + (og + 16) * kW2Stride + o);
        const float wav[4] = {wa.x, wa.y, wa.z, wa.w};
        const float wbv[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float4 d = reinterpret_cast<const float4*>(s_dz2 + (o + q) * kDz2Stride)[pg];
            const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                z[i][0] = fmaf(wav[q], dv[i], z[i][0]);
                z[i][1] = fmaf(wbv[q], dv[i], z[i][1]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int p = 4 * pg + i;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            const int k = og + 16 * kk;
            s_dz1[p * kDz1Stride + k] = s_a1[k * kA1Stride + p] > 0.f ? z[i][kk] : 0.f;
        }
    }
}

// One thread, one pair (i, j): gf = W1 dz1 (dz1 = the pair's row) and the
// cotangents of x_i and x_j from it.
__device__ __forceinline__ void pair_dx(const float* s_w1, const float* dz1,
                                        const float4 xi, const float4 xj,
                                        float4& gi, float4& gj) {
    float gf[kIn];
#pragma unroll
    for (int c = 0; c < kIn; ++c) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < kH1; ++k) t = fmaf(s_w1[c * kH1 + k], dz1[k], t);
        gf[c] = t;
    }
    const float vn = speed(xi);
    const Geo q = pair_geo(xi, vn, xj);
    geo_backward(q, xi, vn, gf, gi, gj);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float4* __restrict__ x4, const int* __restrict__ ids,
              const T* __restrict__ h, const float* __restrict__ g,
              const float2* __restrict__ stats, const float* __restrict__ r,
              const float* __restrict__ u, const float* __restrict__ cvec,
              const T* __restrict__ w1, const T* __restrict__ b1,
              const T* __restrict__ w2, const T* __restrict__ b2,
              float4* __restrict__ dx, const int n, const int hdim,
              const int w, const Members ms) {
    // bf16 operands take dq_mma (the specializations below): this body
    // runs for float alone
    static_assert(std::is_same_v<T, float>, "bf16: define SA_BF16_ENTRIES");
    // Static shared memory, bytes: padded W2 8,704 | a1^T 4,608 | dz2^T
    // 9,216 | dz1 4,224 | ring 4,096 | g_i 1,152 | W1, b1, b2, the batch's
    // features, columns, c_j, g_i . h_j and dx_i terms, the tile's stats
    // 2,248: 34,248 in all (under the 48 KB of static shared memory).
    __shared__ __align__(16) float s_w2[kH1 * kW2Stride];
    __shared__ __align__(16) float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];
    __shared__ __align__(16) float s_a1[kH1 * kA1Stride];    // a1^T
    __shared__ __align__(16) float s_dz2[kH2 * kDz2Stride];  // dz2^T
    __shared__ float s_dz1[kBatch * kDz1Stride];
    __shared__ __align__(16) float s_g[kTile * kGStride];    // g_i rows
    __shared__ float s_feat[kIn * kBatch];
    __shared__ float s_c[kBatch], s_gh[kBatch];
    __shared__ int s_col[kBatch], s_slot[kBatch];
    __shared__ float4 s_gi[kBatch];
    __shared__ float4 s_xt[kTile];
    __shared__ float s_m[kTile], s_l[kTile], s_r[kTile];
    __shared__ int s_ring[kRing], s_scan[kWarps];

    // member m's rows: h, g, stats, r, u, c, dx at m N; x4 and ids at m
    // ms.x4, m ms.ids (0 when shared); its weights at m ms.w*
    const int m = member(), mrow = m * n, xrow = m * ms.x4,
              irow = m * ms.ids;
    stage_mlp12(w1 + m * ms.w1, b1 + m * ms.b1, w2 + m * ms.w2,
                b2 + m * ms.b2, s_w1, s_b1, s_w2, s_b2);
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
    const int n_tiles = (n + kTile - 1) / kTile;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row0 = tile * kTile;
        int tile_id[kTile], tile_idx[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            tile_idx[t] = row0 + t;
            tile_id[t] = row0 + t < n ? ids[irow + row0 + t] : -1;
        }
        if (threadIdx.x < kTile) {
            const int i = row0 + threadIdx.x;
            const float2 st = i < n ? stats[mrow + i] : make_float2(0.f, 0.f);
            s_xt[threadIdx.x] = i < n ? x4[xrow + i] : make_float4(0.f, 0.f, 0.f, 0.f);
            s_m[threadIdx.x] = st.x;
            s_l[threadIdx.x] = st.y;
            s_r[threadIdx.x] = i < n ? r[mrow + i] : 0.f;
        }
        // kWide reads the g_i rows from device memory instead (rows past N
        // have no pairs)
        if constexpr (!kWide)
            for (int e = threadIdx.x; e < kTile * hdim; e += kThreads) {
                const int t = e / hdim, d = e - t * hdim;
                s_g[t * kGStride + d] = row0 + t < n ? g[(size_t)(mrow + row0 + t) * hdim + d] : 0.f;
            }
        float4 dxi = make_float4(0.f, 0.f, 0.f, 0.f);   // row t < kTile's sum
        PairRing pr = tile_ring(s_ring, s_scan, row0, n, w);
        __syncthreads();
        while (true) {
            fill_ring(pr, ids, irow, tile_id, tile_idx);
            if (pr.count == 0) break;
            const int nb = pr.count < kBatch ? pr.count : kBatch;
            // warp 0: features, column, slot and c_j of each pair; warp 1:
            // g_i . h_j of each pair; 0 past nb
            if (threadIdx.x < kBatch) {
                const int p = threadIdx.x;
                float f[kIn] = {0.f, 0.f, 0.f};
                int col = 0, slot = 0;
                float cj = 0.f;
                if (p < nb) {
                    const int e = s_ring[(pr.head + p) & (kRing - 1)];
                    col = e / kTile;
                    slot = e - col * kTile;
                    const float4 xi = s_xt[slot];
                    const Geo q = pair_geo(xi, speed(xi), x4[xrow + col]);
                    f[0] = q.feat[0]; f[1] = q.feat[1]; f[2] = q.feat[2];
                    cj = cvec[mrow + col];
                }
#pragma unroll
                for (int c = 0; c < kIn; ++c) s_feat[c * kBatch + p] = rnd<T>(f[c]);
                s_col[p] = col;
                s_slot[p] = slot;
                s_c[p] = cj;
            } else if (threadIdx.x < 2 * kBatch) {
                const int p = threadIdx.x - kBatch;
                float gh = 0.f;
                if (p < nb) {
                    const int e = s_ring[(pr.head + p) & (kRing - 1)];
                    const int col = e / kTile;
                    const int slot = e - col * kTile;
                    if constexpr (kWide)
                        gh = gh_exact(g + (size_t)(mrow + row0 + slot) * hdim,
                                      h + (size_t)(mrow + col) * hdim, hdim);
                    else
                        gh = gh_serial(s_g + slot * kGStride,
                                       h + (size_t)(mrow + col) * hdim, hdim);
                }
                s_gh[p] = gh;
            }
            __syncthreads();
            layer1<T>(s_feat, s_w1, s_b1, s_a1);
            __syncthreads();
            {
                float a2[4][4];
                layer2_tile<T>(s_a1, s_w2, kW2Stride, s_b2, a2);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int p = 4 * pg + i, col = s_col[p], slot = s_slot[p];
                    const float4 u4 = reinterpret_cast<const float4*>(u + (size_t)(mrow + col) * kH2)[og];
                    const PairDs d = pair_ds(a2[i], u4, s_c[p], s_gh[p], p < nb,
                                             s_m[slot], s_l[slot], s_r[slot]);
                    dz2_of(a2[i], u4, d.ds);
                }
                store_dz2(s_dz2, a2);
            }
            __syncthreads();
            dz1_tile(s_w2, s_dz2, s_a1, s_dz1);
            __syncthreads();
            if (threadIdx.x < kBatch) {     // warp 0
                const int p = threadIdx.x;
                float4 gi = make_float4(0.f, 0.f, 0.f, 0.f), gj;
                if (p < nb)
                    pair_dx(s_w1, s_dz1 + p * kDz1Stride, s_xt[s_slot[p]],
                            x4[xrow + s_col[p]], gi, gj);
                s_gi[p] = gi;
                __syncwarp();
                if (p < kTile)
                    for (int q = 0; q < nb; ++q)
                        if (s_slot[q] == p) {
                            const float4 v = s_gi[q];
                            dxi.x += v.x; dxi.y += v.y; dxi.z += v.z; dxi.w += v.w;
                        }
            }
            pr.head = (pr.head + nb) & (kRing - 1);
            pr.count -= nb;
            __syncthreads();     // the batch's shared arrays are free
        }
        if (threadIdx.x < kTile && row0 + (int)threadIdx.x < n) dx[mrow + row0 + threadIdx.x] = dxi;
        __syncthreads();         // s_xt, s_m, s_l, s_r, s_g are the next tile's
    }
}

// W2 [kH1][kH2] (bf16) as the B fragments of da1 = dz2 W2^T (K = kH2, N =
// kH1: B[o][k1] = W2[k1][o], so an o pair is one of W2's 32-bit words), in
// fragment order: entry (ks kN1 + nt) 32 + lane holds lane's (b0, b1) of
// k-step ks and n-tile nt, one 8-byte, conflict-free load a lane.  Every
// thread of a kThreads block calls it.
constexpr int kN1 = kH1 / 8;                      // da1's n-tiles
constexpr int kW2TFrags = (kH2 / 16) * kN1 * 32;  // W2^T's B fragments (uint2)
__device__ __forceinline__ void stage_w2t_frags(const __nv_bfloat16* w2,
                                                uint2* s_w2t) {
    const unsigned* const w = reinterpret_cast<const unsigned*>(w2);
#pragma unroll
    for (int e = threadIdx.x; e < kW2TFrags; e += kThreads) {
        const int lane = e & 31, nt = (e >> 5) % kN1, ks = e / (32 * kN1);
        const unsigned* const row = w + (8 * nt + (lane >> 2)) * (kH2 / 2);
        s_w2t[e] = make_uint2(row[8 * ks + (lane & 3)], row[8 * ks + 4 + (lane & 3)]);
    }
}

// The wide bf16 dq's part of g_i . h_j for lane (p, side): columns 16 q +
// 8 side + e, e < 8, of g_i (the row in device memory, as the float wide
// dq reads it) and of hj (16 bytes of h_j a step).  A float times a bf16
// is exact in double, and the two accumulators (even and odd e) add in a
// fixed order, so the two lanes' sum is g_i . h_j up to double roundings
// (gh_exact's, over two lanes).
__device__ __forceinline__ void gh_wide(double (&acc)[2],
                                        const float* __restrict__ gi,
                                        const __nv_bfloat16* __restrict__ hj,
                                        const int hdim, const int side) {
#pragma unroll 4
    for (int q = 0; q < hdim / 16; ++q) {
        const int d = 16 * q + 8 * side;
        const uint4 hv = *reinterpret_cast<const uint4*>(hj + d);
        const float4 ga = reinterpret_cast<const float4*>(gi + d)[0];
        const float4 gb = reinterpret_cast<const float4*>(gi + d)[1];
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        const unsigned hw[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            acc[0] = fma((double)gv[2 * k], (double)lo_bf16(hw[k]), acc[0]);
            acc[1] = fma((double)gv[2 * k + 1], (double)hi_bf16(hw[k]), acc[1]);
        }
    }
}

// The bf16 dq on the tensor cores (social_attention_pairs.cuh, "bf16
// operands on Hopper's tensor cores").  Each warp owns one query row i at a
// time and walks rows with the stride of the grid's warps (dq_blocks caps
// the grid), so W2's two fragment arrays, W1, b1 and b2 are staged once a
// block.  Per row the warp scans [i - w, i + 1 + w) (all N for w = 0) with
// warp_fill and takes its partners in m-tiles of 16, in registers and
// shuffles only:
//   a partner's features by lane p < 16, layer 1 into A fragments and
//   layer2_scores (u_j, c_j of each pair), the forward's own routine, so
//   a_ij renormalizes bit for bit against the forward's (m, l);
//   g_i . h_j of pair p by lane p (and p + 16), one FMA after another in
//   the plain version's order (gh_serial, g_i staged in the warp's shared
//   slice): on rows where ds = a (g . h - r) cancels (a scene of two), dx_i
//   is that rounding, and this order keeps it the plain version's; kWide
//   (H above 128) sums exact products in double over two lanes a pair
//   (gh_wide, g_i read from device memory as the float wide dq reads it;
//   staged slices of 128 columns spilled at 128 registers);
//   ds_ij = a_ij (g_i . h_j - r_i), dz2 = [a2 > 0] ds u_j in the
//   accumulator layout, which is the A operand of da1 = dz2 W2^T (mma,
//   64 -> 32, 2048 MAC a pair); dz2 stays float32 and enters the product
//   split exactly into three bf16 pieces (split3, added lo, mid, hi), so
//   every partial product is exact;
//   dz1 = [a1 > 0] da1, gf = W1 dz1 (the quad's rows) and the feature
//   backward of pair p (pair_geo, geo_backward), its dx_i term summed over
//   the m-tile in a fixed tree and added to the row's sum.
// A row's bits depend on its pairs alone, in ascending j: no block barrier
// after the staging, no cross-row sum, so neither the grid nor w changes
// them, and a member launch equals its solo launches.  Lanes past the
// m-tile's pairs run on column 0 (real memory) with a = 0, so no load or
// step is guarded: every term they add is 0.
template <bool kWide>
__device__ __forceinline__ void dq_mma(
        const float4* __restrict__ x4, const int* __restrict__ ids,
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ g,
        const float2* __restrict__ stats, const float* __restrict__ r,
        const float* __restrict__ u, const float* __restrict__ cvec,
        const __nv_bfloat16* __restrict__ w1,
        const __nv_bfloat16* __restrict__ b1,
        const __nv_bfloat16* __restrict__ w2,
        const __nv_bfloat16* __restrict__ b2, float4* __restrict__ dx,
        const int n, const int hdim, const int w, const Members ms) {
    // Static shared memory, bytes: W2's layer-2 and da1 B fragments 4,096
    // each | the warps' g_i slices 2,048 (kWide: 64, unused) | the rings
    // 1,024 | b2, W1, b1 768 | the warps' dx_i sums 64: 12,096 in all
    // (kWide 10,112).  x_i, the stats and r_i are read again where they
    // are needed and dx_i kept in shared memory, not registers: with them
    // live through the m-tile loop the kernel spilled at 128
    __shared__ __align__(16) uint2 s_w2f[kW2Frags];
    __shared__ __align__(16) uint2 s_w2t[kW2TFrags];
    __shared__ __align__(16) float s_g[kWarps][kWide ? 4 : kNarrowWidth];
    __shared__ int s_ring[kWarps][kWRing];
    __shared__ __align__(16) float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];
    __shared__ float4 s_dx[kWarps];    // row i's dx_i, lane 0's alone

    // member m's rows: h, g, stats, r, u, c, dx at m N; x4 and ids at m
    // ms.x4, m ms.ids (0 when shared); its weights at m ms.w*.  A row
    // offset at every index, as dkv_mma
    const int m = member(), mrow = m * n, xrow = m * ms.x4,
              irow = m * ms.ids;
    w1 += m * ms.w1; b1 += m * ms.b1; w2 += m * ms.w2; b2 += m * ms.b2;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the warp's first row: its scan runs while the block stages
    int i = blockIdx.x * kWarps + warp, sid = 0;
    WarpRing wr{s_ring[warp], 0, 0, 0, 0};
    if (i < n) {
        sid = ids[irow + i];
        wr.next = w == 0 ? 0 : max(0, i - w);
        wr.end = w == 0 ? n : min(n, i + 1 + w);
        warp_fill(wr, ids, irow, sid, i);
    }
    stage_w2_frags(w2, s_w2f);
    stage_w2t_frags(w2, s_w2t);
    for (int t = threadIdx.x; t < kH2; t += kThreads) s_b2[t] = ld(b2[t]);
    for (int t = threadIdx.x; t < kIn * kH1; t += kThreads) s_w1[t] = ld(w1[t]);
    for (int t = threadIdx.x; t < kH1; t += kThreads) s_b1[t] = ld(b1[t]);
    __syncthreads();

    const int gq = lane >> 2, t = lane & 3, p = lane & 15, side = lane >> 4;
    float* const gs = s_g[warp];      // g_i of the narrow kernel
    for (bool first = true; i < n; i += gridDim.x * kWarps, first = false) {
        if (!first) {
            sid = ids[irow + i];
            wr = WarpRing{s_ring[warp], 0, 0, w == 0 ? 0 : max(0, i - w),
                          w == 0 ? n : min(n, i + 1 + w)};
        }
        if constexpr (!kWide) {
            __syncwarp();        // the row before has read gs
            if (4 * lane < hdim)
                reinterpret_cast<float4*>(gs)[lane] = reinterpret_cast<const float4*>(
                    g + (size_t)(mrow + i) * hdim)[lane];
            __syncwarp();
        }
        if (lane == 0) s_dx[warp] = make_float4(0.f, 0.f, 0.f, 0.f);
        while (true) {
            warp_fill(wr, ids, irow, sid, i);
            if (wr.count == 0) break;
            const int nb = wr.count < kMma ? wr.count : kMma;
            const bool act = p < nb;
            // lane p: pair p's column (0 past nb), x_j and features
            const int col = act ? wr.ring[(wr.head + p) & (kWRing - 1)] : 0;
            float f[kIn];
            {
                const float4 xi = x4[xrow + i];
                const Geo q = pair_geo(xi, speed(xi), x4[xrow + col]);
#pragma unroll
                for (int c = 0; c < kIn; ++c)
                    f[c] = act ? rnd<__nv_bfloat16>(q.feat[c]) : 0.f;
            }
            // g_i . h_j of pair p
            const __nv_bfloat16* const hj = h + (size_t)(mrow + col) * hdim;
            float gh;
            if constexpr (kWide) {
                double acc[2] = {0.0, 0.0};
                gh_wide(acc, g + (size_t)(mrow + i) * hdim, hj, hdim, side);
                const double ghd = acc[0] + acc[1];
                gh = (float)(ghd + __shfl_xor_sync(kFull, ghd, 16));
            } else {
                gh = gh_serial(gs, hj, hdim);
            }
            // layer 1 and layer2_scores of pairs gq and gq + 8
            float fg[kIn], fg8[kIn];
#pragma unroll
            for (int c = 0; c < kIn; ++c) {
                fg[c] = __shfl_sync(kFull, f[c], gq);
                fg8[c] = __shfl_sync(kFull, f[c], gq + 8);
            }
            const int colg = __shfl_sync(kFull, col, gq);
            const int colg8 = __shfl_sync(kFull, col, gq + 8);
            const float* const ug = u + (size_t)(mrow + colg) * kH2;
            const float* const ug8 = u + (size_t)(mrow + colg8) * kH2;
            unsigned a[2][4];
            layer1_frags(fg, fg8, s_w1, s_b1, a);
            // the relu mask of a1 (rounding keeps the sign) as bits, 4 nt +
            // e of z1[nt][e] below: the A fragments die with layer 2
            unsigned a1_pos = 0u;
#pragma unroll
            for (int nt = 0; nt < kN1; ++nt) {
                const unsigned rg = a[nt >> 1][2 * (nt & 1)];
                const unsigned rg8 = a[nt >> 1][2 * (nt & 1) + 1];
                a1_pos |= (lo_bf16(rg) > 0.f ? 1u : 0u) << (4 * nt);
                a1_pos |= (hi_bf16(rg) > 0.f ? 2u : 0u) << (4 * nt);
                a1_pos |= (lo_bf16(rg8) > 0.f ? 4u : 0u) << (4 * nt);
                a1_pos |= (hi_bf16(rg8) > 0.f ? 8u : 0u) << (4 * nt);
            }
            float a2[kN2][4];
            const float2 sc = layer2_scores(a, s_w2f, s_b2, ug, ug8,
                                            cvec[mrow + colg],
                                            cvec[mrow + colg8], a2);
            // pair p's a_ij and ds_ij (lane p & 15); row i's stats and r_i
            // read here, not held through the m-tiles
            const float s_lo = __shfl_sync(kFull, sc.x, 4 * (p & 7));
            const float s_hi = __shfl_sync(kFull, sc.y, 4 * (p & 7));
            const float2 st = stats[mrow + i];
            const float ap = act ? expf((p < 8 ? s_lo : s_hi) - st.x) / fmaxf(st.y, 1e-20f)
                                 : 0.f;
            const float ds = ap * (gh - r[mrow + i]);
            // dz2 = [a2 > 0] ds u_j, over a2
            const float dsg = __shfl_sync(kFull, ds, gq);
            const float dsg8 = __shfl_sync(kFull, ds, gq + 8);
#pragma unroll
            for (int nt = 0; nt < kN2; ++nt) {
                const float2 uo = *reinterpret_cast<const float2*>(ug + 8 * nt + 2 * t);
                const float2 uo8 = *reinterpret_cast<const float2*>(ug8 + 8 * nt + 2 * t);
                a2[nt][0] = a2[nt][0] > 0.f ? dsg * uo.x : 0.f;
                a2[nt][1] = a2[nt][1] > 0.f ? dsg * uo.y : 0.f;
                a2[nt][2] = a2[nt][2] > 0.f ? dsg8 * uo8.x : 0.f;
                a2[nt][3] = a2[nt][3] > 0.f ? dsg8 * uo8.y : 0.f;
            }
            // da1 = dz2 W2^T: dz2 in three bf16 pieces (lo, mid, hi: added
            // in that order), k-step ks at a time (its n-tiles 2 ks, 2 ks + 1)
            float z1[kN1][4];
#pragma unroll
            for (int nt = 0; nt < kN1; ++nt)
                z1[nt][0] = z1[nt][1] = z1[nt][2] = z1[nt][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < kH2 / 16; ++ks) {
                unsigned pc[3][4];
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    unsigned piece[3];
                    split3(a2[2 * ks + (v >> 1)][2 * (v & 1)],
                           a2[2 * ks + (v >> 1)][2 * (v & 1) + 1], piece);
                    pc[0][v] = piece[0];
                    pc[1][v] = piece[1];
                    pc[2][v] = piece[2];
                }
#pragma unroll
                for (int nt = 0; nt < kN1; ++nt) {
                    const uint2 b = s_w2t[(ks * kN1 + nt) * 32 + lane];
#pragma unroll
                    for (int k = 0; k < 3; ++k) mma_bf16(z1[nt], pc[k], b.x, b.y);
                }
            }
            // dz1 = [a1 > 0] da1
#pragma unroll
            for (int nt = 0; nt < kN1; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    z1[nt][e] = (a1_pos >> (4 * nt + e)) & 1u ? z1[nt][e] : 0.f;
            // gf = W1 dz1 of pairs gq and gq + 8 (this lane's 8 columns,
            // then the quad), then pair p's feature backward
            float gf[kIn];
#pragma unroll
            for (int c = 0; c < kIn; ++c) {
                float s0 = 0.f, s1 = 0.f;
#pragma unroll
                for (int nt = 0; nt < kN1; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float wv = s_w1[c * kH1 + 8 * nt + 2 * t + e];
                        s0 = fmaf(wv, z1[nt][e], s0);
                        s1 = fmaf(wv, z1[nt][2 + e], s1);
                    }
                s0 += __shfl_xor_sync(kFull, s0, 1);
                s0 += __shfl_xor_sync(kFull, s0, 2);
                s1 += __shfl_xor_sync(kFull, s1, 1);
                s1 += __shfl_xor_sync(kFull, s1, 2);
                const float v0 = __shfl_sync(kFull, s0, 4 * (p & 7));
                const float v1 = __shfl_sync(kFull, s1, 4 * (p & 7));
                gf[c] = p < 8 ? v0 : v1;
            }
            float4 gi4, gj4;
            {
                const float4 xi = x4[xrow + i];
                const float vn = speed(xi);
                geo_backward(pair_geo(xi, vn, x4[xrow + col]), xi, vn, gf,
                             gi4, gj4);
            }
            // the m-tile's dx_i terms in a fixed tree over lanes p (lanes
            // p + 16 hold the same bits), added to the row's sum
            {
                const float sx = half_warp_sum(act ? gi4.x : 0.f);
                const float sy = half_warp_sum(act ? gi4.y : 0.f);
                const float sz = half_warp_sum(act ? gi4.z : 0.f);
                const float sw = half_warp_sum(act ? gi4.w : 0.f);
                if (lane == 0) {
                    const float4 d = s_dx[warp];
                    s_dx[warp] = make_float4(d.x + sx, d.y + sy, d.z + sz, d.w + sw);
                }
            }
            wr.head = (wr.head + nb) & (kWRing - 1);
            wr.count -= nb;
        }
        if (lane == 0) dx[mrow + i] = s_dx[warp];
    }
}

#ifdef SA_BF16_ENTRIES
// The bf16 dq's resident blocks an SM (at most 128 registers a thread).
// kernels/social_attention.py's _MMA_DQ_MAX_BLOCKS caps the grid at this
// many on each of an H100's 132 SMs and must match it (a test reads this
// line).
constexpr int kMmaDqMinBlocks = 4;
#define SA_DQ_MMA_PARAMS                                                     \
    const float4* __restrict__ x4, const int* __restrict__ ids,              \
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ g,    \
        const float2* __restrict__ stats, const float* __restrict__ r,       \
        const float* __restrict__ u, const float* __restrict__ cvec,         \
        const __nv_bfloat16* __restrict__ w1,                                \
        const __nv_bfloat16* __restrict__ b1,                                \
        const __nv_bfloat16* __restrict__ w2,                                \
        const __nv_bfloat16* __restrict__ b2, float4* __restrict__ dx,       \
        const int n, const int hdim, const int w, const Members ms
#define SA_DQ_MMA_ARGS x4, ids, h, g, stats, r, u, cvec, w1, b1, w2, b2, dx, \
    n, hdim, w, ms

// The bf16 entries' dq kernels: dq_mma, in the primary template's
// signature (the launches, trace names and ptxas lines of the float one's);
// only the *_bf16.cu translation units (SA_BF16_ENTRIES) see them.
template <>
__global__ void __launch_bounds__(kThreads, kMmaDqMinBlocks)
bwd_dq_kernel<__nv_bfloat16, false>(SA_DQ_MMA_PARAMS) {
    dq_mma<false>(SA_DQ_MMA_ARGS);
}

template <>
__global__ void __launch_bounds__(kThreads, kMmaDqMinBlocks)
bwd_dq_kernel<__nv_bfloat16, true>(SA_DQ_MMA_PARAMS) {
    dq_mma<true>(SA_DQ_MMA_ARGS);
}

#undef SA_DQ_MMA_PARAMS
#undef SA_DQ_MMA_ARGS
#endif  // SA_BF16_ENTRIES

// The wide dh (H above kNarrowWidth): element e >= 2 kThreads of the
// column tile's [kTile][hdim] accumulates in the tile's own row of dh,
// which only this thread touches: zeroed (step 0), then a_ij g_i of one
// batch's pairs added the way the registers add theirs (step 1; g = the
// member's cotangent rows).
__device__ __forceinline__ void dh_wide(const int step, float* __restrict__ dh,
                                        const int n, const int col0,
                                        const int hdim, const int nb,
                                        const int* s_slot, const int* s_row,
                                        const float* s_a,
                                        const float* __restrict__ g) {
#pragma unroll 1
    for (int e = threadIdx.x + 2 * kThreads; e < tile_elems(n, col0, hdim);
         e += kThreads) {
        float* const o = dh + (size_t)col0 * hdim + e;
        if (step == 0) {
            *o = 0.f;
            continue;
        }
        const int c = e / hdim, d = e - c * hdim;
        float a = *o;
        for (int p = 0; p < nb; ++p)
            if (s_slot[p] == c)
                a = fmaf(s_a[p], g[(size_t)s_row[p] * hdim + d], a);
        *o = a;
    }
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const float4* __restrict__ x4, const int* __restrict__ ids,
               const T* __restrict__ h, const float* __restrict__ g,
               const float2* __restrict__ stats, const float* __restrict__ r,
               const float* __restrict__ u, const float* __restrict__ cvec,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2,
               const T* __restrict__ w3, const T* __restrict__ b3,
               float4* __restrict__ dx, float* __restrict__ dh,
               float* __restrict__ dwh, float* __restrict__ a_sum,
               float* __restrict__ s_sum, float* __restrict__ partial,
               const int n, const int hdim, const int feat, const int w,
               const Members ms) {
    // bf16 operands take dkv_mma (the specializations below): this body
    // runs for float alone
    static_assert(std::is_same_v<T, float>, "bf16: define SA_BF16_ENTRIES");
    __shared__ __align__(16) float s_w2[kH1 * kW2Stride];
    __shared__ __align__(16) float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];
    __shared__ __align__(16) float s_a1[kH1 * kA1Stride];    // a1^T
    __shared__ __align__(16) float s_dz2[kH2 * kDz2Stride];  // dz2^T
    __shared__ float s_dz1[kBatch * kDz1Stride];
    __shared__ float s_apart[kPairGroups * kTile * kH2];   // ds a2 by group
    __shared__ __align__(16) float s_u[kTile * kH2];
    constexpr int kHStride = kWide ? kStageWidth : kNarrowWidth;
    __shared__ float s_h[kTile * kHStride];
    // kWide above kStageWidth: h_j staged a chunk at a time (gh_chunked)
    const bool staged = !kWide || hdim <= kHStride;
    __shared__ float s_A[kTile * kH2];
    __shared__ float s_feat[kIn * kBatch];
    __shared__ float s_m[kBatch], s_l[kBatch], s_r[kBatch], s_a[kBatch],
        s_ds[kBatch];
    __shared__ int s_row[kBatch], s_slot[kBatch];
    __shared__ float4 s_gj[kBatch];
    __shared__ float4 s_xt[kTile];
    __shared__ float s_ct[kTile], s_S[kTile];
    __shared__ int s_ring[kRing], s_scan[kWarps];

    // member m's rows: h, g, stats, r, u, c and every output at m N; x4 and
    // ids at m ms.x4, m ms.ids (0 when shared); its weights at m ms.w*; its
    // partial slots after the (m gridDim.x) slots of the members before it
    const int m = member(), mrow = m * n, xrow = m * ms.x4,
              irow = m * ms.ids;
    stage_mlp12(w1 + m * ms.w1, b1 + m * ms.b1, w2 + m * ms.w2,
                b2 + m * ms.b2, s_w1, s_b1, s_w2, s_b2);
    pdl_launch_dependents();     // the finalize may start, and waits for us
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
    // the block's weight-gradient partials: dW2[4 pg + i][og + 16 q],
    // db2[og + 16 q] (pg == 0), and dW1[c][k] or db1[k] (c == 3) for
    // (c, k) = (t >> 5, t & 31)
    float p_w2[4][4], p_b2[4] = {0.f, 0.f, 0.f, 0.f}, p_w1 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) p_w2[i][q] = 0.f;
    const int chunk = hdim >> 4;    // lane og's part of g . h: d = og + 16 q
    const int n_tiles = (n + kTile - 1) / kTile;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int col0 = tile * kTile;
        int tile_id[kTile], tile_idx[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            tile_idx[t] = col0 + t;
            tile_id[t] = col0 + t < n ? ids[irow + col0 + t] : -1;
        }
        if (threadIdx.x < kTile) {
            const int j = col0 + threadIdx.x;
            s_xt[threadIdx.x] = j < n ? x4[xrow + j] : make_float4(0.f, 0.f, 0.f, 0.f);
            s_ct[threadIdx.x] = j < n ? cvec[mrow + j] : 0.f;
        }
        {
            const int c = threadIdx.x >> 6, k = threadIdx.x & (kH2 - 1);
            s_u[threadIdx.x] = col0 + c < n ? u[(size_t)(mrow + col0 + c) * kH2 + k] : 0.f;
        }
        if (staged)
            for (int e = threadIdx.x; e < kTile * hdim; e += kThreads) {
                const int c = e / hdim, d = e - c * hdim;
                s_h[c * kHStride + d] =
                    col0 + c < n ? ld(h[(size_t)(mrow + col0 + c) * hdim + d]) : 0.f;
            }
        // per-column sums: A[t >> 6][t & 63], S and dx_j of column t < kTile,
        // dh elements e = t + kThreads q of [kTile][hdim] (kWide: the first
        // 2 kThreads; dh_wide keeps the rest)
        float A = 0.f, S = 0.f, acc_h[2] = {0.f, 0.f};
        if constexpr (kWide)
            dh_wide(0, dh + (size_t)mrow * hdim, n, col0, hdim, 0, s_slot,
                    s_row, s_a, g);
        float4 dxj = make_float4(0.f, 0.f, 0.f, 0.f);
        PairRing pr = tile_ring(s_ring, s_scan, col0, n, w);
        __syncthreads();
        while (true) {
            fill_ring(pr, ids, irow, tile_id, tile_idx);
            if (pr.count == 0) break;
            const int nb = pr.count < kBatch ? pr.count : kBatch;
            // features, row, slot and the row's stats of each pair
            if (threadIdx.x < kBatch) {
                const int p = threadIdx.x;
                float f[kIn] = {0.f, 0.f, 0.f};
                int row = 0, slot = 0;
                float2 st = make_float2(0.f, 1.f);
                float r_i = 0.f;
                if (p < nb) {
                    const int e = s_ring[(pr.head + p) & (kRing - 1)];
                    row = e / kTile;
                    slot = e - row * kTile;
                    const float4 xi = x4[xrow + row];
                    const Geo q = pair_geo(xi, speed(xi), s_xt[slot]);
                    f[0] = q.feat[0]; f[1] = q.feat[1]; f[2] = q.feat[2];
                    st = stats[mrow + row];
                    r_i = r[mrow + row];
                }
#pragma unroll
                for (int c = 0; c < kIn; ++c) s_feat[c * kBatch + p] = rnd<T>(f[c]);
                s_row[p] = row;
                s_slot[p] = slot;
                s_m[p] = st.x;
                s_l[p] = st.y;
                s_r[p] = r_i;
            }
            __syncthreads();
            layer1<T>(s_feat, s_w1, s_b1, s_a1);
            __syncthreads();
            float gh4[4];
            if constexpr (kWide)
                if (!staged)
                    gh_chunked(gh4, h, g, mrow, col0, n, hdim, nb, s_row,
                               s_slot, s_h);
            {
                float a2[4][4], ap[kTile][4];
                layer2_tile<T>(s_a1, s_w2, kW2Stride, s_b2, a2);
#pragma unroll
                for (int c = 0; c < kTile; ++c)
#pragma unroll
                    for (int o = 0; o < 4; ++o) ap[c][o] = 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int p = 4 * pg + i, slot = s_slot[p];
                    const float4 u4 = reinterpret_cast<const float4*>(s_u + slot * kH2)[og];
                    const float gh = staged
                        ? gh_half_warp(g + (size_t)(mrow + s_row[p]) * hdim + og,
                                       s_h + slot * kHStride + og, chunk, p < nb)
                        : gh4[i];
                    const PairDs d = pair_ds(a2[i], u4, s_ct[slot], gh, p < nb,
                                             s_m[p], s_l[p], s_r[p]);
                    if (og == 0) {
                        s_a[p] = d.a;
                        s_ds[p] = d.ds;
                    }
#pragma unroll
                    for (int o = 0; o < 4; ++o)
#pragma unroll
                        for (int c = 0; c < kTile; ++c)
                            ap[c][o] = fmaf(slot == c ? d.ds : 0.f, a2[i][o], ap[c][o]);
                    dz2_of(a2[i], u4, d.ds);
                }
                store_dz2(s_dz2, a2);
#pragma unroll
                for (int c = 0; c < kTile; ++c)
#pragma unroll
                    for (int o = 0; o < 4; ++o)
                        s_apart[(pg * kTile + c) * kH2 + 4 * og + o] = ap[c][o];
            }
            __syncthreads();
            dz1_tile(s_w2, s_dz2, s_a1, s_dz1);
            {
                const int c = threadIdx.x >> 6, o = threadIdx.x & (kH2 - 1);
                float a = A;
#pragma unroll
                for (int q = 0; q < kPairGroups; ++q)
                    a += s_apart[(q * kTile + c) * kH2 + o];
                A = a;
            }
            if (threadIdx.x < kTile)
                for (int p = 0; p < nb; ++p)
                    if (s_slot[p] == (int)threadIdx.x) S += s_ds[p];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int e = threadIdx.x + q * kThreads;
                if (e < kTile * hdim) {
                    const int c = e / hdim, d = e - c * hdim;
                    float a = acc_h[q];
                    for (int p = 0; p < nb; ++p)
                        if (s_slot[p] == c)
                            a = fmaf(s_a[p], g[(size_t)(mrow + s_row[p]) * hdim + d], a);
                    acc_h[q] = a;
                }
            }
            if constexpr (kWide)
                dh_wide(1, dh + (size_t)mrow * hdim, n, col0, hdim, nb, s_slot,
                        s_row, s_a, g + (size_t)mrow * hdim);
            // dW2 += a1^T dz2 and db2 += sum dz2, four pairs a step (the
            // pairs past nb have dz2 = 0)
            for (int p4 = 0; p4 < (nb + 3) >> 2; ++p4) {
                float av[4][4], dv[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float4 a = reinterpret_cast<const float4*>(s_a1 + (4 * pg + i) * kA1Stride)[p4];
                    av[i][0] = a.x; av[i][1] = a.y; av[i][2] = a.z; av[i][3] = a.w;
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float4 d = reinterpret_cast<const float4*>(s_dz2 + (og + 16 * q) * kDz2Stride)[p4];
                    dv[q][0] = d.x; dv[q][1] = d.y; dv[q][2] = d.z; dv[q][3] = d.w;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            p_w2[i][q] = fmaf(av[i][e], dv[q][e], p_w2[i][q]);
                if (pg == 0)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        p_b2[q] = p_b2[q] + dv[q][0] + dv[q][1] + dv[q][2] + dv[q][3];
            }
            __syncthreads();
            {
                const int c = threadIdx.x >> 5, k = threadIdx.x & (kH1 - 1);
                float a = p_w1;
                for (int p = 0; p < nb; ++p)
                    a = fmaf(c < kIn ? s_feat[c * kBatch + p] : 1.f,
                             s_dz1[p * kDz1Stride + k], a);
                p_w1 = a;
            }
            if (dx != nullptr) {
                if (threadIdx.x < kBatch) {
                    const int p = threadIdx.x;
                    float4 gi, gj = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (p < nb)
                        pair_dx(s_w1, s_dz1 + p * kDz1Stride, x4[xrow + s_row[p]],
                                s_xt[s_slot[p]], gi, gj);
                    s_gj[p] = gj;
                }
                __syncthreads();
                if (threadIdx.x < kTile)
                    for (int p = 0; p < nb; ++p)
                        if (s_slot[p] == (int)threadIdx.x) {
                            const float4 v = s_gj[p];
                            dxj.x += v.x; dxj.y += v.y; dxj.z += v.z; dxj.w += v.w;
                        }
            }
            pr.head = (pr.head + nb) & (kRing - 1);
            pr.count -= nb;
            __syncthreads();     // the batch's shared arrays are free
        }
        // the tile's columns: A_j, S_j (for the finalize), dh_j, dx_j, dwh_j
        {
            const int c = threadIdx.x >> 6, o = threadIdx.x & (kH2 - 1);
            s_A[threadIdx.x] = A;
            if (col0 + c < n) a_sum[(size_t)(mrow + col0 + c) * kH2 + o] = A;
        }
        if (threadIdx.x < kTile) {
            const int j = col0 + threadIdx.x;
            s_S[threadIdx.x] = S;
            if (j < n) {
                s_sum[mrow + j] = S;
                if (dx != nullptr) dx[mrow + j] = dxj;
            }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int e = threadIdx.x + q * kThreads;
            if (e < kTile * hdim) {
                const int c = e / hdim, d = e - c * hdim;
                if (col0 + c < n) dh[(size_t)(mrow + col0 + c) * hdim + d] = acc_h[q];
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kTile * feat; e += kThreads) {
            const int c = e / feat, f = e - c * feat;
            if (col0 + c >= n) continue;
            float t = s_S[c] * ld(b3[m * ms.b3 + f]);
#pragma unroll 16
            for (int k = 0; k < kH2; ++k)
                t = fmaf(s_A[c * kH2 + k], ld(w3[m * ms.w3 + k * feat + f]), t);
            dwh[(size_t)(mrow + col0 + c) * feat + f] = t;
        }
        __syncthreads();         // s_A, s_S, s_xt, s_u, s_h are the next tile's
    }
    float* part = partial + ((size_t)m * gridDim.x + blockIdx.x) * kPartial;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
            part[(4 * pg + i) * kH2 + og + 16 * q] = p_w2[i][q];
    if (pg == 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[kH1 * kH2 + og + 16 * q] = p_b2[q];
    part[kH1 * kH2 + kH2 + threadIdx.x] = p_w1;   // dW1 [3][32] | db1 [32]
}

// The bf16 dkv on the tensor cores (social_attention_pairs.cuh, "bf16
// operands on Hopper's tensor cores").  Each warp owns one column j at a
// time and walks columns with the stride of the grid's warps (dkv_blocks
// caps the grid), takes its partners i in m-tiles of 16 and, per m-tile, in
// registers and shuffles only:
//   features, layer 1, layer2_scores (u_j, c_j) as the forward;
//   g_i . h_j (lane p & 15 over half of H, the halves added), a_ij, ds_ij;
//   S_j, A_j = sum ds a2 (the m-tile's eight row groups added by shuffles),
//   dh_j = sum a_ij g_i (a lane's two neighbouring columns at a time;
//   kWide: past 128 in row j of dh, which only this warp touches);
//   dz2 = [a2 > 0] ds u_j in the accumulator layout, which is the A
//   operand of dz1 = [a1 > 0] dz2 W2^T (mma);
//   with dx: gf = W1 dz1 (the quad's rows) and the feature backward;
//   dW2 += a1^T dz2, db2 += 1^T dz2, dW1 | db1 += [feat | 1]^T dz1 (mma;
//   a1^T, dz2^T and dz1^T by movmatrix from the registers that hold them).
// The cotangents dz2 and dz1 stay float32: each enters a product split
// exactly into three bf16 pieces (split3), so every partial product is
// exact and only the order of the float sums differs from FFMA.  A warp's
// partials of dW2 (in fragment order: it is each product's accumulator),
// db2 and dW1 | db1 live in shared memory; at the end each warp writes its
// own partial slot, with no block barrier, and bwd_finalize_kernel adds
// the slots.  Every sum runs in a fixed order: two runs, a
// w > 0 and a w = 0 launch, and a member and a solo launch give equal
// bits (the grid depends on N alone).
template <bool kWide>
__device__ __forceinline__ void dkv_mma(
        const float4* __restrict__ x4, const int* __restrict__ ids,
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ g,
        const float2* __restrict__ stats, const float* __restrict__ r,
        const float* __restrict__ u, const float* __restrict__ cvec,
        const __nv_bfloat16* __restrict__ w1,
        const __nv_bfloat16* __restrict__ b1,
        const __nv_bfloat16* __restrict__ w2,
        const __nv_bfloat16* __restrict__ b2,
        const __nv_bfloat16* __restrict__ w3,
        const __nv_bfloat16* __restrict__ b3, float4* __restrict__ dx,
        float* __restrict__ dh, float* __restrict__ dwh,
        float* __restrict__ a_sum, float* __restrict__ s_sum,
        float* __restrict__ partial, const int n, const int hdim,
        const int feat, const int w, const Members ms) {
    // Static shared memory, bytes: the warps' partials of dW2 32,768, db2
    // 1,024 and dW1 | db1 2,048 | W2's layer-2 B fragments 4,096 | the rings
    // 4,096 | the warps' A_j 1,024 | b2, W1, b1 768: 45,824 in all (under
    // the 48 KB of static shared memory).  Partials in shared memory, not
    // registers: the m-tile's products need the registers.  dz1's B
    // fragments are W2's own 32-bit words, read from the (cached) weights.
    constexpr int kTail = kIn * kH1 + kH1;          // dW1 | db1: 128
    __shared__ __align__(16) float4 s_dw2[kWarps][2 * kN2 * 32];
    __shared__ __align__(16) float s_db2[kWarps][kH2];
    __shared__ __align__(16) float s_aj[kWarps][kH2];
    __shared__ __align__(16) uint2 s_w2f[kW2Frags];
    __shared__ int s_ring[kWarps][kWRing];
    __shared__ __align__(16) float s_misc[kWarps][kTail];
    __shared__ __align__(16) float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];

    // member m's rows: h, g, stats, r, u, c and every output at m N; x4 and
    // ids at m ms.x4, m ms.ids (0 when shared); its weights at m ms.w*; its
    // partial slots after the members' before.  A row offset at every index
    // (the float kernels' way): moved pointers would each hold two registers
    const int m = member(), mrow = m * n, xrow = m * ms.x4,
              irow = m * ms.ids, w3o = m * ms.w3, b3o = m * ms.b3;
    w1 += m * ms.w1; b1 += m * ms.b1; w2 += m * ms.w2; b2 += m * ms.b2;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the warp's first column: its scan starts before the staging, so that
    // the two wait for their loads together
    int j = blockIdx.x * kWarps + warp, sid = 0;
    WarpRing wr{s_ring[warp], 0, 0, 0, 0};
    if (j < n) {
        sid = ids[irow + j];
        wr.next = w == 0 ? 0 : max(0, j - w);
        wr.end = w == 0 ? n : min(n, j + 1 + w);
        warp_fill(wr, ids, irow, sid, j);
    }
    stage_w2_frags(w2, s_w2f);
    const unsigned* const w2t = reinterpret_cast<const unsigned*>(w2);
    for (int t = threadIdx.x; t < kH2; t += kThreads) s_b2[t] = ld(b2[t]);
    for (int t = threadIdx.x; t < kIn * kH1; t += kThreads) s_w1[t] = ld(w1[t]);
    for (int t = threadIdx.x; t < kH1; t += kThreads) s_b1[t] = ld(b1[t]);
    for (int e = threadIdx.x; e < kWarps * 2 * kN2 * 32; e += kThreads)
        (&s_dw2[0][0])[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = threadIdx.x; e < kWarps * kH2; e += kThreads)
        (&s_db2[0][0])[e] = 0.f;
    for (int e = threadIdx.x; e < kWarps * kTail; e += kThreads)
        (&s_misc[0][0])[e] = 0.f;
    __syncthreads();
    pdl_launch_dependents();     // the finalize may start, and waits for us

    const int gq = lane >> 2, t = lane & 3, p = lane & 15;
    float4* const dw2 = s_dw2[warp];
    float* const db2 = s_db2[warp];     // row 3 of [feat | 1]^T dz2 (gq = 3)
    // rows c = gq < 4 of [feat | 1]^T dz1: dW1[c][k1] (c < 3), db1 (c = 3)
    float* const dw1 = s_misc[warp];
    float* const aj = s_aj[warp];       // the column's A_j

    for (bool first = true; j < n; j += gridDim.x * kWarps, first = false) {
        if (!first) {
            sid = ids[irow + j];
            wr = WarpRing{s_ring[warp], 0, 0, w == 0 ? 0 : max(0, j - w),
                          w == 0 ? n : min(n, j + 1 + w)};
        }
        const float4 xj = x4[xrow + j];
        const float cj = cvec[mrow + j];
        const float* const uj = u + (size_t)(mrow + j) * kH2;
        const __nv_bfloat16* const hj = h + (size_t)(mrow + j) * hdim;
        float* const dhrow = dh + (size_t)(mrow + j) * hdim;
        // dh_j[d], d = 2 (lane + 32 q) + e, in dha[q][e]
        float S = 0.f, dha[kNarrowWidth / 64][2] = {{0.f, 0.f}, {0.f, 0.f}};
        if (lane < 16) reinterpret_cast<float4*>(aj)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dxj = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kWide)
            for (int d = kNarrowWidth + 2 * lane; d < hdim; d += 64)
                *reinterpret_cast<float2*>(dhrow + d) = make_float2(0.f, 0.f);
        while (true) {
            warp_fill(wr, ids, irow, sid, j);
            if (wr.count == 0) break;
            const int nb = wr.count < kMma ? wr.count : kMma;
            // lane p < nb: pair p's row, features, stats and r
            int row = 0;
            float f[kIn] = {0.f, 0.f, 0.f}, mi = 0.f, li = 1.f, ri = 0.f;
            float4 xi = make_float4(0.f, 0.f, 0.f, 0.f);
            if (p < nb) {
                row = wr.ring[(wr.head + p) & (kWRing - 1)];
                xi = x4[xrow + row];
                const Geo q = pair_geo(xi, speed(xi), xj);
#pragma unroll
                for (int c = 0; c < kIn; ++c) f[c] = rnd<__nv_bfloat16>(q.feat[c]);
                const float2 st = stats[mrow + row];
                mi = st.x;
                li = st.y;
                ri = r[mrow + row];
            }
            float fg[kIn], fg8[kIn];
#pragma unroll
            for (int c = 0; c < kIn; ++c) {
                fg[c] = __shfl_sync(kFull, f[c], gq);
                fg8[c] = __shfl_sync(kFull, f[c], gq + 8);
            }
            unsigned a[2][4];
            layer1_frags(fg, fg8, s_w1, s_b1, a);
            float a2[kN2][4];
            const float2 sc = layer2_scores(a, s_w2f, s_b2, uj, uj, cj, cj, a2);
            // pair p's a_ij (lane p & 15)
            const float s_a = __shfl_sync(kFull, sc.x, 4 * (p & 7));
            const float s_b = __shfl_sync(kFull, sc.y, 4 * (p & 7));
            const float ap = p < nb ? expf((p < 8 ? s_a : s_b) - mi) / fmaxf(li, 1e-20f)
                                    : 0.f;
            // g_i . h_j and dh_j += a_ij g_i, H in chunks of 64 columns: lane
            // (p, lane >> 4) loads its pair's 32 columns of g_i, adds its part
            // of g_i . h_j, and the half warp sums a_ij g_i column by column
            // (reduce-scatter: lane l ends with columns 64 c + 2 l, + 1)
            float gh = 0.f;
            const float* const gi = g + (size_t)(mrow + row) * hdim;
            for (int c0 = 0; c0 < hdim; c0 += 64) {
                const int d0 = c0 + 32 * (lane >> 4);
                float v[32];
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const int d = d0 + 4 * q;
                    float4 ga = make_float4(0.f, 0.f, 0.f, 0.f), hb = ga;
                    if (d < hdim) {
                        ga = *reinterpret_cast<const float4*>(gi + d);
                        hb = ld4(hj + d, 0);
                    }
                    gh = fmaf(ga.x, hb.x, gh);
                    gh = fmaf(ga.y, hb.y, gh);
                    gh = fmaf(ga.z, hb.z, gh);
                    gh = fmaf(ga.w, hb.w, gh);
                    v[4 * q] = ap * ga.x;
                    v[4 * q + 1] = ap * ga.y;
                    v[4 * q + 2] = ap * ga.z;
                    v[4 * q + 3] = ap * ga.w;
                }
                half_warp_reduce_scatter(v);
                if (c0 == 0) {
                    dha[0][0] += v[0];
                    dha[0][1] += v[1];
                } else if (c0 == 64) {
                    dha[1][0] += v[0];
                    dha[1][1] += v[1];
                } else if (kWide && c0 + 2 * lane < hdim) {
                    float2* const o = reinterpret_cast<float2*>(dhrow + c0 + 2 * lane);
                    const float2 ov = *o;
                    *o = make_float2(ov.x + v[0], ov.y + v[1]);
                }
            }
            gh += __shfl_xor_sync(kFull, gh, 16);
            const PairDs pd{ap, ap * (gh - ri)};
            S += warp_sum(lane < kMma ? pd.ds : 0.f);
            // A_j += ds a2 (the m-tile's sum over the eight row groups, the
            // same bits in every group, added by lanes t of group 0); dz2 =
            // [a2 > 0] ds u_j, over a2
            const float dsg = __shfl_sync(kFull, pd.ds, gq);
            const float dsg8 = __shfl_sync(kFull, pd.ds, gq + 8);
#pragma unroll
            for (int nt = 0; nt < kN2; ++nt) {
                float v0 = fmaf(dsg8, a2[nt][2], dsg * a2[nt][0]);
                float v1 = fmaf(dsg8, a2[nt][3], dsg * a2[nt][1]);
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {
                    v0 += __shfl_xor_sync(kFull, v0, off);
                    v1 += __shfl_xor_sync(kFull, v1, off);
                }
                if (gq == 0) {
                    float2* const av = reinterpret_cast<float2*>(aj + 8 * nt + 2 * t);
                    const float2 o = *av;
                    *av = make_float2(o.x + v0, o.y + v1);
                }
            }
#pragma unroll
            for (int nt = 0; nt < kN2; ++nt) {
                const float2 uo = *reinterpret_cast<const float2*>(uj + 8 * nt + 2 * t);
                a2[nt][0] = a2[nt][0] > 0.f ? dsg * uo.x : 0.f;
                a2[nt][1] = a2[nt][1] > 0.f ? dsg * uo.y : 0.f;
                a2[nt][2] = a2[nt][2] > 0.f ? dsg8 * uo.x : 0.f;
                a2[nt][3] = a2[nt][3] > 0.f ? dsg8 * uo.y : 0.f;
            }
            // the weight-gradient products' A operands: a1^T (its four 8 x 8
            // blocks transposed) and [feat | 1]^T (rows c = gq < 4)
            unsigned at[2][4], ft[4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                at[mt][0] = movm_trans(a[mt][0]);
                at[mt][1] = movm_trans(a[mt][2]);
                at[mt][2] = movm_trans(a[mt][1]);
                at[mt][3] = movm_trans(a[mt][3]);
            }
            ft[0] = movm_trans(t == 0 ? pack_bf16(fg[0], fg[1])
                               : t == 1 ? pack_bf16(fg[2], 1.f) : 0u);
            ft[2] = movm_trans(t == 0 ? pack_bf16(fg8[0], fg8[1])
                               : t == 1 ? pack_bf16(fg8[2], 1.f) : 0u);
            ft[1] = ft[3] = 0u;
            // dz2 in three bf16 pieces (lo, mid, hi: added in that order),
            // k-step ks at a time (its n-tiles 2 ks and 2 ks + 1): the A
            // operand of dz1 = dz2 W2^T and, transposed, the B operand of
            // dW2 += a1^T dz2 and db2 += 1^T dz2
            float z1[kH1 / 8][4];
#pragma unroll
            for (int nt = 0; nt < kH1 / 8; ++nt)
                z1[nt][0] = z1[nt][1] = z1[nt][2] = z1[nt][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < kH2 / 16; ++ks) {
                unsigned ap[3][4];
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    unsigned piece[3];
                    split3(a2[2 * ks + (v >> 1)][2 * (v & 1)],
                           a2[2 * ks + (v >> 1)][2 * (v & 1) + 1], piece);
                    ap[0][v] = piece[0];
                    ap[1][v] = piece[1];
                    ap[2][v] = piece[2];
                }
#pragma unroll
                for (int nt = 0; nt < kH1 / 8; ++nt) {
                    // B[o][k1] = W2[k1][o]: o pairs are W2's 32-bit words
                    const unsigned* wrow = w2t + (8 * nt + gq) * (kH2 / 2);
                    const unsigned bw0 = wrow[8 * ks + t], bw1 = wrow[8 * ks + 4 + t];
#pragma unroll
                    for (int piece = 0; piece < 3; ++piece)
                        mma_bf16(z1[nt], ap[piece], bw0, bw1);
                }
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int nt = 2 * ks + hf;
                    unsigned b[3][2];
#pragma unroll
                    for (int piece = 0; piece < 3; ++piece) {
                        b[piece][0] = movm_trans(ap[piece][2 * hf]);
                        b[piece][1] = movm_trans(ap[piece][2 * hf + 1]);
                    }
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt) {
                        float4& slot = dw2[(mt * kN2 + nt) * 32 + lane];
                        float acc[4] = {slot.x, slot.y, slot.z, slot.w};
#pragma unroll
                        for (int piece = 0; piece < 3; ++piece)
                            mma_bf16(acc, at[mt], b[piece][0], b[piece][1]);
                        slot = make_float4(acc[0], acc[1], acc[2], acc[3]);
                    }
                    float2* const d2 = reinterpret_cast<float2*>(db2 + 8 * nt + 2 * t);
                    const float2 d2v = gq == 3 ? *d2 : make_float2(0.f, 0.f);
                    float acc[4] = {d2v.x, d2v.y, 0.f, 0.f};
#pragma unroll
                    for (int piece = 0; piece < 3; ++piece)
                        mma_bf16(acc, ft, b[piece][0], b[piece][1]);
                    if (gq == 3) *d2 = make_float2(acc[0], acc[1]);
                }
            }
#pragma unroll
            for (int nt = 0; nt < kH1 / 8; ++nt) {
                const unsigned rg = a[nt >> 1][2 * (nt & 1)];
                const unsigned rg8 = a[nt >> 1][2 * (nt & 1) + 1];
                z1[nt][0] = lo_bf16(rg) > 0.f ? z1[nt][0] : 0.f;
                z1[nt][1] = hi_bf16(rg) > 0.f ? z1[nt][1] : 0.f;
                z1[nt][2] = lo_bf16(rg8) > 0.f ? z1[nt][2] : 0.f;
                z1[nt][3] = hi_bf16(rg8) > 0.f ? z1[nt][3] : 0.f;
            }
            if (dx != nullptr) {
                // gf = W1 dz1 of pairs gq and gq + 8 (this lane's 8 columns,
                // then the quad), then pair p's feature backward
                float gf[kIn];
#pragma unroll
                for (int c = 0; c < kIn; ++c) {
                    float s0 = 0.f, s1 = 0.f;
#pragma unroll
                    for (int nt = 0; nt < kH1 / 8; ++nt)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float wv = s_w1[c * kH1 + 8 * nt + 2 * t + e];
                            s0 = fmaf(wv, z1[nt][e], s0);
                            s1 = fmaf(wv, z1[nt][2 + e], s1);
                        }
                    s0 += __shfl_xor_sync(kFull, s0, 1);
                    s0 += __shfl_xor_sync(kFull, s0, 2);
                    s1 += __shfl_xor_sync(kFull, s1, 1);
                    s1 += __shfl_xor_sync(kFull, s1, 2);
                    const float v0 = __shfl_sync(kFull, s0, 4 * (p & 7));
                    const float v1 = __shfl_sync(kFull, s1, 4 * (p & 7));
                    gf[c] = p < 8 ? v0 : v1;
                }
                float4 gi4, gj4 = make_float4(0.f, 0.f, 0.f, 0.f);
                if (p < nb) {
                    const float vn = speed(xi);
                    geo_backward(pair_geo(xi, vn, xj), xi, vn, gf, gi4, gj4);
                }
                const bool mine = lane < kMma;
                dxj.x += warp_sum(mine ? gj4.x : 0.f);
                dxj.y += warp_sum(mine ? gj4.y : 0.f);
                dxj.z += warp_sum(mine ? gj4.z : 0.f);
                dxj.w += warp_sum(mine ? gj4.w : 0.f);
            }
            // dW1 | db1 += [feat | 1]^T dz1 (B = dz1 transposed, in pieces)
#pragma unroll
            for (int nt = 0; nt < kH1 / 8; ++nt) {
                unsigned b[3][2];
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    unsigned piece[3];
                    split3(z1[nt][2 * hf], z1[nt][2 * hf + 1], piece);
#pragma unroll
                    for (int k = 0; k < 3; ++k) b[k][hf] = movm_trans(piece[k]);
                }
                float2* const d1 = reinterpret_cast<float2*>(dw1 + gq * kH1 + 8 * nt + 2 * t);
                const float2 d1v = gq < 4 ? *d1 : make_float2(0.f, 0.f);
                float acc[4] = {d1v.x, d1v.y, 0.f, 0.f};
#pragma unroll
                for (int piece = 0; piece < 3; ++piece)
                    mma_bf16(acc, ft, b[piece][0], b[piece][1]);
                if (gq < 4) *d1 = make_float2(acc[0], acc[1]);
            }
            wr.head = (wr.head + nb) & (kWRing - 1);
            wr.count -= nb;
        }
        // the column's sums: a_sum, s_sum, dx_j, dh_j, dwh_j
        __syncwarp();
        if (lane < 16)
            reinterpret_cast<float4*>(a_sum + (size_t)(mrow + j) * kH2)[lane] =
                reinterpret_cast<const float4*>(aj)[lane];
        if (lane == 0) {
            s_sum[mrow + j] = S;
            if (dx != nullptr) dx[mrow + j] = dxj;
        }
#pragma unroll
        for (int q = 0; q < kNarrowWidth / 64; ++q)
            if (2 * (lane + 32 * q) < hdim)
                reinterpret_cast<float2*>(dhrow)[lane + 32 * q] =
                    make_float2(dha[q][0], dha[q][1]);
        __syncwarp();
        // dwh_j = A_j W3 + S_j b3, a lane's two neighbouring columns f a
        // 32-bit word of W3's rows
        for (int f = 2 * lane; f < feat; f += 64) {
            float v0 = S * ld(b3[b3o + f]), v1 = S * ld(b3[b3o + f + 1]);
#pragma unroll 32
            for (int k = 0; k < kH2; ++k) {
                const unsigned wk = *reinterpret_cast<const unsigned*>(
                    w3 + w3o + k * feat + f);
                v0 = fmaf(aj[k], lo_bf16(wk), v0);
                v1 = fmaf(aj[k], hi_bf16(wk), v1);
            }
            *reinterpret_cast<float2*>(dwh + (size_t)(mrow + j) * feat + f) =
                make_float2(v0, v1);
        }
        __syncwarp();            // aj is the next column's
    }
    // the warp's partial slot (the finalize adds the slots): dW2 in the
    // fragment order of its shared array, then db2, dW1, db1
    __syncwarp();
    float* const part = partial + (((size_t)m * gridDim.x + blockIdx.x) * kWarps + warp) * kPartial;
#pragma unroll
    for (int i = 0; i < 2 * kN2; ++i)
        reinterpret_cast<float4*>(part)[i * 32 + lane] = dw2[i * 32 + lane];
    for (int e = lane; e < kH2; e += 32) part[kH1 * kH2 + e] = db2[e];
    for (int e = lane; e < kTail; e += 32) part[kH1 * kH2 + kH2 + e] = dw1[e];
}

#ifdef SA_BF16_ENTRIES
// The bf16 entries' dkv kernels: dkv_mma, in the primary template's
// signature (the launches, trace names and ptxas lines of the float one's);
// only the *_bf16.cu translation units (SA_BF16_ENTRIES) see them.
#define SA_DKV_MMA_PARAMS                                                    \
    const float4* __restrict__ x4, const int* __restrict__ ids,              \
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ g,    \
        const float2* __restrict__ stats, const float* __restrict__ r,       \
        const float* __restrict__ u, const float* __restrict__ cvec,         \
        const __nv_bfloat16* __restrict__ w1,                                \
        const __nv_bfloat16* __restrict__ b1,                                \
        const __nv_bfloat16* __restrict__ w2,                                \
        const __nv_bfloat16* __restrict__ b2,                                \
        const __nv_bfloat16* __restrict__ w3,                                \
        const __nv_bfloat16* __restrict__ b3, float4* __restrict__ dx,       \
        float* __restrict__ dh, float* __restrict__ dwh,                     \
        float* __restrict__ a_sum, float* __restrict__ s_sum,                \
        float* __restrict__ partial, const int n, const int hdim,            \
        const int feat, const int w, const Members ms
// The bf16 dkv's resident blocks an SM (at most 168 registers a thread).
// kernels/social_attention.py's _MMA_DKV_MAX_BLOCKS caps the grid at this
// many on each of an H100's 132 SMs and must match it (a test reads this
// line).
constexpr int kMmaDkvMinBlocks = 3;
#define SA_DKV_MMA_ARGS x4, ids, h, g, stats, r, u, cvec, w1, b1, w2, b2, w3, \
    b3, dx, dh, dwh, a_sum, s_sum, partial, n, hdim, feat, w, ms

template <>
__global__ void __launch_bounds__(kThreads, kMmaDkvMinBlocks)
bwd_dkv_kernel<__nv_bfloat16, false>(SA_DKV_MMA_PARAMS) {
    dkv_mma<false>(SA_DKV_MMA_ARGS);
}

template <>
__global__ void __launch_bounds__(kThreads, kMmaDkvMinBlocks)
bwd_dkv_kernel<__nv_bfloat16, true>(SA_DKV_MMA_PARAMS) {
    dkv_mma<true>(SA_DKV_MMA_ARGS);
}

#undef SA_DKV_MMA_PARAMS
#undef SA_DKV_MMA_ARGS
#endif  // SA_BF16_ENTRIES

// Second pass, kFinThreads threads a block.  The first kW3Tiles x F/16
// blocks: kW3Rows rows of [dW3; db3] (65 x F) = sum_j [A_j; S_j] (x) wh_j for
// 16 columns, the N terms in kW3Slices strided slices.  The other
// kPartBlocks blocks: kPartCols elements of dmlp12 = dW2 | db2 | dW1 | db1,
// the dkv blocks' partials in kPartSlices strided slices.  The slices are
// then added in a fixed tree: groups of kGroup in order, then the groups in
// order.  Deterministic, no atomics.
template <typename T>
__global__ void __launch_bounds__(kFinThreads)
bwd_finalize_kernel(const T* __restrict__ wh,
                    const float* __restrict__ a_sum,
                    const float* __restrict__ s_sum,
                    const float* __restrict__ partial,
                    float* __restrict__ dw3, float* __restrict__ db3,
                    float* __restrict__ dmlp12, const int n, const int feat,
                    const int n_slots, const Members ms) {
    __shared__ float red[kFinThreads * kW3Rows];
    __shared__ float red2[kFinThreads * kW3Rows / kGroup];
    const int t = threadIdx.x;
    // member m: wh at m ms.wh rows, a_sum and s_sum at m N, its n_slots
    // partial slots and its outputs after the members before it
    const int m = member(), mrow = m * n, whrow = m * ms.wh;
    pdl_wait();                  // the dkv kernel's sums are complete
    const int f_tiles = feat / 16, w3_blocks = kW3Tiles * f_tiles;
    if ((int)blockIdx.x < w3_blocks) {
        const int kt = blockIdx.x / f_tiles, fc = blockIdx.x - kt * f_tiles;
        const int fl = t & 15, slice = t >> 4, f = fc * 16 + fl;
        float acc[kW3Rows];
#pragma unroll
        for (int q = 0; q < kW3Rows; ++q) acc[q] = 0.f;
#pragma unroll 4
        for (int j = slice; j < n; j += kW3Slices) {
            const float w = ld(wh[(size_t)(whrow + j) * feat + f]);
#pragma unroll
            for (int q = 0; q < kW3Rows; ++q) {
                const int k = kt * kW3Rows + q;
                if (k < kH2) acc[q] = fmaf(a_sum[(size_t)(mrow + j) * kH2 + k], w, acc[q]);
                else if (k == kH2) acc[q] = fmaf(s_sum[mrow + j], w, acc[q]);
            }
        }
        // red [kW3Rows][kW3Slices][16], red2 [kW3Rows][kW3Slices / kGroup][16]
#pragma unroll
        for (int q = 0; q < kW3Rows; ++q) red[(q * kW3Slices + slice) * 16 + fl] = acc[q];
        __syncthreads();
        constexpr int groups = kW3Slices / kGroup;
        if (t < kW3Rows * groups * 16) {
            const int q = t / (groups * 16), gr = (t / 16) % groups;
            float s = 0.f;
            for (int sl = gr * kGroup; sl < (gr + 1) * kGroup; ++sl)
                s += red[(q * kW3Slices + sl) * 16 + fl];
            red2[(q * groups + gr) * 16 + fl] = s;
        }
        __syncthreads();
        if (t < kW3Rows * 16) {
            const int q = t >> 4, k = kt * kW3Rows + q, fo = fc * 16 + fl;
            float s = 0.f;
            for (int gr = 0; gr < groups; ++gr) s += red2[(q * groups + gr) * 16 + fl];
            if (k < kH2) (dw3 + (size_t)m * kH2 * feat)[k * feat + fo] = s;
            else if (k == kH2) (db3 + (size_t)m * feat)[fo] = s;
        }
        return;
    }
    const int col = t % kPartCols, slice = t / kPartCols;
    const int e = ((int)blockIdx.x - w3_blocks) * kPartCols + col;
    float acc = 0.f;
    if (e < kPartial)
#pragma unroll 4
        for (int b = slice; b < n_slots; b += kPartSlices)
            acc += partial[((size_t)m * n_slots + b) * kPartial + e];
    red[slice * kPartCols + col] = acc;      // [kPartSlices][kPartCols]
    __syncthreads();
    constexpr int groups = kPartSlices / kGroup;
    if (t < groups * kPartCols) {
        const int gr = t / kPartCols;
        float s = 0.f;
        for (int sl = gr * kGroup; sl < (gr + 1) * kGroup; ++sl)
            s += red[sl * kPartCols + col];
        red2[gr * kPartCols + col] = s;
    }
    __syncthreads();
    if (t < kPartCols && e < kPartial) {
        float s = 0.f;
        for (int gr = 0; gr < groups; ++gr) s += red2[gr * kPartCols + t];
        (dmlp12 + (size_t)m * kPartial)[e] = s;
    }
}

#ifdef SA_BF16_ENTRIES
// The bf16 entries' finalize: bwd_finalize_kernel's sums in its fixed trees,
// with the rows of [dW3; db3] kW3RowsM = 2 a block (132 blocks at F = 64,
// one an SM, instead of 68) and a row's two A_j values read with one 8-byte
// load, eight j of a slice in flight.
template <>
__global__ void __launch_bounds__(kFinThreads)
bwd_finalize_kernel<__nv_bfloat16>(const __nv_bfloat16* __restrict__ wh,
                                   const float* __restrict__ a_sum,
                                   const float* __restrict__ s_sum,
                                   const float* __restrict__ partial,
                                   float* __restrict__ dw3,
                                   float* __restrict__ db3,
                                   float* __restrict__ dmlp12, const int n,
                                   const int feat, const int n_slots,
                                   const Members ms) {
    __shared__ float red[kFinThreads * kW3RowsM];
    __shared__ float red2[kFinThreads * kW3RowsM / kGroup];
    const int t = threadIdx.x;
    const int m = member(), mrow = m * n, whrow = m * ms.wh;
    pdl_wait();                  // the dkv kernel's sums are complete
    const int f_tiles = feat / 16, w3_blocks = kW3TilesM * f_tiles;
    if ((int)blockIdx.x < w3_blocks) {
        const int kt = blockIdx.x / f_tiles, fc = blockIdx.x - kt * f_tiles;
        const int fl = t & 15, slice = t >> 4, f = fc * 16 + fl;
        const int k0 = kt * kW3RowsM;
        float acc0 = 0.f, acc1 = 0.f;
        if (k0 < kH2) {
#pragma unroll 8
            for (int j = slice; j < n; j += kW3Slices) {
                const float w = ld(wh[(size_t)(whrow + j) * feat + f]);
                const float2 a = *reinterpret_cast<const float2*>(
                    a_sum + (size_t)(mrow + j) * kH2 + k0);
                acc0 = fmaf(a.x, w, acc0);
                acc1 = fmaf(a.y, w, acc1);
            }
        } else {
#pragma unroll 8
            for (int j = slice; j < n; j += kW3Slices)
                acc0 = fmaf(s_sum[mrow + j],
                            ld(wh[(size_t)(whrow + j) * feat + f]), acc0);
        }
        red[slice * 16 + fl] = acc0;
        red[(kW3Slices + slice) * 16 + fl] = acc1;
        __syncthreads();
        constexpr int groups = kW3Slices / kGroup;
        if (t < kW3RowsM * groups * 16) {
            const int q = t / (groups * 16), gr = (t / 16) % groups;
            float s = 0.f;
            for (int sl = gr * kGroup; sl < (gr + 1) * kGroup; ++sl)
                s += red[(q * kW3Slices + sl) * 16 + fl];
            red2[(q * groups + gr) * 16 + fl] = s;
        }
        __syncthreads();
        if (t < kW3RowsM * 16) {
            const int q = t >> 4, k = k0 + q, fo = fc * 16 + fl;
            float s = 0.f;
            for (int gr = 0; gr < groups; ++gr) s += red2[(q * groups + gr) * 16 + fl];
            if (k < kH2) (dw3 + (size_t)m * kH2 * feat)[k * feat + fo] = s;
            else if (k == kH2) (db3 + (size_t)m * feat)[fo] = s;
        }
        return;
    }
    // the warps' slots (dkv_mma): dW2[k1][o] at its fragment position
    const int col = t % kPartCols, slice = t / kPartCols;
    const int e = ((int)blockIdx.x - w3_blocks) * kPartCols + col;
    int at = e;
    if (e < kH1 * kH2) {
        const int k1 = e / kH2, o = e - k1 * kH2;
        at = 4 * (((k1 >> 4) * kN2 + (o >> 3)) * 32 + 4 * (k1 & 7) + ((o & 7) >> 1)) +
             2 * ((k1 >> 3) & 1) + (o & 1);
    }
    float acc = 0.f;
    if (e < kPartial)
#pragma unroll 4
        for (int b = slice; b < n_slots; b += kPartSlices)
            acc += partial[((size_t)m * n_slots + b) * kPartial + at];
    red[slice * kPartCols + col] = acc;      // [kPartSlices][kPartCols]
    __syncthreads();
    constexpr int groups = kPartSlices / kGroup;
    if (t < groups * kPartCols) {
        const int gr = t / kPartCols;
        float s = 0.f;
        for (int sl = gr * kGroup; sl < (gr + 1) * kGroup; ++sl)
            s += red[sl * kPartCols + col];
        red2[gr * kPartCols + col] = s;
    }
    __syncthreads();
    if (t < kPartCols && e < kPartial) {
        float s = 0.f;
        for (int gr = 0; gr < groups; ++gr) s += red2[gr * kPartCols + t];
        (dmlp12 + (size_t)m * kPartial)[e] = s;
    }
}
#endif  // SA_BF16_ENTRIES

// dx_i [M, N, 4] from the forward's u [M, N, 64] and c [M, N]: one launch
// of `blocks` x `members` blocks, each walking row tiles blockIdx.x,
// blockIdx.x + blocks, ... of member blockIdx.y (bf16: each warp rows of
// the grid's warp stride); g, stats and r are [M, N,
// ...] too; `strides` are the member strides of x4, ids, h and w1..b2
// (MemberStrides, checked by members_of; null for a single model, M = 1).
// Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError(), or cudaErrorInvalidValue
// for blocks <= 0, an H the kernel does not take (width_ok: a multiple of
// 16, up to kNarrowWidth for the narrow kernel), bad member strides or a
// scene window max_scene < 0 (0: every tile scans all N).  h and w1..b2
// are T.
template <typename T, bool kWide>
int launch_dq(const void* x4, const void* ids, const void* h, const void* g,
              const void* stats, const void* r, const void* u, const void* c,
              const void* w1, const void* b1, const void* w2, const void* b2,
              void* dx, int n, int hdim, int blocks, int max_scene,
              int members, const void* strides, void* stream) {
    Members ms{};
    if (max_scene < 0 || !members_of(strides, members, n, hdim, 0, ms))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    if (blocks <= 0 || !width_ok(hdim, kWide))
        return (int)cudaErrorInvalidValue;
    bwd_dq_kernel<T, kWide><<<dim3(blocks, members), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x4), static_cast<const int*>(ids),
        static_cast<const T*>(h), static_cast<const float*>(g),
        static_cast<const float2*>(stats), static_cast<const float*>(r),
        static_cast<const float*>(u), static_cast<const float*>(c),
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(b2),
        static_cast<float4*>(dx), n, hdim, max_scene, ms);
    return (int)cudaGetLastError();
}

// dx_j [M, N, 4] (skipped when dx is null), dh_j [M, N, H], dwh_j [M, N,
// F], dw3 [M, 64, F], db3 [M, F] and dmlp12 [M, 2240] = dW2 [32, 64] | db2
// [64] | dW1 [3, 32] | db1 [32] a member, from the forward's u [M, N, 64]
// and c [M, N]; g, stats and r are [M, N, ...]; `strides` are the member
// strides of x4, ids, h, wh and w1..b3 (MemberStrides, checked by
// members_of; null for a single model, M = 1).
// `blocks` x `members` dkv blocks, one partial slot each (bf16: one a warp):
// a_sum [M, N, 64], s_sum [M, N] and partial [partial_floats] are scratch.
// A partial_floats other than members x blocks x kPartial (bf16: x kWarps;
// the caller sized its slots or dmlp12 differently) is refused with
// cudaErrorInvalidValue, as are bad
// member strides and a scene window max_scene < 0 (0: every column tile
// scans all N; a column's partners lie in the same window as a row's).
// Two launches: dkv, then finalize.  h, wh and w1..b3 are T; every output
// is float.  kWide takes any H and F in multiples of 16, the narrow kernel
// up to kNarrowWidth (width_ok).
template <typename T, bool kWide>
int launch_dkv(const void* x4, const void* ids, const void* h, const void* wh,
               const void* g, const void* stats, const void* r, const void* u,
               const void* c, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* w3, const void* b3, void* a_sum,
               void* s_sum, void* partial, void* dx, void* dh, void* dwh,
               void* dw3, void* db3, void* dmlp12, int n, int hdim, int feat,
               int blocks, int partial_floats, int max_scene, int members,
               const void* strides, void* stream) {
    Members ms{};
    if (max_scene < 0 || !members_of(strides, members, n, hdim, feat, ms))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    // partial slots a block: the bf16 dkv's warps keep one each
    constexpr int slots = std::is_same_v<T, float> ? 1 : kWarps;
    if (blocks <= 0 || !width_ok(hdim, kWide) || !width_ok(feat, kWide) ||
        (long long)partial_floats !=
            (long long)members * blocks * slots * kPartial)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bwd_dkv_kernel<T, kWide><<<dim3(blocks, members), kThreads, 0, st>>>(
        static_cast<const float4*>(x4), static_cast<const int*>(ids),
        static_cast<const T*>(h), static_cast<const float*>(g),
        static_cast<const float2*>(stats), static_cast<const float*>(r),
        static_cast<const float*>(u), static_cast<const float*>(c),
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(b2),
        static_cast<const T*>(w3), static_cast<const T*>(b3),
        static_cast<float4*>(dx), static_cast<float*>(dh),
        static_cast<float*>(dwh), static_cast<float*>(a_sum),
        static_cast<float*>(s_sum), static_cast<float*>(partial), n, hdim,
        feat, max_scene, ms);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the bf16 finalize takes the rows of [dW3; db3] kW3RowsM a block
    constexpr int w3_tiles = std::is_same_v<T, float> ? kW3Tiles : kW3TilesM;
    return (int)launch_dependent(
        bwd_finalize_kernel<T>,
        dim3(w3_tiles * (feat / 16) + kPartBlocks, members),
        dim3(kFinThreads), 0, st, static_cast<const T*>(wh),
        static_cast<const float*>(a_sum), static_cast<const float*>(s_sum),
        static_cast<const float*>(partial), static_cast<float*>(dw3),
        static_cast<float*>(db3), static_cast<float*>(dmlp12), n, feat,
        blocks * slots, ms);
}

}  // namespace

// The C entries: float operands, and bf16 (h, wh and the weights bf16;
// x4, g, stats, r, u, c and every output float); `members` stacked
// models, their strides as in the forward's entries.
#define SA_DQ_ARGS                                                         \
    const void *x4, const void *ids, const void *h, const void *g,         \
        const void *stats, const void *r, const void *u, const void *c,    \
        const void *w1, const void *b1, const void *w2, const void *b2,    \
        void *dx, int n, int hdim, int blocks, int max_scene, int members, \
        const void *strides, void *stream
#define SA_DQ_PASS x4, ids, h, g, stats, r, u, c, w1, b1, w2, b2, dx, n, \
    hdim, blocks, max_scene, members, strides, stream
#define SA_DKV_ARGS                                                        \
    const void *x4, const void *ids, const void *h, const void *wh,        \
        const void *g, const void *stats, const void *r, const void *u,    \
        const void *c, const void *w1, const void *b1, const void *w2,     \
        const void *b2, const void *w3, const void *b3, void *a_sum,       \
        void *s_sum, void *partial, void *dx, void *dh, void *dwh,         \
        void *dw3, void *db3, void *dmlp12, int n, int hdim, int feat,     \
        int blocks, int partial_floats, int max_scene, int members,        \
        const void *strides, void *stream
#define SA_DKV_PASS x4, ids, h, wh, g, stats, r, u, c, w1, b1, w2, b2, w3, \
    b3, a_sum, s_sum, partial, dx, dh, dwh, dw3, db3, dmlp12, n, hdim,      \
    feat, blocks, partial_floats, max_scene, members, strides, stream
