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
// scores rebuilt with the forward's rounding (social_attention_pairs.cuh),
// so a_ij renormalizes exactly against the forward's (m, l).  The relu masks
// come from the float pre-activations; dW2 = a1^T dz2 and dW1 take the
// rounded a1 and features, A_j the rounded a2.  Every cotangent stays
// float.  JAX's vjp rounds some per-tile cotangents to bf16 (the transpose
// of a bf16 dot returns bf16: the cotangents of a2, a1 and the features,
// and each tile's weight-gradient terms); these kernels keep them float,
// the more exact of the two.
//
// Widths.  The narrow kernels (kWide false) take H and F in multiples of
// 16 up to kNarrowWidth = 128 and are the code they were; the wide ones
// (kWide, entries social_attention_bwd_wide*.cu, translation units of
// their own) take any multiple of 16: dq reads g_i from device memory
// instead of staging it and forms g_i . h_j exactly (gh_exact), dkv
// stages h_j whole up to kStageWidth = 512 columns and above that
// kStageWidth columns at a time (gh_chunked), and keeps dh past the first
// 2 kThreads elements of a tile in the tile's own rows of dh (dh_wide).
//
// Bound on this card: operations.  Per same-scene pair dq does ~4.4k FMA
// (features, 3->32->64 recompute, score, g_i . h_j, the 64->32 and 32->3
// cotangents), dkv ~6.5k (the same plus the dW2 outer product); both are
// f32 FMA work against ~2 KB of bytes a row.  The pair intermediates never
// reach device memory, and pairs outside a scene cost one id test.

#include <cuda_runtime.h>

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
// gi 16-byte aligned, hj aligned to 4 elements, H a multiple of 4.
template <typename T>
__device__ __forceinline__ float gh_serial(const float* gi, const T* hj,
                                           const int hdim) {
    const float4* g4 = reinterpret_cast<const float4*>(gi);
    float gh = 0.f;
#pragma unroll 4
    for (int q = 0; q < hdim / 4; ++q) {
        const float4 a = g4[q], b = ld4(hj, q);
        gh = fmaf(a.x, b.x, gh);
        gh = fmaf(a.y, b.y, gh);
        gh = fmaf(a.z, b.z, gh);
        gh = fmaf(a.w, b.w, gh);
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

// dx_i [M, N, 4] from the forward's u [M, N, 64] and c [M, N]: one launch
// of `blocks` x `members` blocks, each walking row tiles blockIdx.x,
// blockIdx.x + blocks, ... of member blockIdx.y; g, stats and r are [M, N,
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
// `blocks` x `members` dkv blocks, one partial slot each: a_sum [M, N, 64],
// s_sum [M, N] and partial [partial_floats] are scratch.  A partial_floats
// other than members x blocks x kPartial (the caller sized its slots or
// dmlp12 differently) is refused with cudaErrorInvalidValue, as are bad
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
    if (blocks <= 0 || !width_ok(hdim, kWide) || !width_ok(feat, kWide) ||
        (long long)partial_floats !=
            (long long)members * blocks * kPartial)
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
    return (int)launch_dependent(
        bwd_finalize_kernel<T>,
        dim3(kW3Tiles * (feat / 16) + kPartBlocks, members),
        dim3(kFinThreads), 0, st, static_cast<const T*>(wh),
        static_cast<const float*>(a_sum), static_cast<const float*>(s_sum),
        static_cast<const float*>(partial), static_cast<float*>(dw3),
        static_cast<float*>(db3), static_cast<float*>(dmlp12), n, feat,
        blocks, ms);
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
