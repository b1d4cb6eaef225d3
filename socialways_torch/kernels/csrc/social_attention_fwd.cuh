#pragma once

// Fused social-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel socialways_tpu/kernels/social_attention.py
// `_kernel` (:150-198, driven by `_pallas_forward`, :219-314).  For every
// query agent i it computes, over the agents j of the same scene (both
// valid, j != i):
//   features  dist, bearing, dca   from the last-frame states x4 (eps 1e-6)
//   embedding f_ij = W3 relu(W2 relu(W1 feat + b1) + b2) + b3   (3->32->64->F)
//   score     s_ij = f_ij . wh_j = a2_ij . u_j + c_j
//             with u_j = W3 wh_j [64] and c_j = b3 . wh_j  (wh = h W + b,
//             computed outside)
//   out_i     = sum_j softmax_j(s_ij) h_j  with an online softmax;
//             a row with no neighbour gives 0.
//   stats_i   = (m_i, l_i), the softmax max and normalizer, when the caller
//             passes a stats buffer (training: the backward kernels rebuild
//             a_ij from them); m starts at -1e9 and l at 0, so a row with no
//             neighbour keeps (-1e9, 0), as the TPU kernel's :190-198.
// u and c are outputs too: the backward reads them instead of rebuilding
// them.  The result equals socialways_torch/ops/social.py's dense form up to
// the order of float sums.
//
// bf16 operands (social_attention_fwd_bf16): h, wh and the weights are
// bf16, rounded where the Pallas kernel casts (social_attention_pairs.cuh);
// u and c are float sums of bf16 values (JAX's f . wh up to the order of
// the sum); p is rounded before p . h while l sums the unrounded p; out,
// stats, u and c stay float.  The bf16 kernels are u_prep_mma and fwd_mma
// (below: a warp a query row, the pair MLP and u on the tensor cores); the
// online softmax rounds p against the running max of its m-tile of 16
// pairs, the Pallas kernel against that of its 64-column tile: where a
// row's max moves between the two the roundings differ, by at most half a
// bf16 ulp of each term.
//
// Design (social_attention_pairs.cuh has the shared pair machinery).
// - Prologue `u_prep_kernel`: u and c once per agent, 8 agents a block, W3
//   staged transposed in shared memory.  A block of the main kernel needs u
//   for every column its rows pair with, a whole scene; computing them
//   there would repeat N x 64 x F MAC once per tile of each scene, while the
//   prologue does it once, at the cost of one more launch.  The main kernel
//   is launched as its programmatic dependent: it loads the weights, scans
//   the ids and runs both MLP layers of its first batch while the prologue
//   runs, and waits for it only before reading u and c.
// - Main kernel: a block owns a tile of kTile = 2 query rows (128 blocks at
//   N = 256, so the grid covers the 132 SMs), finds their same-scene
//   columns by id tests, and takes the pairs in batches of 32 through the
//   pair MLP with all 128 threads (the 32 -> 64 layer register-tiled, 4
//   pairs x 4 outputs a thread).  The online softmax carries (m, l) and the
//   H-wide accumulator from batch to batch, so shared memory is fixed
//   (~19 KB) whatever the scene size.
//
// Widths.  The narrow kernels (kWide false) take H and F in multiples of
// 16 up to kNarrowWidth = 128 and are the code they were; the wide ones
// (kWide, entries social_attention_fwd_wide*.cu, translation units of
// their own) take any multiple of 16: u_prep stages W3 and wh in chunks
// of 128 columns of F (u_prep_wide), and the pooled sum keeps its
// elements past the first 2 kThreads of a tile in the tile's own rows of
// out (pool_wide) instead of registers, so neither shared memory nor
// registers grow with the width.  The wrappers pad other widths with zeros.
//
// Bound on this card: operations, at the shapes the model runs (N = 256
// rows in scenes of 2-16 agents, H = F = 64): the same-scene pairs times
// 2.2k MAC of f32 FMA, plus N x 64 x F for u, against ~0.2 MB of bytes.  At
// N = 256 that is well under a microsecond, below what a launch takes: the
// design fills the card and keeps the pair intermediates in shared memory
// and registers; what is left is the latency of its phases.

#include <cuda_runtime.h>

#include <type_traits>

#include "social_attention_pairs.cuh"

namespace {

using namespace sa;

constexpr int kPrepRows = 8;        // agents a u_prep block

// The wide u = wh W3^T and c = wh . b3 (F above kNarrowWidth): F in chunks of
// kNarrowWidth columns staged as the narrow kernel stages all of F, each
// sum carried on from chunk to chunk in the order f = 0 .. F - 1.
template <typename T>
__device__ __forceinline__ void u_prep_wide(
        const T* __restrict__ wh, const T* __restrict__ w3,
        const T* __restrict__ b3, float* __restrict__ u,
        float* __restrict__ c, const int n, const int feat, const int mrow,
        const int whrow, const int row0, float* s_w3t,
        float (*s_wh)[kNarrowWidth]) {
    const int k = threadIdx.x & (kH2 - 1), r0 = (threadIdx.x >> 6) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, cs = 0.f;
#pragma unroll 1
    for (int f0 = 0; f0 < feat; f0 += kNarrowWidth) {
        const int fw = feat - f0 < kNarrowWidth ? feat - f0 : kNarrowWidth;
        const int f4 = fw / 4;
        if (f0 > 0) __syncthreads();     // the chunk before is read
        for (int e = threadIdx.x; e < kH2 * f4; e += kThreads) {
            const int kk = e / f4, f = 4 * (e - kk * f4);
            const float4 v = ld4(w3, (kk * feat + f0 + f) / 4);
            s_w3t[f * (kH2 + 1) + kk] = v.x;
            s_w3t[(f + 1) * (kH2 + 1) + kk] = v.y;
            s_w3t[(f + 2) * (kH2 + 1) + kk] = v.z;
            s_w3t[(f + 3) * (kH2 + 1) + kk] = v.w;
        }
        for (int e = threadIdx.x; e < kPrepRows * f4; e += kThreads) {
            const int r = e / f4, f = 4 * (e - r * f4);
            const float4 v = row0 + r < n
                ? ld4(wh + (size_t)(whrow + row0 + r) * feat, (f0 + f) / 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
            s_wh[r][f] = v.x; s_wh[r][f + 1] = v.y;
            s_wh[r][f + 2] = v.z; s_wh[r][f + 3] = v.w;
        }
        __syncthreads();
        for (int f = 0; f < fw; ++f) {
            const float w = s_w3t[f * (kH2 + 1) + k];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] = fmaf(w, s_wh[r0 + q][f], acc[q]);
        }
        if (threadIdx.x < kPrepRows)
            for (int f = 0; f < fw; ++f)
                cs = fmaf(ld(b3[f0 + f]), s_wh[threadIdx.x][f], cs);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (row0 + r0 + q < n)
            u[(size_t)(mrow + row0 + r0 + q) * kH2 + k] = acc[q];
    if (threadIdx.x < kPrepRows && row0 + threadIdx.x < n)
        c[mrow + row0 + threadIdx.x] = cs;
}

// u = wh W3^T [N, 64], c = wh . b3 [N] of member blockIdx.y; kWide takes
// F above kNarrowWidth (u_prep_wide), the narrow kernel all of F at once.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
u_prep_kernel(const T* __restrict__ wh, const T* __restrict__ w3,
              const T* __restrict__ b3, float* __restrict__ u,
              float* __restrict__ c, const int n, const int feat,
              const Members ms) {
    // bf16 operands take u_prep_mma (the specializations below)
    static_assert(std::is_same_v<T, float>, "bf16: define SA_BF16_ENTRIES");
    __shared__ float s_w3t[kNarrowWidth * (kH2 + 1)];    // W3^T [F][64 + 1]
    __shared__ float s_wh[kPrepRows][kNarrowWidth];
    pdl_launch_dependents();     // the main kernel may start its prefix now
    const int m = member(), mrow = m * n, whrow = m * ms.wh;
    w3 += m * ms.w3;
    b3 += m * ms.b3;
    const int row0 = blockIdx.x * kPrepRows, f4 = feat / 4;
    if constexpr (kWide) {
        u_prep_wide(wh, w3, b3, u, c, n, feat, mrow, whrow, row0, s_w3t,
                    s_wh);
        return;
    }
    // the narrow kernel: all of F (at most kNarrowWidth) staged at once
#pragma unroll 4
    for (int e = threadIdx.x; e < kH2 * f4; e += kThreads) {
        const int k = e / f4, f = 4 * (e - k * f4);
        const float4 v = ld4(w3, e);
        s_w3t[f * (kH2 + 1) + k] = v.x;
        s_w3t[(f + 1) * (kH2 + 1) + k] = v.y;
        s_w3t[(f + 2) * (kH2 + 1) + k] = v.z;
        s_w3t[(f + 3) * (kH2 + 1) + k] = v.w;
    }
    for (int e = threadIdx.x; e < kPrepRows * f4; e += kThreads) {
        const int r = e / f4, f = 4 * (e - r * f4);
        const float4 v = row0 + r < n
            ? ld4(wh + (size_t)(whrow + row0 + r) * feat, f / 4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        s_wh[r][f] = v.x; s_wh[r][f + 1] = v.y;
        s_wh[r][f + 2] = v.z; s_wh[r][f + 3] = v.w;
    }
    __syncthreads();
    const int k = threadIdx.x & (kH2 - 1), r0 = (threadIdx.x >> 6) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int f = 0; f < feat; ++f) {
        const float w = s_w3t[f * (kH2 + 1) + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(w, s_wh[r0 + q][f], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (row0 + r0 + q < n)
            u[(size_t)(mrow + row0 + r0 + q) * kH2 + k] = acc[q];
    if (threadIdx.x < kPrepRows && row0 + threadIdx.x < n) {
        float s = 0.f;
        for (int f = 0; f < feat; ++f)
            s = fmaf(ld(b3[f]), s_wh[threadIdx.x][f], s);
        c[mrow + row0 + threadIdx.x] = s;
    }
}

// The wide pooled sum (H above kNarrowWidth): element e >= 2 kThreads of
// the tile's [kTile][hdim] accumulates in the tile's own row of out, which
// only this thread touches: zeroed (step 0), one batch's pairs added the
// way the registers add theirs (step 1), normalized (step 2).
template <typename T>
__device__ __forceinline__ void pool_wide(
        const int step, float* __restrict__ out, const int n, const int row0,
        const int hdim, const int nb, const float* s_corr, const int* s_slot,
        const int* s_col, const float* s_p, const float* s_l,
        const T* __restrict__ h) {
#pragma unroll 1
    for (int e = threadIdx.x + 2 * kThreads; e < tile_elems(n, row0, hdim);
         e += kThreads) {
        float* const o = out + (size_t)row0 * hdim + e;
        const int t = e / hdim, d = e - t * hdim;
        if (step == 0) {
            *o = 0.f;
        } else if (step == 1) {
            float a = *o * s_corr[t];
            for (int p = 0; p < nb; ++p)
                if (s_slot[p] == t)
                    a = fmaf(s_p[p], ld(h[(size_t)s_col[p] * hdim + d]), a);
            *o = a;
        } else {
            const float l = s_l[t];
            *o = l > 0.f ? *o / fmaxf(l, 1e-20f) : 0.f;
        }
    }
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
social_attention_fwd_kernel(const float4* __restrict__ x4,
                            const int* __restrict__ ids,
                            const T* __restrict__ h,
                            const float* __restrict__ u,
                            const float* __restrict__ cvec,
                            const T* __restrict__ w1,
                            const T* __restrict__ b1,
                            const T* __restrict__ w2,
                            const T* __restrict__ b2,
                            float* __restrict__ out,
                            float2* __restrict__ stats,
                            const int n, const int hdim, const int w,
                            const Members ms) {
    // bf16 operands take fwd_mma (the specializations below): this body
    // runs for float alone
    static_assert(std::is_same_v<T, float>, "bf16: define SA_BF16_ENTRIES");
    __shared__ __align__(16) float s_w2[kH1 * kH2];
    __shared__ __align__(16) float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];
    __shared__ __align__(16) float s_a1[kH1 * kA1Stride];   // a1^T
    __shared__ float s_feat[kIn * kBatch];
    __shared__ float s_s[kBatch], s_p[kBatch];
    __shared__ int s_col[kBatch], s_slot[kBatch];
    __shared__ float4 s_xt[kTile];
    __shared__ float s_m[kTile], s_l[kTile], s_corr[kTile];
    __shared__ int s_ring[kRing], s_scan[kWarps];

    // member m's slices: h, u, c, out, stats at m N rows; x4 and ids at
    // m ms.x4, m ms.ids rows (0 when shared); its weights at m ms.w*.  The
    // pointers move once, here: in this kernel that keeps fewer registers
    // than a row offset at every index (the backward kernels' way)
    const int m = member();
    const size_t mrow = (size_t)m * n;
    x4 += (size_t)m * ms.x4; ids += (size_t)m * ms.ids; h += mrow * hdim;
    u += mrow * kH2; cvec += mrow; out += mrow * hdim;
    if (stats != nullptr) stats += mrow;
    w1 += m * ms.w1; b1 += m * ms.b1; w2 += m * ms.w2; b2 += m * ms.b2;
    for (int t = threadIdx.x; t < kH1 * kH2 / 4; t += kThreads)
        reinterpret_cast<float4*>(s_w2)[t] = ld4(w2, t);
    for (int t = threadIdx.x; t < kH2; t += kThreads) s_b2[t] = ld(b2[t]);
    for (int t = threadIdx.x; t < kIn * kH1; t += kThreads) s_w1[t] = ld(w1[t]);
    for (int t = threadIdx.x; t < kH1; t += kThreads) s_b1[t] = ld(b1[t]);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
    const int n_tiles = (n + kTile - 1) / kTile;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row0 = tile * kTile;
        int tile_id[kTile], tile_idx[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            tile_idx[t] = row0 + t;
            tile_id[t] = row0 + t < n ? ids[row0 + t] : -1;
        }
        if (threadIdx.x < kTile) {
            const int i = row0 + threadIdx.x;
            s_xt[threadIdx.x] = i < n ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
            s_m[threadIdx.x] = kNeg;
            s_l[threadIdx.x] = 0.f;
        }
        // accumulator elements e = threadIdx.x + kThreads q of [kTile][hdim]
        // (kWide: the first 2 kThreads; pool_wide keeps the rest)
        float acc[2] = {0.f, 0.f};
        if constexpr (kWide)
            pool_wide(0, out, n, row0, hdim, 0, s_corr, s_slot, s_col, s_p,
                      s_l, h);
        PairRing pr = tile_ring(s_ring, s_scan, row0, n, w);
        __syncthreads();
        while (true) {
            fill_ring(pr, ids, 0, tile_id, tile_idx);
            if (pr.count == 0) break;
            const int nb = pr.count < kBatch ? pr.count : kBatch;
            // features, column and slot of each pair; 0 past nb
            if (threadIdx.x < kBatch) {
                const int p = threadIdx.x;
                float f[kIn] = {0.f, 0.f, 0.f};
                int col = 0, slot = 0;
                if (p < nb) {
                    const int e = s_ring[(pr.head + p) & (kRing - 1)];
                    col = e / kTile;
                    slot = e - col * kTile;
                    const float4 xi = s_xt[slot];
                    const Geo q = pair_geo(xi, speed(xi), x4[col]);
                    f[0] = q.feat[0]; f[1] = q.feat[1]; f[2] = q.feat[2];
                }
#pragma unroll
                for (int c = 0; c < kIn; ++c) s_feat[c * kBatch + p] = rnd<T>(f[c]);
                s_col[p] = col;
                s_slot[p] = slot;
            }
            __syncthreads();
            layer1<T>(s_feat, s_w1, s_b1, s_a1);
            __syncthreads();
            {
                float a2[4][4];
                layer2_tile<T>(s_a1, s_w2, kH2, s_b2, a2);
                pdl_wait();          // u and c come from u_prep_kernel
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int p = 4 * pg + i, col = s_col[p];
                    const float4 u4 = p < nb
                        ? reinterpret_cast<const float4*>(u + (size_t)col * kH2)[og]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
                    const float s = half_warp_sum(dot4(a2[i], u4));
                    if (og == 0) s_s[p] = p < nb ? s + cvec[col] : 0.f;
                }
            }
            __syncthreads();
            // online softmax of the batch, per tile row (warp 0, lane = pair)
            if (warp == 0) {
                const bool act = lane < nb;
                const int slot = s_slot[lane];
                const float s = s_s[lane];
                float pv = 0.f;
#pragma unroll
                for (int t = 0; t < kTile; ++t) {
                    const bool mine = act && slot == t;
                    const float m_old = s_m[t];
                    const float m_new = fmaxf(m_old, warp_max(mine ? s : kNeg));
                    const float e = mine ? expf(s - m_new) : 0.f;
                    if (mine) pv = e;
                    const float l_add = warp_sum(e);
                    if (lane == 0) {
                        const float corr = expf(m_old - m_new);
                        s_corr[t] = corr;
                        s_m[t] = m_new;
                        s_l[t] = s_l[t] * corr + l_add;
                    }
                }
                s_p[lane] = rnd<T>(pv);     // l summed the unrounded p
            }
            __syncthreads();
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int e = threadIdx.x + q * kThreads;
                if (e < kTile * hdim) {
                    const int t = e / hdim, d = e - t * hdim;
                    float a = acc[q] * s_corr[t];
                    for (int p = 0; p < nb; ++p)
                        if (s_slot[p] == t)
                            a = fmaf(s_p[p], ld(h[(size_t)s_col[p] * hdim + d]), a);
                    acc[q] = a;
                }
            }
            if constexpr (kWide)
                pool_wide(1, out, n, row0, hdim, nb, s_corr, s_slot, s_col,
                          s_p, s_l, h);
            pr.head = (pr.head + nb) & (kRing - 1);
            pr.count -= nb;
            __syncthreads();     // the batch's shared arrays are free
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int e = threadIdx.x + q * kThreads;
            if (e < kTile * hdim) {
                const int t = e / hdim, d = e - t * hdim;
                const float l = s_l[t];
                if (row0 + t < n)
                    out[(size_t)(row0 + t) * hdim + d] =
                        l > 0.f ? acc[q] / fmaxf(l, 1e-20f) : 0.f;
            }
        }
        if constexpr (kWide)
            pool_wide(2, out, n, row0, hdim, 0, s_corr, s_slot, s_col, s_p,
                      s_l, h);
        if (stats != nullptr && threadIdx.x < kTile && row0 + threadIdx.x < n)
            stats[row0 + threadIdx.x] = make_float2(s_m[threadIdx.x],
                                                    s_l[threadIdx.x]);
        __syncthreads();         // s_m, s_l, s_xt are the next tile's
    }
}

// p . h_j of a warp's m-tile over the 128 columns of h from c0, in pair
// order: acc[q][e] += p_k h_k[d], d = c0 + 2 (lane + 32 q) + e (a lane's
// two neighbouring columns a 32-bit word of h_k), the rows of eight pairs
// loaded at once.  pg, pg8: the p of pairs g and g + 8 (lanes 4 g hold
// them); col: pair lane & 15's column.
__device__ __forceinline__ void pool_slice(
        float (&acc)[kNarrowWidth / 64][2], const float pg, const float pg8,
        const int col, const __nv_bfloat16* __restrict__ h, const int hdim,
        const int c0, const int nb, const int lane) {
    for (int k0 = 0; k0 < nb; k0 += 8) {
        unsigned hv[8][kNarrowWidth / 64];
        float pk[8];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const int k = k0 + kk;
            pk[kk] = __shfl_sync(kFull, k < 8 ? pg : pg8, 4 * (k & 7));
            const unsigned* hk = reinterpret_cast<const unsigned*>(
                h + (size_t)__shfl_sync(kFull, col, k & 15) * hdim + c0);
#pragma unroll
            for (int q = 0; q < kNarrowWidth / 64; ++q)
                hv[kk][q] = k < nb && c0 + 2 * (lane + 32 * q) < hdim
                                ? hk[lane + 32 * q] : 0u;
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            if (k0 + kk < nb)
#pragma unroll
                for (int q = 0; q < kNarrowWidth / 64; ++q) {
                    acc[q][0] = fmaf(pk[kk], lo_bf16(hv[kk][q]), acc[q][0]);
                    acc[q][1] = fmaf(pk[kk], hi_bf16(hv[kk][q]), acc[q][1]);
                }
    }
}

// The bf16 forward on the tensor cores (social_attention_pairs.cuh, "bf16
// operands on Hopper's tensor cores").  Each warp owns one query row i at a
// time and walks rows with the stride of the grid's warps (the Python
// wrapper caps the grid, fwd_blocks), so W2's B fragments, W1, b1 and b2
// are staged once a block.  Per row: the warp scans [i - w, i + 1 + w)
// (all N for w = 0), takes its partners in m-tiles of 16 (a partner's
// features by lane p < 16, layer 1 into A fragments, layer2_scores), and
// runs the online softmax over each m-tile: m and l in every lane, p
// rounded to bf16 against the running max after the m-tile, the pooled sum
// out_i[d] of the first kNarrowWidth columns in registers (a lane's two
// neighbouring columns a 32-bit word of h_j, pool_slice; kWide: the rest
// in row i of out, which only this warp touches, a slice of 128 columns at
// a time, read and written once an m-tile).  A row's bits depend on its
// pairs alone: no block barrier after the staging, no cross-row sums, so
// neither the grid nor the window w changes them.
template <bool kWide>
__device__ __forceinline__ void fwd_mma(
        const float4* __restrict__ x4, const int* __restrict__ ids,
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ u,
        const float* __restrict__ cvec, const __nv_bfloat16* __restrict__ w1,
        const __nv_bfloat16* __restrict__ b1,
        const __nv_bfloat16* __restrict__ w2,
        const __nv_bfloat16* __restrict__ b2, float* __restrict__ out,
        float2* __restrict__ stats, const int n, const int hdim, const int w,
        const Members ms) {
    __shared__ __align__(16) uint2 s_w2f[kW2Frags];
    __shared__ __align__(16) float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];
    __shared__ int s_ring[kWarps][kWRing];

    // member m's slices, as the float kernel moves its pointers
    const int m = member();
    const size_t mrow = (size_t)m * n;
    x4 += (size_t)m * ms.x4; ids += (size_t)m * ms.ids; h += mrow * hdim;
    u += mrow * kH2; cvec += mrow; out += mrow * hdim;
    if (stats != nullptr) stats += mrow;
    w1 += m * ms.w1; b1 += m * ms.b1; w2 += m * ms.w2; b2 += m * ms.b2;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the warp's first row: its scan runs while u_prep_kernel does
    int i = blockIdx.x * kWarps + warp, sid = 0;
    WarpRing wr{s_ring[warp], 0, 0, 0, 0};
    if (i < n) {
        sid = ids[i];
        wr.next = w == 0 ? 0 : max(0, i - w);
        wr.end = w == 0 ? n : min(n, i + 1 + w);
        warp_fill(wr, ids, 0, sid, i);
    }
    stage_w2_frags(w2, s_w2f);
    for (int t = threadIdx.x; t < kH2; t += kThreads) s_b2[t] = ld(b2[t]);
    for (int t = threadIdx.x; t < kIn * kH1; t += kThreads) s_w1[t] = ld(w1[t]);
    for (int t = threadIdx.x; t < kH1; t += kThreads) s_b1[t] = ld(b1[t]);
    __syncthreads();
    // u and c come from u_prep_kernel.  The wait is block-uniform: placed
    // in a warp's own row loop (warps reach it at different times, some
    // never), it let reads of u race u_prep_kernel's writes (wrong scores
    // from stale memory, seen at N = 32,768)
    pdl_wait();

    const int g = lane >> 2, t = lane & 3, p = lane & 15;
    for (bool first = true; i < n; i += gridDim.x * kWarps, first = false) {
        if (!first) {
            sid = ids[i];
            wr = WarpRing{s_ring[warp], 0, 0, w == 0 ? 0 : max(0, i - w),
                          w == 0 ? n : min(n, i + 1 + w)};
        }
        const float4 xi = x4[i];
        const float vn = speed(xi);
        float mx = kNeg, l = 0.f;
        // the pooled sum: out_i[d], d = 2 (lane + 32 q) + e, in acc[q][e]
        float acc[kNarrowWidth / 64][2] = {{0.f, 0.f}, {0.f, 0.f}};
        float* const orow = out + (size_t)i * hdim;
        if constexpr (kWide)
            for (int d = kNarrowWidth + lane; d < hdim; d += 32) orow[d] = 0.f;
        while (true) {
            warp_fill(wr, ids, 0, sid, i);
            if (wr.count == 0) break;
            const int nb = wr.count < kMma ? wr.count : kMma;
            // lane p < nb: pair p's column and features (0 past nb)
            int col = 0;
            float f[kIn] = {0.f, 0.f, 0.f};
            if (p < nb) {
                col = wr.ring[(wr.head + p) & (kWRing - 1)];
                const Geo q = pair_geo(xi, vn, x4[col]);
#pragma unroll
                for (int c = 0; c < kIn; ++c) f[c] = rnd<__nv_bfloat16>(q.feat[c]);
            }
            float fg[kIn], fg8[kIn];
#pragma unroll
            for (int c = 0; c < kIn; ++c) {
                fg[c] = __shfl_sync(kFull, f[c], g);
                fg8[c] = __shfl_sync(kFull, f[c], g + 8);
            }
            const int colg = __shfl_sync(kFull, col, g);
            const int colg8 = __shfl_sync(kFull, col, g + 8);
            unsigned a[2][4];
            layer1_frags(fg, fg8, s_w1, s_b1, a);
            float a2[kN2][4];
            const float2 sc = layer2_scores(
                a, s_w2f, s_b2, u + (size_t)colg * kH2, u + (size_t)colg8 * kH2,
                cvec[colg], cvec[colg8], a2);
            // online softmax over the m-tile (every lane holds m and l)
            const bool vg = g < nb, vg8 = g + 8 < nb;
            const float m_new = fmaxf(mx, warp_max(fmaxf(vg ? sc.x : kNeg,
                                                         vg8 ? sc.y : kNeg)));
            const float corr = expf(mx - m_new);
            const float eg = vg ? expf(sc.x - m_new) : 0.f;
            const float eg8 = vg8 ? expf(sc.y - m_new) : 0.f;
            l = l * corr + warp_sum(t == 0 ? eg + eg8 : 0.f);
            mx = m_new;
            const float pg = rnd<__nv_bfloat16>(eg), pg8 = rnd<__nv_bfloat16>(eg8);
#pragma unroll
            for (int q = 0; q < kNarrowWidth / 64; ++q) {
                acc[q][0] *= corr;
                acc[q][1] *= corr;
            }
            // p . h_j in pair order (l summed the unrounded p); kWide: the
            // columns past kNarrowWidth a slice of 128 at a time, in row i
            // of out
            pool_slice(acc, pg, pg8, col, h, hdim, 0, nb, lane);
            if constexpr (kWide)
                for (int c0 = kNarrowWidth; c0 < hdim; c0 += kNarrowWidth) {
                    float2* const o2 = reinterpret_cast<float2*>(orow + c0);
                    float oc[kNarrowWidth / 64][2];
#pragma unroll
                    for (int q = 0; q < kNarrowWidth / 64; ++q) {
                        const bool in = c0 + 2 * (lane + 32 * q) < hdim;
                        const float2 v = in ? o2[lane + 32 * q] : make_float2(0.f, 0.f);
                        oc[q][0] = v.x * corr;
                        oc[q][1] = v.y * corr;
                    }
                    pool_slice(oc, pg, pg8, col, h, hdim, c0, nb, lane);
#pragma unroll
                    for (int q = 0; q < kNarrowWidth / 64; ++q)
                        if (c0 + 2 * (lane + 32 * q) < hdim)
                            o2[lane + 32 * q] = make_float2(oc[q][0], oc[q][1]);
                }
            wr.head = (wr.head + nb) & (kWRing - 1);
            wr.count -= nb;
        }
#pragma unroll
        for (int q = 0; q < kNarrowWidth / 64; ++q)
            if (2 * (lane + 32 * q) < hdim)
                reinterpret_cast<float2*>(orow)[lane + 32 * q] = make_float2(
                    l > 0.f ? acc[q][0] / fmaxf(l, 1e-20f) : 0.f,
                    l > 0.f ? acc[q][1] / fmaxf(l, 1e-20f) : 0.f);
        if constexpr (kWide)
            for (int d = kNarrowWidth + lane; d < hdim; d += 32)
                orow[d] = l > 0.f ? orow[d] / fmaxf(l, 1e-20f) : 0.f;
        if (stats != nullptr && lane == 0) stats[i] = make_float2(mx, l);
    }
}

// The bf16 u = wh W3^T and c = wh . b3 on the tensor cores: each warp takes
// 16 rows of wh as the A operand (k = f, any F in multiples of 16), W3's
// rows as the B operand (B[f][o] = W3[o][f]: f pairs are W3's own 32-bit
// words, read from the cached weights) and b3 as the first column of a
// ninth n-tile for c; the products of bf16 values summed in float (the
// operands' contract, JAX's f . wh up to the order of the sum).  A block
// of kWarps warps takes kWarps kMma rows.
__device__ __forceinline__ void u_prep_mma(
        const __nv_bfloat16* __restrict__ wh,
        const __nv_bfloat16* __restrict__ w3,
        const __nv_bfloat16* __restrict__ b3, float* __restrict__ u,
        float* __restrict__ c, const int n, const int feat,
        const Members ms) {
    const int m = member(), mrow = m * n, whrow = m * ms.wh;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kMma;
    if (r0 >= n) return;
    const int fw = feat / 2;    // 32-bit words a row of wh or W3
    const unsigned* const wa = reinterpret_cast<const unsigned*>(wh) +
                               (size_t)(whrow + min(r0 + g, n - 1)) * fw;
    const unsigned* const wb = reinterpret_cast<const unsigned*>(wh) +
                               (size_t)(whrow + min(r0 + g + 8, n - 1)) * fw;
    const unsigned* const w3w = reinterpret_cast<const unsigned*>(w3 + m * ms.w3);
    const unsigned* const b3w = reinterpret_cast<const unsigned*>(b3 + m * ms.b3);
    float acc[kN2 + 1][4];
#pragma unroll
    for (int nt = 0; nt <= kN2; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < feat / 16; ++ks) {
        const int f2 = 8 * ks + t;          // the word of f = 16 ks + 2 t
        const unsigned a[4] = {wa[f2], wb[f2], wa[f2 + 4], wb[f2 + 4]};
#pragma unroll
        for (int nt = 0; nt < kN2; ++nt) {
            const unsigned* wr = w3w + (size_t)(8 * nt + g) * fw;
            mma_bf16(acc[nt], a, wr[f2], wr[f2 + 4]);
        }
        mma_bf16(acc[kN2], a, g == 0 ? b3w[f2] : 0u, g == 0 ? b3w[f2 + 4] : 0u);
    }
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int nt = 0; nt < kN2; ++nt) {
        if (ra < n)
            *reinterpret_cast<float2*>(u + (size_t)(mrow + ra) * kH2 + 8 * nt + 2 * t) =
                make_float2(acc[nt][0], acc[nt][1]);
        if (rb < n)
            *reinterpret_cast<float2*>(u + (size_t)(mrow + rb) * kH2 + 8 * nt + 2 * t) =
                make_float2(acc[nt][2], acc[nt][3]);
    }
    if (t == 0) {
        if (ra < n) c[mrow + ra] = acc[kN2][0];
        if (rb < n) c[mrow + rb] = acc[kN2][2];
    }
}

#ifdef SA_BF16_ENTRIES
// The bf16 forward's resident blocks an SM (at most 128 registers a
// thread).  kernels/social_attention.py's _MMA_FWD_MAX_BLOCKS caps the grid
// at this many on each of an H100's 132 SMs and must match it (a test reads
// this line).
constexpr int kMmaFwdMinBlocks = 4;
// The bf16 entries' prologue: u_prep_mma (the same launch as the float
// prologue's, kWarps kMma rows a block, programmatic dependents alike).
template <>
__global__ void __launch_bounds__(kThreads)
u_prep_kernel<__nv_bfloat16, false>(
        const __nv_bfloat16* __restrict__ wh, const __nv_bfloat16* __restrict__ w3,
        const __nv_bfloat16* __restrict__ b3, float* __restrict__ u,
        float* __restrict__ c, const int n, const int feat, const Members ms) {
    pdl_launch_dependents();     // the main kernel may start its prefix now
    u_prep_mma(wh, w3, b3, u, c, n, feat, ms);
}

template <>
__global__ void __launch_bounds__(kThreads)
u_prep_kernel<__nv_bfloat16, true>(
        const __nv_bfloat16* __restrict__ wh, const __nv_bfloat16* __restrict__ w3,
        const __nv_bfloat16* __restrict__ b3, float* __restrict__ u,
        float* __restrict__ c, const int n, const int feat, const Members ms) {
    pdl_launch_dependents();
    u_prep_mma(wh, w3, b3, u, c, n, feat, ms);
}

// The bf16 entries' main kernels: fwd_mma, in the primary template's
// signature, so the launches, the names in a trace and ptxas's lines are
// those of the float kernel's.  Full specializations are compiled wherever
// they are seen: only the *_bf16.cu translation units (SA_BF16_ENTRIES)
// see them, so the float libraries hold no bf16 kernel.
template <>
__global__ void __launch_bounds__(kThreads, kMmaFwdMinBlocks)
social_attention_fwd_kernel<__nv_bfloat16, false>(
        const float4* __restrict__ x4, const int* __restrict__ ids,
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ u,
        const float* __restrict__ cvec, const __nv_bfloat16* __restrict__ w1,
        const __nv_bfloat16* __restrict__ b1,
        const __nv_bfloat16* __restrict__ w2,
        const __nv_bfloat16* __restrict__ b2, float* __restrict__ out,
        float2* __restrict__ stats, const int n, const int hdim, const int w,
        const Members ms) {
    fwd_mma<false>(x4, ids, h, u, cvec, w1, b1, w2, b2, out, stats, n, hdim,
                   w, ms);
}

template <>
__global__ void __launch_bounds__(kThreads, kMmaFwdMinBlocks)
social_attention_fwd_kernel<__nv_bfloat16, true>(
        const float4* __restrict__ x4, const int* __restrict__ ids,
        const __nv_bfloat16* __restrict__ h, const float* __restrict__ u,
        const float* __restrict__ cvec, const __nv_bfloat16* __restrict__ w1,
        const __nv_bfloat16* __restrict__ b1,
        const __nv_bfloat16* __restrict__ w2,
        const __nv_bfloat16* __restrict__ b2, float* __restrict__ out,
        float2* __restrict__ stats, const int n, const int hdim, const int w,
        const Members ms) {
    fwd_mma<true>(x4, ids, h, u, cvec, w1, b1, w2, b2, out, stats, n, hdim,
                  w, ms);
}
#endif  // SA_BF16_ENTRIES

// Launches u_prep_kernel and the main kernel (`blocks` x `members` blocks,
// each walking tiles blockIdx.x, blockIdx.x + blocks, ... of member
// blockIdx.y) on `stream`; does not synchronise, allocates nothing;
// returns cudaGetLastError() so the caller sees a refused launch.  u [M, N,
// 64] and c [M, N] are written for the backward; `stats` [M, N, 2] may be
// null (serving: no extra stores); out is [M, N, H].  `strides` are the
// member strides (MemberStrides, checked by members_of; null for a single
// model, M = 1).  `max_scene` is the
// scene window w of social_attention_pairs.cuh (0: every tile scans all N);
// w < 0 and bad strides are refused with cudaErrorInvalidValue.  h, wh,
// w1..b3 are T.  kWide takes any H and F in multiples of 16, the narrow kernels
// up to kNarrowWidth (width_ok).
template <typename T, bool kWide>
int launch_fwd(const void* x4, const void* ids, const void* h, const void* wh,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* out, void* stats,
               void* u, void* c, int n, int hdim, int feat, int blocks,
               int max_scene, int members, const void* strides,
               void* stream) {
    Members ms{};
    if (max_scene < 0 || !members_of(strides, members, n, hdim, feat, ms))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    if (blocks <= 0 || !width_ok(hdim, kWide) || !width_ok(feat, kWide))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // rows a u_prep block: the bf16 one's warps take kMma each
    constexpr int prep = std::is_same_v<T, float> ? kPrepRows : kWarps * kMma;
    u_prep_kernel<T, kWide><<<dim3((n + prep - 1) / prep, members),
                       kThreads, 0, st>>>(
        static_cast<const T*>(wh), static_cast<const T*>(w3),
        static_cast<const T*>(b3), static_cast<float*>(u),
        static_cast<float*>(c), n, feat, ms);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dependent(
        social_attention_fwd_kernel<T, kWide>, dim3(blocks, members),
        dim3(kThreads), 0, st, static_cast<const float4*>(x4),
        static_cast<const int*>(ids), static_cast<const T*>(h),
        static_cast<const float*>(u), static_cast<const float*>(c),
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(b2),
        static_cast<float*>(out), static_cast<float2*>(stats), n, hdim,
        max_scene, ms);
}

}  // namespace

// The C entries' arguments (social_attention_fwd*.cu).
#define SA_FWD_ARGS                                                         \
    const void *x4, const void *ids, const void *h, const void *wh,         \
        const void *w1, const void *b1, const void *w2, const void *b2,     \
        const void *w3, const void *b3, void *out, void *stats, void *u,    \
        void *c, int n, int hdim, int feat, int blocks, int max_scene,      \
        int members, const void *strides, void *stream
#define SA_FWD_PASS x4, ids, h, wh, w1, b1, w2, b2, w3, b3, out, stats, u, c, \
    n, hdim, feat, blocks, max_scene, members, strides, stream
