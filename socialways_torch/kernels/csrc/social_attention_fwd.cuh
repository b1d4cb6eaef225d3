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
// stats, u and c stay float.  The online softmax rounds p against the
// running max of its batch of 32 pairs, the Pallas kernel against that of
// its 64-column tile: where a row's max moves between batches the two
// round p differently, by at most half a bf16 ulp of each term.
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
// Bound on this card: operations, at the shapes the model runs (N = 256
// rows in scenes of 2-16 agents, H = F = 64): the same-scene pairs times
// 2.2k MAC of f32 FMA, plus N x 64 x F for u, against ~0.2 MB of bytes.  At
// N = 256 that is well under a microsecond, below what a launch takes: the
// design fills the card and keeps the pair intermediates in shared memory
// and registers; what is left is the latency of its phases.

#include <cuda_runtime.h>

#include "social_attention_pairs.cuh"

namespace {

using namespace sa;

constexpr int kPrepRows = 8;        // agents a u_prep block
constexpr int kMaxWidth = 128;      // H and F at most

// u = wh W3^T [N, 64], c = wh . b3 [N] of member blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
u_prep_kernel(const T* __restrict__ wh, const T* __restrict__ w3,
              const T* __restrict__ b3, float* __restrict__ u,
              float* __restrict__ c, const int n, const int feat,
              const Members ms) {
    __shared__ float s_w3t[kMaxWidth * (kH2 + 1)];    // W3^T [F][64 + 1]
    __shared__ float s_wh[kPrepRows][kMaxWidth];
    pdl_launch_dependents();     // the main kernel may start its prefix now
    const int m = member(), mrow = m * n, whrow = m * ms.wh;
    w3 += m * ms.w3;
    b3 += m * ms.b3;
    const int row0 = blockIdx.x * kPrepRows, f4 = feat / 4;
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

template <typename T>
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
        float acc[2] = {0.f, 0.f};
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
        if (stats != nullptr && threadIdx.x < kTile && row0 + threadIdx.x < n)
            stats[row0 + threadIdx.x] = make_float2(s_m[threadIdx.x],
                                                    s_l[threadIdx.x]);
        __syncthreads();         // s_m, s_l, s_xt are the next tile's
    }
}

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
// w1..b3 are T.
template <typename T>
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
    if (blocks <= 0 || hdim > kMaxWidth || feat > kMaxWidth)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    u_prep_kernel<T><<<dim3((n + kPrepRows - 1) / kPrepRows, members),
                       kThreads, 0, st>>>(
        static_cast<const T*>(wh), static_cast<const T*>(w3),
        static_cast<const T*>(b3), static_cast<float*>(u),
        static_cast<float*>(c), n, feat, ms);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dependent(
        social_attention_fwd_kernel<T>, dim3(blocks, members),
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
