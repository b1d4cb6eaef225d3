// Pair machinery shared by the three social-attention kernels: the forward
// (social_attention_fwd.cuh) and the dq and dkv backward
// (social_attention_bwd.cuh, which also holds the backward steps dq and dkv
// share).
//
// All three work on the same-scene pairs (i, j), both valid, i != j.  A
// block owns a tile of kTile agents (query rows in the forward and dq,
// columns in dkv) and finds their partners by id tests over a range of
// agents (tile_ring): all N when the caller's scene window w is 0, so no
// order of the scene ids is assumed (unsorted ids are masked, never
// dropped); [t0 - w, t0 + kTile + w) when w > 0 and the caller promises
// sorted, contiguous scenes of at most w rows, which puts every partner
// there.  The scan runs in the same order either way, so both find the same
// pairs in the same order.  The pairs go into a ring in shared memory and
// leave it in batches of at most kBatch; per batch all kThreads threads run
// the pair MLP:
//   features (dist, bearing, dca)        one thread a pair
//   a1 = relu(W1 feat + b1)   3 -> 32     one output per thread and step
//   a2 = relu(W2 a1 + b2)     32 -> 64    register-tiled: thread (pg, og)
//        holds pairs 4pg..4pg+3 x outputs 4og..4og+3, so two float4 loads
//        from shared memory feed 16 FMA
//   s  = a2 . u_j + c_j       u_j = W3 wh_j [64], c_j = b3 . wh_j
//        (= f_ij . wh_j; 2,208 MAC a pair instead of 6,304 at F = 64)
// Every sum runs in a fixed order, so the three kernels rebuild the same
// score bits from the same u and c.
//
// Operand type.  Every kernel is a template on T, the type of h, wh and the
// feature-MLP weights: float, or __nv_bfloat16 for JAX's bf16 operand mode
// (socialways_tpu/kernels/social_attention.py:96-105, 183-185, 248-258).
// T values are widened to float in registers and every sum runs in float;
// rnd<T> rounds to bf16 exactly where the Pallas kernel casts: the three
// features before W1, a1 before W2, a2 before the u contraction and p
// before p . h.  x4, the cotangents, stats, u and c stay float.  For
// T = float, ld, ld4 and rnd are the identity, and the kernels compile to
// the float code they were.
//
// Member axis.  An ensemble trains M models on the same data at once, and
// every kernel takes their operands stacked on a leading member axis:
// blockIdx.y is the member.  A block adds its member's offset to every row
// index (m N rows) and weight offset, so member m's block runs the solo
// arithmetic on member m's operands and writes member m's bits.  A single
// model is the launch at M = 1 (a null stride array).  The operands a
// caller may share between members (x4 and the ids, which are data; wh and
// the six MLP tensors) have a member stride each, 0 for one shared copy or
// their dense size; h, every output, cotangent and scratch array is per
// member and dense.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace sa {

// The member strides of the shareable operands, as the C entries take them
// (an array of 10 long long: x4, ids, h, wh, w1, b1, w2, b2, w3, b3, in
// elements; a null array is all 0).
struct MemberStrides {
    long long x4, ids, h, wh, w1, b1, w2, b2, w3, b3;
};

// What member m adds to its indices, per unit of m: rows for x4, ids and wh
// (0 or N), elements for the weights (0 or their size).  h and every
// per-member array add m N rows.
struct Members {
    int x4, ids, wh, w1, b1, w2, b2, w3, b3;
};

// `strides` (MemberStrides or null) checked and turned into Members for
// `members` stacked models of N rows, H = hdim, F = feat: each stride is 0
// (shared) or its operand's dense size, h's is N H, and every index fits
// an int.  False for anything else.  feat = 0 (dq, which reads no wh, W3,
// b3) leaves those three strides unread.
inline bool members_of(const void* strides, const int members, const int n,
                       const int hdim, const int feat, Members& ms) {
    MemberStrides st;
    std::memset(&st, 0, sizeof(st));
    if (strides != nullptr) std::memcpy(&st, strides, sizeof(st));
    if (feat == 0) st.wh = st.w3 = st.b3 = 0;
    const long long nn = n;
    const long long dense[10] = {4 * nn, nn, nn * hdim, nn * feat, 3 * 32,
                                 32, 32 * 64, 64, 64LL * feat, feat};
    const long long got[10] = {st.x4, st.ids, st.h, st.wh, st.w1, st.b1,
                               st.w2, st.b2, st.w3, st.b3};
    const long long width = hdim > feat ? (hdim > 64 ? hdim : 64)
                                        : (feat > 64 ? feat : 64);
    if (members < 1 || members > 65535 ||
        (long long)members * nn * width >= (1LL << 31))
        return false;
    for (int i = 0; i < 10; ++i)
        if (got[i] != 0 && got[i] != dense[i]) return false;
    if (members > 1 && st.h != dense[2]) return false;
    ms = Members{st.x4 ? n : 0, st.ids ? n : 0, st.wh ? n : 0,
                 (int)st.w1, (int)st.b1, (int)st.w2, (int)st.b2, (int)st.w3,
                 (int)st.b3};
    return true;
}

// This block's member.
__device__ __forceinline__ int member() { return (int)blockIdx.y; }

constexpr int kIn = 3;          // social features: dist, bearing, dca
constexpr int kH1 = 32;         // feature-MLP hidden widths (fixed by the model)
constexpr int kH2 = 64;
constexpr int kThreads = 128;   // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2;        // agents a tile owns: 128 blocks at N = 256
constexpr int kBatch = 32;      // pairs a batch
constexpr int kScan = 2;        // agents a thread id-tests per scan step
constexpr int kRing = 1024;     // pair ring (entries), a power of two
constexpr int kA1Stride = kBatch + 4;   // a1^T [kH1][kBatch], padded rows
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// A scan step adds at most kTile * kScan * kThreads pairs to fewer than kBatch.
static_assert(kRing >= kBatch - 1 + kTile * kScan * kThreads, "pair ring too small");
static_assert(kTile * kScan <= 32, "a thread's hits fit one word");
static_assert(kThreads == 8 * 16 && kBatch == 8 * 4,
              "layer-2 tile: 8 pair groups of 4 x 16 output groups of 4");
static_assert(kTile * kH2 == kThreads, "one thread per (tile agent, output)");

// A bf16 is the high half of a float: widening is a shift, and rounding
// is the hardware's round-to-nearest-even (cvt.rn.bf16.f32).
__device__ __forceinline__ float ld(const float v) { return v; }
__device__ __forceinline__ float ld(const __nv_bfloat16 v) {
    return __uint_as_float((unsigned)__bfloat16_as_ushort(v) << 16);
}

// Elements 4 i .. 4 i + 3 of p as a float4; p is aligned to 4 elements.
__device__ __forceinline__ float4 ld4(const float* p, const int i) {
    return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, const int i) {
    const uint2 v = reinterpret_cast<const uint2*>(p)[i];
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
}

// v rounded to T's precision, as a float.
template <typename T> __device__ __forceinline__ float rnd(const float v);
template <> __device__ __forceinline__ float rnd<float>(const float v) {
    return v;
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(const float v) {
    unsigned short b;
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(b) : "f"(v));
    return __uint_as_float((unsigned)b << 16);
}

__device__ __forceinline__ float snorm(float sq) {
    return sq > 0.f ? sqrtf(sq) : 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// Sum over the 16 lanes of a half warp.  Each step adds two partials in
// either order, and float addition commutes, so all 16 lanes end with the
// same bits.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// The pair features of (i, j), agent j seen from agent i, and the
// intermediates their backward needs (eps 1e-6, safe norms as ops/social.py).
struct Geo {
    float dpx, dpy, dvx, dvy, dist, num_b, den_b, dvsq, num_t, ttca, cax,
          cay, dca;
    float feat[kIn];
};

__device__ __forceinline__ Geo pair_geo(const float4 xi, const float vi_norm,
                                        const float4 xj) {
    Geo q;
    q.dpx = xi.x - xj.x; q.dpy = xi.y - xj.y;
    q.dvx = xi.z - xj.z; q.dvy = xi.w - xj.w;
    q.dist = snorm(q.dpx * q.dpx + q.dpy * q.dpy);
    q.num_b = q.dpx * xi.z + q.dpy * xi.w;
    q.den_b = q.dist * vi_norm + 1e-6f;
    q.num_t = q.dpx * q.dvx + q.dpy * q.dvy;
    q.dvsq = q.dvx * q.dvx + q.dvy * q.dvy + 1e-6f;
    q.ttca = -q.num_t / q.dvsq;
    q.cax = q.dpx + q.ttca * q.dvx;
    q.cay = q.dpy + q.ttca * q.dvy;
    q.dca = snorm(q.cax * q.cax + q.cay * q.cay);
    q.feat[0] = q.dist;
    q.feat[1] = q.num_b / q.den_b;
    q.feat[2] = q.dca;
    return q;
}

__device__ __forceinline__ float speed(const float4 x) {
    return snorm(x.z * x.z + x.w * x.w);
}

// Cotangents of x_i and x_j from those of (dist, bearing, dca).  sqrt has
// derivative 0 where its argument is 0, as the forward's safe norm.
__device__ __forceinline__ void geo_backward(const Geo& q, const float4 xi,
                                             const float vi_norm,
                                             const float* gf, float4& gi,
                                             float4& gj) {
    const float g_casq = q.dca > 0.f ? gf[2] * 0.5f / q.dca : 0.f;
    const float g_cax = 2.f * q.cax * g_casq, g_cay = 2.f * q.cay * g_casq;
    float g_dpx = g_cax, g_dpy = g_cay;
    const float g_ttca = g_cax * q.dvx + g_cay * q.dvy;
    float g_dvx = g_cax * q.ttca, g_dvy = g_cay * q.ttca;
    const float g_num_t = -g_ttca / q.dvsq;
    const float g_dvsq = g_ttca * q.num_t / (q.dvsq * q.dvsq);
    g_dpx += g_num_t * q.dvx; g_dpy += g_num_t * q.dvy;
    g_dvx += g_num_t * q.dpx + 2.f * q.dvx * g_dvsq;
    g_dvy += g_num_t * q.dpy + 2.f * q.dvy * g_dvsq;
    const float g_num_b = gf[1] / q.den_b;
    const float g_den_b = -gf[1] * q.num_b / (q.den_b * q.den_b);
    g_dpx += g_num_b * xi.z; g_dpy += g_num_b * xi.w;
    float g_vix = g_num_b * q.dpx, g_viy = g_num_b * q.dpy;
    const float g_dist = gf[0] + g_den_b * vi_norm;
    const float g_vn = g_den_b * q.dist;
    const float g_vsq = vi_norm > 0.f ? g_vn * 0.5f / vi_norm : 0.f;
    g_vix += 2.f * xi.z * g_vsq; g_viy += 2.f * xi.w * g_vsq;
    const float g_dsq = q.dist > 0.f ? g_dist * 0.5f / q.dist : 0.f;
    g_dpx += 2.f * q.dpx * g_dsq; g_dpy += 2.f * q.dpy * g_dsq;
    gi = make_float4(g_dpx, g_dpy, g_dvx + g_vix, g_dvy + g_viy);
    gj = make_float4(-g_dpx, -g_dpy, -g_dvx, -g_dvy);
}

// The ring of found pairs: entry o * kTile + t pairs tile agent t with agent
// o.  head, count and the scan position next (up to end) are block-uniform.
struct PairRing {
    int* ring;      // [kRing] shared
    int* scan;      // [kWarps] shared
    int head, count, next, end;
};

// An empty ring whose scan covers the agents a tile starting at agent t0
// may pair with: [0, n) for w == 0, else [max(0, t0 - w), min(n, t0 + kTile
// + w)) (kernels/social_attention.py:scan_range computes the same range).
__device__ __forceinline__ PairRing tile_ring(int* ring, int* scan,
                                              const int t0, const int n,
                                              const int w) {
    if (w == 0) return PairRing{ring, scan, 0, 0, 0, n};
    return PairRing{ring, scan, 0, 0, max(0, t0 - w), min(n, t0 + kTile + w)};
}

// Scans agents next, next + 1, ... in steps of kScan * kThreads (thread t
// tests agents next + kScan t + q) until the ring holds kBatch pairs or the
// scan reaches end.  tile_id[t] is tile agent t's scene id (-1 for padding
// or past n: matches nothing), tile_idx[t] its index.  Entries are appended
// in scan order (agent, then tile agent).  Agent o's id is ids[id0 + o]
// (id0: the member's rows).  Every thread of the block calls it.
__device__ __forceinline__ void fill_ring(PairRing& pr,
                                          const int* __restrict__ ids,
                                          const int id0,
                                          const int (&tile_id)[kTile],
                                          const int (&tile_idx)[kTile]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    while (pr.count < kBatch && pr.next < pr.end) {
        const int o0 = pr.next + kScan * threadIdx.x;
        unsigned bits = 0u;     // bit q kTile + t: agent o0 + q pairs with t
#pragma unroll
        for (int q = 0; q < kScan; ++q) {
            const int o = o0 + q;
            const int id_o = o < pr.end ? ids[id0 + o] : -1;
#pragma unroll
            for (int t = 0; t < kTile; ++t)
                if (id_o >= 0 && id_o == tile_id[t] && o != tile_idx[t])
                    bits |= 1u << (q * kTile + t);
        }
        const int hits = __popc(bits);
        int incl = hits;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, off);
            if (lane >= off) incl += v;
        }
        if (lane == 31) pr.scan[warp] = incl;
        __syncthreads();
        int pos = pr.count + incl - hits, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int c = pr.scan[w];
            if (w < warp) pos += c;
            total += c;
        }
        while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1u;
            pr.ring[(pr.head + pos) & (kRing - 1)] = (o0 + b / kTile) * kTile + b % kTile;
            ++pos;
        }
        pr.count += total;
        pr.next += kScan * kThreads;
        __syncthreads();    // ring entries visible, scan slots free
    }
}

// Programmatic dependent launch (sm_90).  A kernel launched by
// launch_dependent() may start while the kernel before it on the stream
// still runs: pdl_wait() blocks until that kernel has finished and its
// writes are visible, and pdl_launch_dependents() in the earlier kernel
// lets the later one start.  Both are no-ops for a plain launch.
__device__ __forceinline__ void pdl_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__device__ __forceinline__ void pdl_launch_dependents() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

template <typename... Params, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), const dim3 grid,
                                    const dim3 block, const size_t smem,
                                    cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// a1^T[k][p] = relu(W1 feat_p + b1)[k] for the batch (feat [kIn][kBatch],
// already rounded to T), rounded to T: the operand of W2.
template <typename T>
__device__ __forceinline__ void layer1(const float* s_feat, const float* s_w1,
                                       const float* s_b1, float* s_a1) {
    for (int e = threadIdx.x; e < kH1 * kBatch; e += kThreads) {
        const int k = e / kBatch, p = e - k * kBatch;
        float t = s_feat[p] * s_w1[k];
        t = fmaf(s_feat[kBatch + p], s_w1[kH1 + k], t);
        t = fmaf(s_feat[2 * kBatch + p], s_w1[2 * kH1 + k], t);
        s_a1[k * kA1Stride + p] = rnd<T>(fmaxf(t + s_b1[k], 0.f));
    }
}

// a2 of thread (pg, og) = (t >> 4, t & 15): pairs 4pg + i, outputs 4og + o,
// rounded to T (the operand of the u contraction; rounding keeps the sign,
// so a2 > 0 is still the relu mask).  W2 rows are w2_stride floats apart
// (a multiple of 4).
template <typename T>
__device__ __forceinline__ void layer2_tile(const float* s_a1,
                                            const float* s_w2,
                                            const int w2_stride,
                                            const float* s_b2,
                                            float (&a2)[4][4]) {
    const int pg = threadIdx.x >> 4, og = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < 4; ++o) a2[i][o] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kH1; ++k) {
        const float4 a = reinterpret_cast<const float4*>(s_a1 + k * kA1Stride)[pg];
        const float4 w = reinterpret_cast<const float4*>(s_w2 + k * w2_stride)[og];
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int o = 0; o < 4; ++o) a2[i][o] = fmaf(av[i], wv[o], a2[i][o]);
    }
    const float4 b = reinterpret_cast<const float4*>(s_b2)[og];
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < 4; ++o) a2[i][o] = rnd<T>(fmaxf(a2[i][o] + bv[o], 0.f));
}

// This thread's part of a2_i . u over its four outputs (u4 = u + 4 og).
__device__ __forceinline__ float dot4(const float (&a2i)[4], const float4 u4) {
    float s = a2i[0] * u4.x;
    s = fmaf(a2i[1], u4.y, s);
    s = fmaf(a2i[2], u4.z, s);
    return fmaf(a2i[3], u4.w, s);
}

}  // namespace sa
