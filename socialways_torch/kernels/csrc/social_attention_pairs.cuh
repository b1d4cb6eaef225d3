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
// Values are rounded to bf16 exactly where the Pallas kernel casts: the
// three features before W1, a1 before W2, a2 before the u contraction and p
// before p . h, and every sum runs in float; x4, the cotangents, stats, u
// and c stay float.  For T = float, ld, ld4 and rnd are the identity, and
// the kernels compile to the float code they were.  The bf16 forward, its
// u prologue, dq and dkv are kernels of their own (explicit
// specializations in the *_bf16.cu translation units, below: "bf16
// operands on Hopper's tensor cores").
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
constexpr int kNarrowWidth = 128;   // H and F at most of the narrow kernels
constexpr int kStageWidth = 512;    // h_j columns the wide dkv stages at once
constexpr int kScan = 2;        // agents a thread id-tests per scan step
constexpr int kRing = 1024;     // pair ring (entries), a power of two
constexpr int kA1Stride = kBatch + 4;   // a1^T [kH1][kBatch], padded rows
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// A width H or F that a launch of the narrow (wide) kernels takes: a
// multiple of 16 up to kNarrowWidth (any multiple of 16; members_of keeps
// every index in an int).  The wrappers pad other widths with zeros and
// pick the wide kernels above kNarrowWidth (kernels/social_attention.py).
inline bool width_ok(const int w, const bool wide) {
    return w > 0 && w % 16 == 0 && (wide || w <= kNarrowWidth);
}

// Elements of a tile's rows [t0, min(t0 + kTile, n)) of an [n][width] array.
__device__ __forceinline__ int tile_elems(const int n, const int t0,
                                          const int width) {
    return (n - t0 < kTile ? n - t0 : kTile) * width;
}

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

// ---------------------------------------------------------------------------
// bf16 operands on Hopper's tensor cores.  The bf16 forward, dq and dkv run
// the pair MLP one warp at a time: a warp owns one agent (a query row in
// the forward and dq, a column in dkv), finds its partners with its own id scan
// (warp_fill) and takes them 16 at a time, an m-tile of
// mma.m16n8k16.bf16 -> f32, with no block barrier.  Lane (g, t) = (lane >> 2,
// lane & 3) holds the accumulator rows g and g + 8 (pairs) at the columns
// 8 nt + 2 t, 8 nt + 2 t + 1 of each 8-column n-tile nt; the A fragment of
// the same lane holds rows g, g + 8 at k = 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of
// each 16-wide k-step, so one product's accumulator is the next one's A
// operand without moving data.  a1 and W2 are bf16 values and the products
// are summed in float: the operands' own contract (the Pallas kernel's
// preferred_element_type=float32).  Layer 1 (K = 3) stays FFMA.  All
// three kernels rebuild the same score bits with the same routine.

constexpr int kMma = 16;             // pairs of an m-tile
constexpr int kN2 = kH2 / 8;         // layer-2 n-tiles
constexpr int kW2Frags = (kH1 / 16) * kN2 * 32;   // W2's B fragments (uint2)

// Two bf16-exact floats as a bf16x2 register (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(const float lo, const float hi) {
    return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// lo and hi rounded to bf16 (rnd's rounding) as a bf16x2 register: one
// conversion for two values.
__device__ __forceinline__ unsigned cvt_bf16x2(const float lo, const float hi) {
    unsigned d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

// The bf16 in the low (high) half of a bf16x2 register, as a float.
__device__ __forceinline__ float lo_bf16(const unsigned v) {
    return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(const unsigned v) {
    return __uint_as_float(v & 0xffff0000u);
}

// d += a b on the tensor cores: A 16 x 16 (row), B 16 x 8 (col), bf16
// operands, float accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned b0, const unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of the 8 x 8 bf16 matrix whose row lane >> 2, columns
// 2 (lane & 3) and 2 (lane & 3) + 1 this lane holds in v.
__device__ __forceinline__ unsigned movm_trans(const unsigned v) {
    unsigned d;
    asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(v));
    return d;
}

// f = hi + mid + lo exactly, each a bf16 value (f's 24 significant bits in
// three pieces of 8; subnormal floats aside), for two floats f0, f1 at once:
// each piece a bf16x2 register (f0 low).  A bf16 operand times each piece
// is exact in float, so a product with a float32 cotangent runs on the
// tensor cores without rounding the cotangent.
__device__ __forceinline__ void split3(const float f0, const float f1,
                                       unsigned (&piece)[3]) {
    const unsigned hi = cvt_bf16x2(f0, f1);
    const float r0 = f0 - lo_bf16(hi), r1 = f1 - hi_bf16(hi);
    const unsigned mid = cvt_bf16x2(r0, r1);
    piece[0] = cvt_bf16x2(r0 - lo_bf16(mid), r1 - hi_bf16(mid));
    piece[1] = mid;
    piece[2] = hi;
}

// W2 [kH1][kH2] (bf16) as the B fragments of layer 2 (K = kH1, N = kH2), in
// fragment order: entry (ks kN2 + nt) 32 + lane holds lane's (b0, b1) of
// k-step ks and n-tile nt, so each lane reads its pair with one 8-byte,
// conflict-free load.  Every thread of a kThreads block calls it.
__device__ __forceinline__ void stage_w2_frags(const __nv_bfloat16* w2,
                                               uint2* s_w2f) {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(w2);
#pragma unroll
    for (int e = threadIdx.x; e < kW2Frags; e += kThreads) {
        const int lane = e & 31, nt = (e >> 5) % kN2, ks = e / (32 * kN2);
        const int o = 8 * nt + (lane >> 2), k = 16 * ks + 2 * (lane & 3);
        s_w2f[e] = make_uint2(
            w[k * kH2 + o] | (unsigned)w[(k + 1) * kH2 + o] << 16,
            w[(k + 8) * kH2 + o] | (unsigned)w[(k + 9) * kH2 + o] << 16);
    }
}

// relu(W1 feat + b1)[k] of one pair before its rounding to bf16: layer1's
// arithmetic, so a fragment built from it has the bits of layer1's a1^T.
__device__ __forceinline__ float a1_of(const float (&f)[kIn], const float* s_w1,
                                       const float* s_b1, const int k) {
    float t = f[0] * s_w1[k];
    t = fmaf(f[1], s_w1[kH1 + k], t);
    t = fmaf(f[2], s_w1[2 * kH1 + k], t);
    return fmaxf(t + s_b1[k], 0.f);
}

// Lane (g, t)'s A fragments of layer 2 (a1 of pairs g and g + 8, the
// features fg and fg8 already rounded to bf16): a[ks] for k-step ks.
__device__ __forceinline__ void layer1_frags(const float (&fg)[kIn],
                                             const float (&fg8)[kIn],
                                             const float* s_w1,
                                             const float* s_b1,
                                             unsigned (&a)[2][4]) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
        const int k = 16 * ks + 2 * t;
        a[ks][0] = cvt_bf16x2(a1_of(fg, s_w1, s_b1, k), a1_of(fg, s_w1, s_b1, k + 1));
        a[ks][1] = cvt_bf16x2(a1_of(fg8, s_w1, s_b1, k), a1_of(fg8, s_w1, s_b1, k + 1));
        a[ks][2] = cvt_bf16x2(a1_of(fg, s_w1, s_b1, k + 8), a1_of(fg, s_w1, s_b1, k + 9));
        a[ks][3] = cvt_bf16x2(a1_of(fg8, s_w1, s_b1, k + 8), a1_of(fg8, s_w1, s_b1, k + 9));
    }
}

// The layer-2 + score routine of the bf16 kernels, one warp and one m-tile
// of 16 pairs: z2 = a1 W2 (16 mma from the A fragments `a` and the staged
// B fragments), a2 = rnd(relu(z2 + b2)) in the accumulator layout (a2[nt][0,
// 1]: pair g, a2[nt][2, 3]: pair g + 8), and the scores s = a2 . u_j + c_j
// of pairs g (u row ug, cg) and g + 8 (ug8, cg8): this lane's 16 products
// in a fixed order, then the quad's four partials in a fixed tree, so all
// four lanes of the quad end with the same bits.  u and c stay float.
__device__ __forceinline__ float2 layer2_scores(const unsigned (&a)[2][4],
                                                const uint2* s_w2f,
                                                const float* s_b2,
                                                const float* ug,
                                                const float* ug8,
                                                const float cg,
                                                const float cg8,
                                                float (&a2)[kN2][4]) {
    const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kN2; ++nt)
        a2[nt][0] = a2[nt][1] = a2[nt][2] = a2[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < kN2; ++nt) {
            const uint2 b = s_w2f[(ks * kN2 + nt) * 32 + lane];
            mma_bf16(a2[nt], a[ks], b.x, b.y);
        }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kN2; ++nt) {
        const int o = 8 * nt + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(s_b2 + o);
        const float2 u0 = *reinterpret_cast<const float2*>(ug + o);
        const float2 u1 = *reinterpret_cast<const float2*>(ug8 + o);
        const unsigned r0 = cvt_bf16x2(fmaxf(a2[nt][0] + bb.x, 0.f),
                                       fmaxf(a2[nt][1] + bb.y, 0.f));
        const unsigned r1 = cvt_bf16x2(fmaxf(a2[nt][2] + bb.x, 0.f),
                                       fmaxf(a2[nt][3] + bb.y, 0.f));
        a2[nt][0] = lo_bf16(r0);
        a2[nt][1] = hi_bf16(r0);
        a2[nt][2] = lo_bf16(r1);
        a2[nt][3] = hi_bf16(r1);
        s0 = fmaf(a2[nt][0], u0.x, s0);
        s0 = fmaf(a2[nt][1], u0.y, s0);
        s1 = fmaf(a2[nt][2], u1.x, s1);
        s1 = fmaf(a2[nt][3], u1.y, s1);
    }
    s0 += __shfl_xor_sync(kFull, s0, 1);
    s0 += __shfl_xor_sync(kFull, s0, 2);
    s1 += __shfl_xor_sync(kFull, s1, 1);
    s1 += __shfl_xor_sync(kFull, s1, 2);
    return make_float2(s0 + cg, s1 + cg8);
}

// The sums over the 16 lanes of each half warp of v[0 .. 31], scattered: on
// return v[0] and v[1] of lane l hold the half warp's sums of its v[2 (l &
// 15)] and v[2 (l & 15) + 1] (four levels of exchanging and adding halves,
// each sum in a fixed tree).
__device__ __forceinline__ void half_warp_reduce_scatter(float (&v)[32]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int lvl = 0; lvl < 4; ++lvl) {
        const int off = 8 >> lvl, len = 16 >> lvl;
        const bool upper = (lane & off) != 0;
#pragma unroll
        for (int i = 0; i < len; ++i) {
            const float keep = upper ? v[len + i] : v[i];
            const float send = upper ? v[i] : v[len + i];
            v[i] = keep + __shfl_xor_sync(kFull, send, off);
        }
    }
}

// A warp's ring of partners of its agent `self` (scene id sid): agents
// next, next + 1, ... up to end, in ascending order, the order fill_ring
// gives a tile's pairs.  head and count are warp-uniform.
struct WarpRing {
    int* ring;      // [kWRing] shared, the warp's own
    int head, count, next, end;
};

constexpr int kWScan = 8;       // agents a lane id-loads at once (256 a warp)
constexpr int kWRing = 64;      // a warp's pair ring (entries), a power of two
static_assert(kWRing >= kMma - 1 + 32, "warp pair ring too small");

// Fills the ring until it holds an m-tile of pairs or the scan reaches end:
// the ids of the next 32 kWScan agents are loaded at once (lane l: next +
// 32 q + l), then tested 32 at a time, stopping after the 32 that fill the
// m-tile (the scan resumes there), so a test adds at most 32 entries to
// fewer than kMma.  Every lane of the warp calls it.  kSelf: `self` pairs
// with itself too (Social GAN's pool, social_pool.cuh, takes the diagonal
// pair); the attention kernels leave it false, which compiles to the test
// they had.
template <bool kSelf = false>
__device__ __forceinline__ void warp_fill(WarpRing& wr,
                                          const int* __restrict__ ids,
                                          const int id0, const int sid,
                                          const int self) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    while (wr.count < kMma && wr.next < wr.end) {
        int id_o[kWScan];
#pragma unroll
        for (int q = 0; q < kWScan; ++q) {
            const int o = wr.next + 32 * q + lane;
            id_o[q] = o < wr.end ? ids[id0 + o] : -1;
        }
#pragma unroll
        for (int q = 0; q < kWScan; ++q) {
            if (wr.count >= kMma || wr.next >= wr.end) break;
            const int o = wr.next + lane;
            const bool hit = id_o[q] >= 0 && id_o[q] == sid && (kSelf || o != self);
            const unsigned hits = __ballot_sync(kFull, hit);
            if (hit)
                wr.ring[(wr.head + wr.count + __popc(hits & below)) & (kWRing - 1)] = o;
            wr.count += __popc(hits);
            wr.next += 32;
        }
    }
    __syncwarp();           // the ring's entries are visible to the warp
}

}  // namespace sa
