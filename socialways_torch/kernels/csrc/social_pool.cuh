// Social GAN's pooling module (PoolHiddenNet, sgan/models.py) as one
// forward kernel (sm_90a), a template on the operand type T: bf16 on the
// tensor cores, float with FFMA products.
//
// Replaces no TPU kernel (the JAX package has no Social GAN); its plain
// versions are socialways_torch/ops/sgan_pool.py.  For every row i and
// every j of i's scene, j = i included (sa::warp_fill<true>):
//   r_ij = T(p_j - p_i)                                    2
//   e_ij = T(r_ij W_pe + b_pe)                             2 -> 16
//   z_ij = T(relu([e_ij ; h_j] W_1 + b_1))                 48 -> 512
//   b_ij = relu(z_ij W_2 + b_2)                            512 -> 32
//   P_i  = max_j b_ij                out[i], float
// T(x) rounds a float to T (the identity for float); every product sums in
// float; relu and the max run on float values.  These are the rounding
// points of the plain forms (the published concatenation, not the fold of
// layer 1 into per-agent terms): only the order of the float sums
// differs, and the tensor cores' accumulation within an mma.  Rows whose
// scene id is -1 get zeros.
//
// Scan.  Scenes are found by id tests over a range of agents: all N when
// the scene window w is 0, else [t0 - w, t0 + 2 + w) for the two rows t0,
// t0 + 1 a warp owns (sa::tile_ring's range at kTile = 2), which holds
// every partner of both when the caller promises sorted, contiguous scenes
// of at most w rows.  Both scans visit the same partners in the same
// order, so w = 0 and w > 0 give equal bits.
//
// bf16 design.  A warp owns two consecutive rows (a, b) of one scene, which
// share their partners: the partners leave the warp's ring 16 at a time,
// an m-tile of mma.m16n8k16 bf16 -> f32 for each row.  Layer 1's A operand
// is [e_ij (one k-step, built in registers) ; h_j (two k-steps, loaded
// from h's rows)]; layer 2's k-step ks is layer 1's n-tiles 2 ks, 2 ks + 1,
// so each 16 columns of z go from layer 1's accumulators through relu and
// one cvt into layer 2's A fragment and never leave the registers.  W_1
// and W_2 sit in shared memory as B fragments (one 8-byte load a lane),
// each load feeding both rows' m-tiles; layer 1 starts from b_1 and layer
// 2 from b_2.  The max is kept in registers in the accumulator layout
// (rows g, g + 8 of an m-tile are two pairs of one row), padded pairs
// entering as 0 (b_ij >= 0, and the row's own pair is always there), and
// reduced over the quad rows once a row is done.  Two rows of different
// scenes take the same path one at a time.  The weights are staged once a
// block; blocks walk the row pairs with the grid's stride.
//
// float design.  A warp owns one row; each partner's [e ; h_j] (48) and z
// (512) go through the warp's shared memory, a lane computes 16 of z and
// one output column of b (the weights read from global memory).  It is
// the plain version's arithmetic on the card, for float32 models.

#pragma once

#include <type_traits>

#include "social_attention_pairs.cuh"

namespace sp {

using sa::kFull;
using sa::kMma;
using sa::kWRing;
using sa::ld;
using sa::rnd;

constexpr int kE = 16;              // e_ij width (embedding_dim)
constexpr int kHid = 32;            // h_j width (encoder_h_dim)
constexpr int kIn = kE + kHid;      // layer-1 inputs
constexpr int kZ = 512;             // layer-1 outputs (PoolHiddenNet's 512)
constexpr int kOut = 32;            // layer-2 outputs (bottleneck_dim)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKs1 = kIn / 16;      // layer-1 k-steps (e, h, h)
constexpr int kNt1 = kZ / 8;        // layer-1 n-tiles
constexpr int kKs2 = kZ / 16;       // layer-2 k-steps
constexpr int kNt2 = kOut / 8;      // layer-2 n-tiles
constexpr int kW1Frags = kNt1 * kKs1 * 32;
constexpr int kW2Frags = kKs2 * kNt2 * 32;
// dynamic shared memory of the bf16 kernel: W_1 and W_2 fragments, b_1,
// b_2, W_pe and b_pe as floats, the warps' rings
constexpr int kSmemMma = 8 * (kW1Frags + kW2Frags)
                         + 4 * (kZ + kOut + 3 * kE) + 4 * kWarps * kWRing;
// ... of the float kernel: each warp's [e ; h_j] and z
constexpr int kSmemF32 = 4 * kWarps * (kIn + kZ) + 4 * kWarps * kWRing;
static_assert(kThreads == sa::kThreads, "one warp a ring, as the pairs header");

struct Args {
    const void* pos;     // [n, 2] T
    const int* ids;      // [n]
    const void* h;       // [n, kHid] T
    const void* wpe;     // [2, kE] T
    const void* bpe;     // [kE]
    const void* w1;      // [kIn, kZ]
    const void* b1;      // [kZ]
    const void* w2;      // [kZ, kOut]
    const void* b2;      // [kOut]
    float* out;          // [n, kOut]
    int n, w;
};

// The scan range of the rows t0, t0 + 1 (sa::tile_ring at kTile = 2).
__device__ __forceinline__ sa::WarpRing pair_ring(int* ring, const int t0,
                                                  const int n, const int w) {
    const sa::PairRing r = sa::tile_ring(nullptr, nullptr, t0, n, w);
    return sa::WarpRing{ring, 0, 0, r.next, r.end};
}

// ------------------------------------------------------------------ bf16
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float2 pos_of(const unsigned* pos, const int i) {
    const unsigned v = pos[i];
    return make_float2(sa::lo_bf16(v), sa::hi_bf16(v));
}

// Lane (g, t)'s A fragment of layer 1's first k-step for one row at p:
// e of the partners at qg (pair g) and qg8 (pair g + 8), columns 2t, 2t + 1,
// 2t + 8, 2t + 9 (pe0, pe1: those columns of W_pe's rows; pb: of b_pe).
__device__ __forceinline__ void emb_frag(const float2 p, const float2 qg,
                                         const float2 qg8, const float (&pe0)[4],
                                         const float (&pe1)[4],
                                         const float (&pb)[4], unsigned (&a)[4]) {
    const float rgx = rnd<bf16>(qg.x - p.x), rgy = rnd<bf16>(qg.y - p.y);
    const float r8x = rnd<bf16>(qg8.x - p.x), r8y = rnd<bf16>(qg8.y - p.y);
    float eg[4], e8[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        eg[c] = fmaf(rgy, pe1[c], rgx * pe0[c]) + pb[c];
        e8[c] = fmaf(r8y, pe1[c], r8x * pe0[c]) + pb[c];
    }
    a[0] = sa::cvt_bf16x2(eg[0], eg[1]);
    a[1] = sa::cvt_bf16x2(e8[0], e8[1]);
    a[2] = sa::cvt_bf16x2(eg[2], eg[3]);
    a[3] = sa::cvt_bf16x2(e8[2], e8[3]);
}

// The pool of rows a and b (b == a: one row) of scene sid, on the tensor
// cores.  Writes out[a] (and out[b]).
__device__ __forceinline__ void pool_rows_mma(
        const Args& A, const uint2* s_w1f, const uint2* s_w2f,
        const float* s_b1, const float* s_b2, const float (&pe0)[4],
        const float (&pe1)[4], const float (&pb)[4], int* ring, const int a,
        const int b, const int sid) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, p = lane & 15;
    const unsigned* pos = static_cast<const unsigned*>(A.pos);
    const unsigned* hw = static_cast<const unsigned*>(A.h);   // 16 words a row
    const float2 pa = pos_of(pos, a), pbb = pos_of(pos, b);
    float mxa[kNt2][2], mxb[kNt2][2];
#pragma unroll
    for (int nt = 0; nt < kNt2; ++nt)
        mxa[nt][0] = mxa[nt][1] = mxb[nt][0] = mxb[nt][1] = 0.f;
    sa::WarpRing wr = pair_ring(ring, a, A.n, A.w);
    while (true) {
        sa::warp_fill<true>(wr, A.ids, 0, sid, a);
        if (wr.count == 0) break;
        const int nb = wr.count < kMma ? wr.count : kMma;
        const int col = p < nb ? wr.ring[(wr.head + p) & (kWRing - 1)] : a;
        const int cg = __shfl_sync(kFull, col, g);
        const int cg8 = __shfl_sync(kFull, col, g + 8);
        const float2 qg = pos_of(pos, cg), qg8 = pos_of(pos, cg8);
        unsigned ea[4], eb[4], ha[2][4];
        emb_frag(pa, qg, qg8, pe0, pe1, pb, ea);
        emb_frag(pbb, qg, qg8, pe0, pe1, pb, eb);
        const unsigned* hg = hw + (size_t)cg * (kHid / 2);
        const unsigned* hg8 = hw + (size_t)cg8 * (kHid / 2);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            ha[ks][0] = hg[8 * ks + t];
            ha[ks][1] = hg8[8 * ks + t];
            ha[ks][2] = hg[8 * ks + t + 4];
            ha[ks][3] = hg8[8 * ks + t + 4];
        }
        float acca[kNt2][4], accb[kNt2][4];
#pragma unroll
        for (int nt = 0; nt < kNt2; ++nt) {
            const float2 bb = *reinterpret_cast<const float2*>(s_b2 + 8 * nt + 2 * t);
            acca[nt][0] = accb[nt][0] = acca[nt][2] = accb[nt][2] = bb.x;
            acca[nt][1] = accb[nt][1] = acca[nt][3] = accb[nt][3] = bb.y;
        }
#pragma unroll 2
        for (int ks2 = 0; ks2 < kKs2; ++ks2) {
            float za[2][4], zb[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nt1 = 2 * ks2 + half;
                const float2 bb = *reinterpret_cast<const float2*>(s_b1 + 8 * nt1 + 2 * t);
                za[half][0] = zb[half][0] = za[half][2] = zb[half][2] = bb.x;
                za[half][1] = zb[half][1] = za[half][3] = zb[half][3] = bb.y;
                const uint2* f = s_w1f + nt1 * kKs1 * 32 + lane;
                const uint2 b0 = f[0], b1 = f[32], b2 = f[64];
                sa::mma_bf16(za[half], ea, b0.x, b0.y);
                sa::mma_bf16(zb[half], eb, b0.x, b0.y);
                sa::mma_bf16(za[half], ha[0], b1.x, b1.y);
                sa::mma_bf16(zb[half], ha[0], b1.x, b1.y);
                sa::mma_bf16(za[half], ha[1], b2.x, b2.y);
                sa::mma_bf16(zb[half], ha[1], b2.x, b2.y);
            }
            unsigned a2a[4], a2b[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int half = q >> 1, r = 2 * (q & 1);
                a2a[q] = sa::cvt_bf16x2(fmaxf(za[half][r], 0.f), fmaxf(za[half][r + 1], 0.f));
                a2b[q] = sa::cvt_bf16x2(fmaxf(zb[half][r], 0.f), fmaxf(zb[half][r + 1], 0.f));
            }
            const uint2* f = s_w2f + ks2 * kNt2 * 32 + lane;
#pragma unroll
            for (int nt = 0; nt < kNt2; ++nt) {
                const uint2 bw = f[32 * nt];
                sa::mma_bf16(acca[nt], a2a, bw.x, bw.y);
                sa::mma_bf16(accb[nt], a2b, bw.x, bw.y);
            }
        }
        // relu and the max: pairs past nb enter as 0 (mx starts at 0)
        const bool vg = g < nb, vg8 = g + 8 < nb;
#pragma unroll
        for (int nt = 0; nt < kNt2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                mxa[nt][e] = fmaxf(mxa[nt][e], fmaxf(vg ? acca[nt][e] : 0.f,
                                                     vg8 ? acca[nt][e + 2] : 0.f));
                mxb[nt][e] = fmaxf(mxb[nt][e], fmaxf(vg ? accb[nt][e] : 0.f,
                                                     vg8 ? accb[nt][e + 2] : 0.f));
            }
        wr.head = (wr.head + nb) & (kWRing - 1);
        wr.count -= nb;
    }
#pragma unroll
    for (int nt = 0; nt < kNt2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
                mxa[nt][e] = fmaxf(mxa[nt][e], __shfl_xor_sync(kFull, mxa[nt][e], off));
                mxb[nt][e] = fmaxf(mxb[nt][e], __shfl_xor_sync(kFull, mxb[nt][e], off));
            }
    if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < kNt2; ++nt) {
            reinterpret_cast<float2*>(A.out + (size_t)a * kOut)[4 * nt + t] =
                make_float2(mxa[nt][0], mxa[nt][1]);
            if (b != a)
                reinterpret_cast<float2*>(A.out + (size_t)b * kOut)[4 * nt + t] =
                    make_float2(mxb[nt][0], mxb[nt][1]);
        }
    }
}

__device__ __forceinline__ void zero_row(float* out, const int i) {
    out[(size_t)i * kOut + (threadIdx.x & 31)] = 0.f;
}

__device__ __forceinline__ void pool_mma(const Args& A) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* s_w1f = reinterpret_cast<uint2*>(smem);
    uint2* s_w2f = s_w1f + kW1Frags;
    float* s_b1 = reinterpret_cast<float*>(s_w2f + kW2Frags);
    float* s_b2 = s_b1 + kZ;
    float* s_pe = s_b2 + kOut;               // W_pe rows 0, 1, then b_pe
    int* s_ring = reinterpret_cast<int*>(s_pe + 3 * kE);
    const unsigned short* w1 = static_cast<const unsigned short*>(A.w1);
    const unsigned short* w2 = static_cast<const unsigned short*>(A.w2);
    for (int e = threadIdx.x; e < kW1Frags; e += kThreads) {
        const int lane = e & 31, ks = (e >> 5) % kKs1, nt = e / (32 * kKs1);
        const int o = 8 * nt + (lane >> 2), k = 16 * ks + 2 * (lane & 3);
        s_w1f[e] = make_uint2(w1[k * kZ + o] | (unsigned)w1[(k + 1) * kZ + o] << 16,
                              w1[(k + 8) * kZ + o] | (unsigned)w1[(k + 9) * kZ + o] << 16);
    }
    for (int e = threadIdx.x; e < kW2Frags; e += kThreads) {
        const int lane = e & 31, nt = (e >> 5) % kNt2, ks = e / (32 * kNt2);
        const int o = 8 * nt + (lane >> 2), k = 16 * ks + 2 * (lane & 3);
        s_w2f[e] = make_uint2(w2[k * kOut + o] | (unsigned)w2[(k + 1) * kOut + o] << 16,
                              w2[(k + 8) * kOut + o] | (unsigned)w2[(k + 9) * kOut + o] << 16);
    }
    const bf16* b1 = static_cast<const bf16*>(A.b1);
    const bf16* b2 = static_cast<const bf16*>(A.b2);
    const bf16* wpe = static_cast<const bf16*>(A.wpe);
    const bf16* bpe = static_cast<const bf16*>(A.bpe);
    for (int e = threadIdx.x; e < kZ; e += kThreads) s_b1[e] = ld(b1[e]);
    for (int e = threadIdx.x; e < kOut; e += kThreads) s_b2[e] = ld(b2[e]);
    for (int e = threadIdx.x; e < 2 * kE; e += kThreads) s_pe[e] = ld(wpe[e]);
    for (int e = threadIdx.x; e < kE; e += kThreads) s_pe[2 * kE + e] = ld(bpe[e]);
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
    float pe0[4], pe1[4], pb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int k = 2 * t + (c & 1) + 8 * (c >> 1);
        pe0[c] = s_pe[k];
        pe1[c] = s_pe[kE + k];
        pb[c] = s_pe[2 * kE + k];
    }
    int* ring = s_ring + warp * kWRing;
    const int pairs = (A.n + 1) / 2;
    for (int r = blockIdx.x * kWarps + warp; r < pairs; r += gridDim.x * kWarps) {
        const int a = 2 * r, b = a + 1;
        const int sa_ = A.ids[a], sb = b < A.n ? A.ids[b] : -1;
        if (sa_ >= 0 && sa_ == sb) {
            pool_rows_mma(A, s_w1f, s_w2f, s_b1, s_b2, pe0, pe1, pb, ring, a, b, sa_);
            continue;
        }
        if (sa_ >= 0)
            pool_rows_mma(A, s_w1f, s_w2f, s_b1, s_b2, pe0, pe1, pb, ring, a, a, sa_);
        else
            zero_row(A.out, a);
        if (b < A.n) {
            if (sb >= 0)
                pool_rows_mma(A, s_w1f, s_w2f, s_b1, s_b2, pe0, pe1, pb, ring, b, b, sb);
            else
                zero_row(A.out, b);
        }
    }
}

// ------------------------------------------------------------------ float
__device__ __forceinline__ void pool_ffma(const Args& A) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* x = reinterpret_cast<float*>(smem) + warp * (kIn + kZ);
    float* z = x + kIn;
    int* ring = reinterpret_cast<int*>(reinterpret_cast<float*>(smem)
                                       + kWarps * (kIn + kZ)) + warp * kWRing;
    const float* pos = static_cast<const float*>(A.pos);
    const float* h = static_cast<const float*>(A.h);
    const float* wpe = static_cast<const float*>(A.wpe);
    const float* bpe = static_cast<const float*>(A.bpe);
    const float* w1 = static_cast<const float*>(A.w1);
    const float* b1 = static_cast<const float*>(A.b1);
    const float* w2 = static_cast<const float*>(A.w2);
    const float* b2 = static_cast<const float*>(A.b2);
    for (int i = blockIdx.x * kWarps + warp; i < A.n; i += gridDim.x * kWarps) {
        const int sid = A.ids[i];
        float mx = 0.f;
        if (sid >= 0) {
            const float px = pos[2 * i], py = pos[2 * i + 1];
            sa::WarpRing wr = pair_ring(ring, i, A.n, A.w);
            while (true) {
                sa::warp_fill<true>(wr, A.ids, 0, sid, i);
                if (wr.count == 0) break;
                const int j = wr.ring[wr.head];
                if (lane < kE) {
                    const float rx = pos[2 * j] - px, ry = pos[2 * j + 1] - py;
                    x[lane] = fmaf(ry, wpe[kE + lane], rx * wpe[lane]) + bpe[lane];
                }
                for (int c = lane; c < kHid; c += 32) x[kE + c] = h[(size_t)j * kHid + c];
                __syncwarp();
                for (int k = lane; k < kZ; k += 32) {
                    float s = b1[k];
                    for (int c = 0; c < kIn; ++c) s = fmaf(x[c], w1[c * kZ + k], s);
                    z[k] = fmaxf(s, 0.f);
                }
                __syncwarp();
                float s = b2[lane];
                for (int k = 0; k < kZ; ++k) s = fmaf(z[k], w2[k * kOut + lane], s);
                mx = fmaxf(mx, s);
                __syncwarp();
                wr.head = (wr.head + 1) & (kWRing - 1);
                wr.count -= 1;
            }
        }
        A.out[(size_t)i * kOut + lane] = mx;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) social_pool_kernel(const Args A) {
    if constexpr (std::is_same_v<T, bf16>)
        pool_mma(A);
    else
        pool_ffma(A);
}

template <typename T>
inline cudaError_t launch(const Args& a, cudaStream_t stream) {
    static_assert(kOut == 32, "the float kernel's lane owns an output");
    if (a.n <= 0) return cudaSuccess;
    constexpr bool kMmaPath = std::is_same_v<T, bf16>;
    constexpr int smem = kMmaPath ? kSmemMma : kSmemF32;
    auto kernel = social_pool_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long units = kMmaPath ? (a.n + 1) / 2 : a.n;
    const long long want = (units + kWarps - 1) / kWarps;
    const int blocks = (int)(want < (long long)sms * per_sm
                                 ? want : (long long)sms * per_sm);
    kernel<<<blocks, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace sp

// The C entries' arguments: pos [n, 2], ids [n] (-1: padding), h [n, 32],
// W_pe [2, 16], b_pe [16], W_1 [48, 512], b_1 [512], W_2 [512, 32], b_2
// [32] (w [in, out], contiguous, of the entry's type), out [n, 32] float;
// w the scene window (0: scan all n).
#define SP_ARGS                                                              \
    const void *pos, const int *ids, const void *h, const void *wpe,         \
        const void *bpe, const void *w1, const void *b1, const void *w2,     \
        const void *b2, float *out, int n, int w, void *stream
#define SP_PASS                                                              \
    sp::Args{pos, ids, h, wpe, bpe, w1, b1, w2, b2, out, n, w},              \
        static_cast<cudaStream_t>(stream)
