// What the fused decode (decode_rollout_bf16.cu) and the fused encoder
// (encode_observation_bf16.cu) share of a bf16 LSTM rollout on mma.sync:
// weights staged in shared memory in B-fragment order, accumulators
// started at the bias, an LSTM cell's update in torch's precise float gate
// math, the encoder LSTM's step on a warp's 16 rows, and the capped
// persistent grid both launch on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "social_attention_pairs.cuh"   // mma_bf16, cvt_bf16x2, lo/hi_bf16

namespace lstm {

using bf16 = __nv_bfloat16;

// W [K real rows][ld] staged by a block of kThreads as KT x NT B
// fragments: entry (nt KT + kt) 32 + lane holds lane's (b0, b1) of k-tile
// kt and n-tile nt, one conflict-free 8-byte load an mma.  row_of(k) and
// col_of(n) map a padded index to W's (-1: a zero of the padding).
template <int kThreads, int KT, int NT, class RowOf, class ColOf>
__device__ void stage_frags(uint2* dst, const bf16* w, const int ld,
                            RowOf row_of, ColOf col_of) {
    for (int e = threadIdx.x; e < KT * NT * 32; e += kThreads) {
        const int lane = e & 31, f = e >> 5, kt = f % KT, nt = f / KT;
        const int n = col_of(8 * nt + (lane >> 2));
        const int k0 = 16 * kt + 2 * (lane & 3);
        auto at = [&](const int k) -> unsigned {
            const int r = row_of(k);
            return r < 0 || n < 0 ? 0u
                : (unsigned)__bfloat16_as_ushort(w[(long long)r * ld + n]);
        };
        dst[e] = make_uint2(at(k0) | at(k0 + 1) << 16,
                            at(k0 + 8) | at(k0 + 9) << 16);
    }
}

// A bias of NP padded columns as float; col_of maps them as above.
template <int kThreads, int NP, class ColOf>
__device__ void stage_bias(float* dst, const bf16* b, ColOf col_of) {
    for (int n = threadIdx.x; n < NP; n += kThreads) {
        const int j = col_of(n);
        dst[n] = j < 0 ? 0.f : __bfloat162float(b[j]);
    }
}

// The accumulators of n-tile columns col, col + 1 (col = 8 nt + 2t), for
// rows g and g + 8, started at the bias: the bias joins the sum first.
__device__ __forceinline__ void bias_init(float (&acc)[4], const float* bias,
                                          const int col) {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    acc[0] = b.x; acc[1] = b.y; acc[2] = b.x; acc[3] = b.y;
}

// torch's float sigmoid: 1 / (1 + exp(-x)), precise expf and division.
__device__ __forceinline__ float sigm(const float x) {
    return 1.0f / (1.0f + expf(-x));
}

// One hidden element of an LSTM step from its gate sums i, f, g, o and
// its old c0: c = σ(f) c0 + σ(i) tanh(g), h = σ(o) tanh(c), each product
// and sum rounded to float as torch's elementwise ops round them.
__device__ __forceinline__ void cell_update(const float i, const float f,
                                            const float g, const float o,
                                            const float c0, float& c,
                                            float& h) {
    const float ig = sigm(i);
    const float fg = sigm(f);
    const float gg = tanhf(g);
    const float og = sigm(o);
    c = __fadd_rn(__fmul_rn(fg, c0), __fmul_rn(ig, gg));
    h = __fmul_rn(og, tanhf(c));
}

// One step of the encoder LSTM for a warp's 16 rows, from its gate sums
// [e | h] W + b to the new h and c, rounded to bf16 where ops/lstm.py
// `lstm_cell` casts them.  e is the step's input as HT A k-tiles; h's
// first HT A k-tiles are the old h (h may be longer: the decode keeps it
// at the head of its [h | s | z]) and take the new h; c (bf16, the same
// layout) is updated in place.  fl holds W [2 HP, 4 HP] as 2 HT x 4 HP / 8
// B fragments (entry (nt 2 HT + kt) 32 + lane) and bl its bias as float,
// gates i, f, g, o each padded to HP = 16 HT columns: hidden n-tile 2 ot +
// j's four gates are n-tiles q HP / 8 + 2 ot + j.  kJoint of the two
// n-tiles of a hidden k-tile are summed at once: the decode takes 2 (its
// 168 registers and SASS), the encoder 1 (fewer live accumulators, as it
// was timed).
template <int HT, int kJoint, int NH>
__device__ __forceinline__ void lstm_step(unsigned (&e)[HT][4],
                                          unsigned (&h)[NH][4],
                                          unsigned (&c)[HT][4],
                                          const uint2* fl, const float* bl,
                                          const int lane) {
    static_assert(kJoint == 1 || kJoint == 2, "a k-tile has two n-tiles");
    constexpr int HP = 16 * HT;
    const int t = lane & 3;
    unsigned hn[HT][4];
#pragma unroll
    for (int ot = 0; ot < HT; ++ot)
#pragma unroll
        for (int j0 = 0; j0 < 2; j0 += kJoint) {
            float acc[4][kJoint][4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int j = 0; j < kJoint; ++j)
                    bias_init(acc[q][j], bl,
                              q * HP + 16 * ot + 8 * (j0 + j) + 2 * t);
#pragma unroll
            for (int kt = 0; kt < 2 * HT; ++kt) {
                const unsigned(&a)[4] = kt < HT ? e[kt] : h[kt - HT];
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int j = 0; j < kJoint; ++j) {
                        const uint2 b = fl[((q * HP / 8 + 2 * ot + j0 + j)
                                            * 2 * HT + kt) * 32 + lane];
                        sa::mma_bf16(acc[q][j], a, b.x, b.y);
                    }
            }
#pragma unroll
            for (int j = 0; j < kJoint; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half) {   // rows g, g + 8
                    const int w = 2 * (j0 + j) + half;
                    const unsigned cold = c[ot][w];
                    float cn[2], hv[2];
#pragma unroll
                    for (int k = 0; k < 2; ++k) {
                        const int el = 2 * half + k;
                        const float c0 = k ? sa::hi_bf16(cold)
                                           : sa::lo_bf16(cold);
                        cell_update(acc[0][j][el], acc[1][j][el],
                                    acc[2][j][el], acc[3][j][el], c0, cn[k],
                                    hv[k]);
                    }
                    c[ot][w] = sa::cvt_bf16x2(cn[0], cn[1]);
                    hn[ot][w] = sa::cvt_bf16x2(hv[0], hv[1]);
                }
        }
#pragma unroll
    for (int kt = 0; kt < HT; ++kt)
#pragma unroll
        for (int i = 0; i < 4; ++i) h[kt][i] = hn[kt][i];
}

// kernel(a) on a persistent grid: blocks of kWarps warps, a warp a tile of
// rows, as many blocks as the tiles need, capped at what the SMs hold at
// once with smem bytes of dynamic shared memory a block.
template <int kWarps, class Args>
cudaError_t persistent_launch(void (*kernel)(Args), const int smem,
                              const long long tiles, const Args& a,
                              cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kWarps * 32, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long want = (tiles + kWarps - 1) / kWarps;
    const int blocks = (int)(want < (long long)sms * per_sm
                                 ? want : (long long)sms * per_sm);
    kernel<<<blocks, kWarps * 32, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace lstm
