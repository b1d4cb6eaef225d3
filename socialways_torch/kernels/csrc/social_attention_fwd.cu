// Fused social-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel socialways_tpu/kernels/social_attention.py
// `_kernel` (:150-198, driven by `_pallas_forward`, :219-314).  For every
// query agent i it computes, over the agents j of the same scene (both
// valid, j != i):
//   features  dist, bearing, dca   from the last-frame states x4 (eps 1e-6)
//   embedding f_ij = W3 relu(W2 relu(W1 feat + b1) + b2) + b3   (3->32->64->F)
//   score     s_ij = f_ij . wh_j          (wh = h W + b, computed outside)
//   out_i     = sum_j softmax_j(s_ij) h_j  with a streaming softmax;
//             a row with no neighbour gives 0.
// The result equals socialways_torch/ops/social.py's dense form up to the
// order of float sums.
//
// Design.  One warp owns one query row; a block of kWarps warps shares the
// feature-MLP weights staged once in shared memory (25.6 KB at F = 64).
// The warp walks the columns 32 at a time; lane l takes column j0 + l.  The
// scene mask is tested first and a tile with no neighbour is skipped after
// one ballot, so the MLP (about 6.4k FMA a pair at F = 64) runs only for the
// pairs that exist.  No order of the scene ids is assumed: unsorted ids are
// masked, never dropped.  Each active lane runs the whole pair MLP in
// registers (a1[32], a2[64]); all lanes read the same weight at the same
// time, a shared-memory broadcast, four floats per load.  The online softmax
// keeps m, l in registers and the H-wide accumulator spread over the lanes.
//
// Bound on this card: operations.  At the serving shape (N = 256 rows,
// scenes of 2-16 agents, H = F = 64) the needed work is the same-scene pairs
// times ~12.8k FLOP of f32 FMA against ~0.2 MB of bytes; the design keeps the
// pair intermediates out of device memory entirely and skips the work of
// masked pairs, so what is left is the FMA work of the pairs that exist.

#include <cuda_runtime.h>

namespace {

constexpr int kIn = 3;      // social features: dist, bearing, dca
constexpr int kH1 = 32;     // feature-MLP hidden widths (fixed by the model)
constexpr int kH2 = 64;
constexpr int kWarps = 4;   // query rows per block
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

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

// Score s_ij of one pair: features -> MLP -> dot with wh_j.
__device__ float pair_score(const float4 xi, const float vi_norm,
                            const float4 xj, const float* __restrict__ whj,
                            const float* s_w1, const float* s_b1,
                            const float* s_w2, const float* s_b2,
                            const float* s_w3, const float* s_b3,
                            const int feat) {
    const float dpx = xi.x - xj.x, dpy = xi.y - xj.y;
    const float dvx = xi.z - xj.z, dvy = xi.w - xj.w;
    const float dist = snorm(dpx * dpx + dpy * dpy);
    const float bearing = (dpx * xi.z + dpy * xi.w) / (dist * vi_norm + 1e-6f);
    const float ttca = -(dpx * dvx + dpy * dvy) / (dvx * dvx + dvy * dvy + 1e-6f);
    const float cax = dpx + ttca * dvx, cay = dpy + ttca * dvy;
    const float dca = snorm(cax * cax + cay * cay);

    float a1[kH1];
#pragma unroll
    for (int k = 0; k < kH1; ++k) {
        float t = dist * s_w1[k];
        t = fmaf(bearing, s_w1[kH1 + k], t);
        t = fmaf(dca, s_w1[2 * kH1 + k], t);
        a1[k] = fmaxf(t + s_b1[k], 0.f);
    }

    float a2[kH2];
#pragma unroll
    for (int o = 0; o < kH2; ++o) a2[o] = 0.f;
#pragma unroll
    for (int k = 0; k < kH1; ++k) {
        const float a = a1[k];
        const float4* w = reinterpret_cast<const float4*>(s_w2 + k * kH2);
#pragma unroll
        for (int q = 0; q < kH2 / 4; ++q) {
            const float4 wq = w[q];
            a2[4 * q + 0] = fmaf(a, wq.x, a2[4 * q + 0]);
            a2[4 * q + 1] = fmaf(a, wq.y, a2[4 * q + 1]);
            a2[4 * q + 2] = fmaf(a, wq.z, a2[4 * q + 2]);
            a2[4 * q + 3] = fmaf(a, wq.w, a2[4 * q + 3]);
        }
    }
#pragma unroll
    for (int o = 0; o < kH2; ++o) a2[o] = fmaxf(a2[o] + s_b2[o], 0.f);

    float s = 0.f;
    const float4* wh4 = reinterpret_cast<const float4*>(whj);
    const float4* b34 = reinterpret_cast<const float4*>(s_b3);
#pragma unroll 1
    for (int q = 0; q < feat / 4; ++q) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kH2; ++k) {
            const float4 wq = reinterpret_cast<const float4*>(s_w3 + k * feat)[q];
            f.x = fmaf(a2[k], wq.x, f.x);
            f.y = fmaf(a2[k], wq.y, f.y);
            f.z = fmaf(a2[k], wq.z, f.z);
            f.w = fmaf(a2[k], wq.w, f.w);
        }
        const float4 b = b34[q];
        const float4 v = wh4[q];
        s = fmaf(f.x + b.x, v.x, s);
        s = fmaf(f.y + b.y, v.y, s);
        s = fmaf(f.z + b.z, v.z, s);
        s = fmaf(f.w + b.w, v.w, s);
    }
    return s;
}

__global__ void __launch_bounds__(kWarps * 32)
social_attention_fwd_kernel(const float4* __restrict__ x4,
                            const int* __restrict__ ids,
                            const float* __restrict__ h,
                            const float* __restrict__ wh,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ w2,
                            const float* __restrict__ b2,
                            const float* __restrict__ w3,
                            const float* __restrict__ b3,
                            float* __restrict__ out,
                            const int n, const int hdim, const int feat) {
    // shared layout, every part 16-byte aligned (feat % 4 == 0):
    // w2 [32, 64] | w3 [64, F] | b2 [64] | b3 [F] | w1 [3, 32] | b1 [32]
    extern __shared__ __align__(16) float smem[];
    float* s_w2 = smem;
    float* s_w3 = s_w2 + kH1 * kH2;
    float* s_b2 = s_w3 + kH2 * feat;
    float* s_b3 = s_b2 + kH2;
    float* s_w1 = s_b3 + feat;
    float* s_b1 = s_w1 + kIn * kH1;
    for (int t = threadIdx.x; t < kH1 * kH2; t += blockDim.x) s_w2[t] = w2[t];
    for (int t = threadIdx.x; t < kH2 * feat; t += blockDim.x) s_w3[t] = w3[t];
    for (int t = threadIdx.x; t < kH2; t += blockDim.x) s_b2[t] = b2[t];
    for (int t = threadIdx.x; t < feat; t += blockDim.x) s_b3[t] = b3[t];
    for (int t = threadIdx.x; t < kIn * kH1; t += blockDim.x) s_w1[t] = w1[t];
    for (int t = threadIdx.x; t < kH1; t += blockDim.x) s_b1[t] = b1[t];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i >= n) return;                      // whole warp: no barrier follows

    const int id_i = ids[i];
    float m = kNeg, l = 0.f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};     // columns lane + 32 c, H <= 128
    if (id_i >= 0) {
        const float4 xi = x4[i];
        const float vi_norm = snorm(xi.z * xi.z + xi.w * xi.w);
        for (int j0 = 0; j0 < n; j0 += 32) {
            const int j = j0 + lane;
            const bool active = j < n && j != i && ids[j] == id_i;
            const unsigned tile = __ballot_sync(kFull, active);
            if (tile == 0u) continue;

            float s = kNeg;
            if (active)
                s = pair_score(xi, vi_norm, x4[j], wh + (size_t)j * feat,
                               s_w1, s_b1, s_w2, s_b2, s_w3, s_b3, feat);
            const float m_new = fmaxf(m, warp_max(s));
            const float corr = expf(m - m_new);
            const float p = active ? expf(s - m_new) : 0.f;
            l = l * corr + warp_sum(p);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] *= corr;
            unsigned bits = tile;
            while (bits) {
                const int jj = __ffs(bits) - 1;
                bits &= bits - 1u;
                const float pj = __shfl_sync(kFull, p, jj);
                const float* hj = h + (size_t)(j0 + jj) * hdim;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int d = lane + 32 * c;
                    if (d < hdim) acc[c] = fmaf(pj, hj[d], acc[c]);
                }
            }
            m = m_new;
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < hdim)
            out[(size_t)i * hdim + d] = l > 0.f ? acc[c] / fmaxf(l, 1e-20f) : 0.f;
    }
}

}  // namespace

extern "C" int social_attention_fwd_smem_bytes(int feat) {
    return (kH1 * kH2 + kH2 * feat + kH2 + feat + kIn * kH1 + kH1)
           * (int)sizeof(float);
}

// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int social_attention_fwd(const void* x4, const void* ids,
                                    const void* h, const void* wh,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2,
                                    const void* w3, const void* b3,
                                    void* out, int n, int hdim, int feat,
                                    void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const int smem = social_attention_fwd_smem_bytes(feat);
    const dim3 grid((n + kWarps - 1) / kWarps);
    social_attention_fwd_kernel<<<grid, kWarps * 32, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x4), static_cast<const int*>(ids),
        static_cast<const float*>(h), static_cast<const float*>(wh),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(w3), static_cast<const float*>(b3),
        static_cast<float*>(out), n, hdim, feat);
    return (int)cudaGetLastError();
}
