// Social-attention backward for Hopper (sm_90a): the dq and dkv kernels.
//
// Replace the Pallas TPU kernels of socialways_tpu/kernels/social_attention.py
// `_bwd_dq_kernel` (:317-369) and `_bwd_dkv_kernel` (:372-461), driven by
// `_pallas_backward` (:464-591).  The forward (social_attention_fwd.cu) saved
// the per-row softmax stats (m_i, l_i).  For every same-scene pair (i, j),
// both valid, i != j, the kernels rebuild
//   a1 = relu(W1 feat_ij + b1), a2 = relu(W2 a1 + b2)   (3->32->64)
//   s_ij = a2 . u_j + c_j   with u_j = W3 wh_j, c_j = b3 . wh_j  (= f_ij . wh_j)
//   a_ij = exp(s_ij - m_i) / max(l_i, 1e-20)
//   ds_ij = a_ij (g_i . h_j - r_i),  r_i = g_i . out_i
// and pull ds_ij back through the pair MLP (df_ij = ds_ij wh_j, so the
// cotangent of a2 is ds_ij u_j) and the pair features:
//   dq  (one warp per row i, lanes over j):  dx_i = sum_j d s_ij / d x_i
//   dkv (one warp per column j, lanes over i):
//        dh_j = sum_i a_ij g_i,   dx_j = sum_i d s_ij / d x_j,
//        A_j = sum_i ds_ij a2_ij [64], S_j = sum_i ds_ij,
//        dwh_j = A_j W3 + S_j b3 (= sum_i ds_ij f_ij),
//        per-warp partial sums of dW2, db2, dW1, db1;
//   finalize: dW3 = sum_j A_j (x) wh_j, db3 = sum_j S_j wh_j, and the
//        per-warp partials of dW2, db2, dW1, db1 added in a fixed order.
// The TPU kernel summed the weight gradients across its sequential grid;
// here the blocks run in parallel, so each warp keeps its own partial sums
// and the finalize pass adds them warp by warp: deterministic, no atomics.
//
// Design.  A warp walks the other index 32 at a time with the scene mask
// tested first (one ballot skips a tile with no pair).  Each active lane
// recomputes its pair in registers (a1[32], a2[64]).  In dkv the lanes then
// stage a1, ds*a2, the a2 cotangent and the a1 cotangent in shared memory,
// and lane l adds row l of the dW2 outer product (64 FMA a pair) and its
// entries of db2, dW1, db1, A_j: the outer-product sums cost the same as the
// pair work and need no atomics.  u_j and c_j come from a prologue kernel
// (bwd_prep) so the score recompute is 64 FMA instead of 64 F.
//
// Bound on this card: operations.  Per same-scene pair dq does ~4.4k FMA
// (features, 3->32->64 recompute, score, the 64->32 and 32->3 cotangents),
// dkv ~6.5k (the same plus the dW2 outer product); both are f32 FMA work
// against ~2 KB of bytes a row.  The pair intermediates never reach device
// memory, and pairs outside a scene cost one id test.

#include <cuda_runtime.h>

namespace {

constexpr int kIn = 3;
constexpr int kH1 = 32;
constexpr int kH2 = 64;
constexpr int kDqWarps = 4;    // rows per dq block
constexpr int kKvWarps = 2;    // warps per dkv block
constexpr int kKvMaxWarps = 512;   // dkv warps in all: bounds the partials
constexpr int kPartial = kH1 * kH2 + kH2 + kIn * kH1 + kH1;   // 2240
constexpr unsigned kFull = 0xffffffffu;

// per-warp staging of 32 pairs in dkv (padded against bank conflicts)
constexpr int kA1Stride = kH1 + 1;
constexpr int kA2Stride = kH2 + 1;
constexpr int kStage = 32 * kA1Stride       // a1
                     + 32 * kA2Stride       // ds * a2
                     + 32 * kA2Stride       // cotangent of z2
                     + 32 * kA1Stride       // cotangent of z1
                     + 32 * 4;              // features

__device__ __forceinline__ float snorm(float sq) {
    return sq > 0.f ? sqrtf(sq) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// The pair features and the intermediates their backward needs; the same
// arithmetic as pair_score in social_attention_fwd.cu.
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

// a1 = relu(W1 feat + b1), a2 = relu(W2 a1 + b2); returns a2 . u + c.
__device__ __forceinline__ float pair_recompute(
        const Geo& q, const float* s_w1, const float* s_b1, const float* s_w2,
        const float* s_b2, const float* u, const float c, float* a1,
        float* a2) {
#pragma unroll
    for (int k = 0; k < kH1; ++k) {
        float t = q.feat[0] * s_w1[k];
        t = fmaf(q.feat[1], s_w1[kH1 + k], t);
        t = fmaf(q.feat[2], s_w1[2 * kH1 + k], t);
        a1[k] = fmaxf(t + s_b1[k], 0.f);
    }
#pragma unroll
    for (int o = 0; o < kH2; ++o) a2[o] = 0.f;
#pragma unroll
    for (int k = 0; k < kH1; ++k) {
        const float a = a1[k];
        const float4* w = reinterpret_cast<const float4*>(s_w2 + k * kH2);
#pragma unroll
        for (int q4 = 0; q4 < kH2 / 4; ++q4) {
            const float4 wq = w[q4];
            a2[4 * q4 + 0] = fmaf(a, wq.x, a2[4 * q4 + 0]);
            a2[4 * q4 + 1] = fmaf(a, wq.y, a2[4 * q4 + 1]);
            a2[4 * q4 + 2] = fmaf(a, wq.z, a2[4 * q4 + 2]);
            a2[4 * q4 + 3] = fmaf(a, wq.w, a2[4 * q4 + 3]);
        }
    }
    float s = c;
#pragma unroll
    for (int o = 0; o < kH2; ++o) {
        a2[o] = fmaxf(a2[o] + s_b2[o], 0.f);
        s = fmaf(a2[o], u[o], s);
    }
    return s;
}

// The cotangent of z1 from that of z2 (dz2 [64]), written over a1 where
// a1 > 0 and 0 elsewhere: dz1_k = [a1_k > 0] sum_o W2[k][o] dz2_o.
__device__ __forceinline__ void z1_cotangent(const float* s_w2,
                                             const float* dz2, float* a1) {
    // reload W2 from shared memory: without this barrier the compiler may
    // keep all 2048 values from pair_recompute live, and spill them
    asm volatile("" ::: "memory");
#pragma unroll
    for (int k = 0; k < kH1; ++k) {
        const float4* w = reinterpret_cast<const float4*>(s_w2 + k * kH2);
        float t = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < kH2 / 4; ++q4) {
            const float4 wq = w[q4];
            t = fmaf(wq.x, dz2[4 * q4 + 0], t);
            t = fmaf(wq.y, dz2[4 * q4 + 1], t);
            t = fmaf(wq.z, dz2[4 * q4 + 2], t);
            t = fmaf(wq.w, dz2[4 * q4 + 3], t);
        }
        a1[k] = a1[k] > 0.f ? t : 0.f;
    }
}

__device__ __forceinline__ void feat_cotangent(const float* s_w1,
                                               const float* dz1, float* gf) {
#pragma unroll
    for (int c = 0; c < kIn; ++c) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < kH1; ++k) t = fmaf(s_w1[c * kH1 + k], dz1[k], t);
        gf[c] = t;
    }
}

__device__ __forceinline__ void load_mlp12(const float* w1, const float* b1,
                                           const float* w2, const float* b2,
                                           float* s_w1, float* s_b1,
                                           float* s_w2, float* s_b2) {
    for (int t = threadIdx.x; t < kH1 * kH2; t += blockDim.x) s_w2[t] = w2[t];
    for (int t = threadIdx.x; t < kH2; t += blockDim.x) s_b2[t] = b2[t];
    for (int t = threadIdx.x; t < kIn * kH1; t += blockDim.x) s_w1[t] = w1[t];
    for (int t = threadIdx.x; t < kH1; t += blockDim.x) s_b1[t] = b1[t];
}

// u = wh W3^T [N, 64], c = wh . b3 [N]: one block of 64 threads a row.
__global__ void bwd_prep_kernel(const float* __restrict__ wh,
                                const float* __restrict__ w3,
                                const float* __restrict__ b3,
                                float* __restrict__ u, float* __restrict__ c,
                                const int feat) {
    const int n = blockIdx.x, k = threadIdx.x;
    const float* whn = wh + (size_t)n * feat;
    float t = 0.f;
    for (int f = 0; f < feat; ++f) t = fmaf(w3[k * feat + f], whn[f], t);
    u[(size_t)n * kH2 + k] = t;
    if (k == 0) {
        float s = 0.f;
        for (int f = 0; f < feat; ++f) s = fmaf(b3[f], whn[f], s);
        c[n] = s;
    }
}

__global__ void __launch_bounds__(kDqWarps * 32)
bwd_dq_kernel(const float4* __restrict__ x4, const int* __restrict__ ids,
              const float* __restrict__ h, const float* __restrict__ g,
              const float2* __restrict__ stats, const float* __restrict__ r,
              const float* __restrict__ u, const float* __restrict__ cvec,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              float4* __restrict__ dx, const int n, const int hdim) {
    // shared: w2 [32, 64] | b2 [64] | w1 [3, 32] | b1 [32] | g_i per warp
    __shared__ __align__(16) float s_w2[kH1 * kH2];
    __shared__ float s_b2[kH2];
    __shared__ float s_w1[kIn * kH1];
    __shared__ float s_b1[kH1];
    __shared__ float s_g[kDqWarps][128];
    load_mlp12(w1, b1, w2, b2, s_w1, s_b1, s_w2, s_b2);
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x * kDqWarps + warp;
    if (i >= n) return;                      // whole warp: no barrier follows

    const int id_i = ids[i];
    const float2 st = stats[i];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (id_i >= 0 && st.y > 0.f) {
        for (int d = lane; d < hdim; d += 32) s_g[warp][d] = g[(size_t)i * hdim + d];
        __syncwarp();
        const float4 xi = x4[i];
        const float vi_norm = snorm(xi.z * xi.z + xi.w * xi.w);
        const float l_i = fmaxf(st.y, 1e-20f), r_i = r[i];
        for (int j0 = 0; j0 < n; j0 += 32) {
            const int j = j0 + lane;
            const bool active = j < n && j != i && ids[j] == id_i;
            if (__ballot_sync(kFull, active) == 0u) continue;
            if (active) {
                const Geo q = pair_geo(xi, vi_norm, x4[j]);
                const float* uj = u + (size_t)j * kH2;
                float a1[kH1], a2[kH2];
                const float s = pair_recompute(q, s_w1, s_b1, s_w2, s_b2, uj,
                                               cvec[j], a1, a2);
                const float a = expf(s - st.x) / l_i;
                const float* hj = h + (size_t)j * hdim;
                float gh = 0.f;
                for (int d = 0; d < hdim; ++d)
                    gh = fmaf(s_g[warp][d], hj[d], gh);
                const float ds = a * (gh - r_i);
#pragma unroll
                for (int o = 0; o < kH2; ++o)
                    a2[o] = a2[o] > 0.f ? ds * uj[o] : 0.f;
                z1_cotangent(s_w2, a2, a1);
                float gf[kIn];
                feat_cotangent(s_w1, a1, gf);
                float4 gi, gj;
                geo_backward(q, xi, vi_norm, gf, gi, gj);
                acc.x += gi.x; acc.y += gi.y; acc.z += gi.z; acc.w += gi.w;
            }
            __syncwarp();
        }
    }
    acc.x = warp_sum(acc.x); acc.y = warp_sum(acc.y);
    acc.z = warp_sum(acc.z); acc.w = warp_sum(acc.w);
    if (lane == 0) dx[i] = acc;
}

__global__ void __launch_bounds__(kKvWarps * 32)
bwd_dkv_kernel(const float4* __restrict__ x4, const int* __restrict__ ids,
               const float* __restrict__ h, const float* __restrict__ g,
               const float2* __restrict__ stats, const float* __restrict__ r,
               const float* __restrict__ u, const float* __restrict__ cvec,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ w3, const float* __restrict__ b3,
               float4* __restrict__ dx, float* __restrict__ dh,
               float* __restrict__ dwh, float* __restrict__ a_sum,
               float* __restrict__ s_sum, float* __restrict__ partial,
               const int n, const int hdim, const int feat) {
    // shared, 16-byte aligned parts: w2 [32,64] | w3 [64,F] | b2 [64] |
    // b3 [F] | w1 [3,32] | b1 [32] | per warp: u_j [64] | h_j [128] |
    // A_j [64] | staging
    extern __shared__ __align__(16) float smem[];
    float* s_w2 = smem;
    float* s_w3 = s_w2 + kH1 * kH2;
    float* s_b2 = s_w3 + kH2 * feat;
    float* s_b3 = s_b2 + kH2;
    float* s_w1 = s_b3 + feat;
    float* s_b1 = s_w1 + kIn * kH1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* s_warp = s_b1 + kH1 + warp * (kH2 + 128 + kH2 + kStage);
    float* s_u = s_warp;
    float* s_h = s_u + kH2;
    float* s_A = s_h + 128;
    float* st_a1 = s_A + kH2;
    float* st_a2ds = st_a1 + 32 * kA1Stride;
    float* st_dz2 = st_a2ds + 32 * kA2Stride;
    float* st_dz1 = st_dz2 + 32 * kA2Stride;
    float* st_feat = st_dz1 + 32 * kA1Stride;
    load_mlp12(w1, b1, w2, b2, s_w1, s_b1, s_w2, s_b2);
    for (int t = threadIdx.x; t < kH2 * feat; t += blockDim.x) s_w3[t] = w3[t];
    for (int t = threadIdx.x; t < feat; t += blockDim.x) s_b3[t] = b3[t];
    __syncthreads();

    const int wid = blockIdx.x * kKvWarps + warp;
    const int n_warps = gridDim.x * kKvWarps;
    // weight-gradient partials of this warp: lane l owns dW2 row l, db2
    // entries l and l + 32, dW1 column l and db1 entry l
    float p_w2[kH2];
#pragma unroll
    for (int o = 0; o < kH2; ++o) p_w2[o] = 0.f;
    float p_b2[2] = {0.f, 0.f}, p_w1[kIn] = {0.f, 0.f, 0.f}, p_b1 = 0.f;

    for (int j = wid; j < n; j += n_warps) {
        const int id_j = ids[j];
        float A[2] = {0.f, 0.f}, S = 0.f;
        float acc_h[4] = {0.f, 0.f, 0.f, 0.f};
        float4 dxj = make_float4(0.f, 0.f, 0.f, 0.f);
        if (id_j >= 0) {
            const float4 xj = x4[j];
            s_u[lane] = u[(size_t)j * kH2 + lane];
            s_u[lane + 32] = u[(size_t)j * kH2 + lane + 32];
            for (int d = lane; d < hdim; d += 32) s_h[d] = h[(size_t)j * hdim + d];
            const float c_j = cvec[j];
            __syncwarp();
            for (int i0 = 0; i0 < n; i0 += 32) {
                const int i = i0 + lane;
                const bool active = i < n && i != j && ids[i] == id_j;
                const unsigned tile = __ballot_sync(kFull, active);
                if (tile == 0u) continue;
                float a = 0.f, ds = 0.f;
                float4 gj = make_float4(0.f, 0.f, 0.f, 0.f);
                if (active) {
                    const float4 xi = x4[i];
                    const float vi_norm = snorm(xi.z * xi.z + xi.w * xi.w);
                    const float2 st = stats[i];
                    const Geo q = pair_geo(xi, vi_norm, xj);
                    float a1[kH1], a2[kH2];
                    const float s = pair_recompute(q, s_w1, s_b1, s_w2, s_b2,
                                                   s_u, c_j, a1, a2);
                    a = expf(s - st.x) / fmaxf(st.y, 1e-20f);
                    const float* gi = g + (size_t)i * hdim;
                    float gh = 0.f;
                    for (int d = 0; d < hdim; ++d) gh = fmaf(gi[d], s_h[d], gh);
                    ds = a * (gh - r[i]);
#pragma unroll
                    for (int k = 0; k < kH1; ++k) st_a1[lane * kA1Stride + k] = a1[k];
#pragma unroll
                    for (int o = 0; o < kH2; ++o) {
                        st_a2ds[lane * kA2Stride + o] = ds * a2[o];
                        a2[o] = a2[o] > 0.f ? ds * s_u[o] : 0.f;
                        st_dz2[lane * kA2Stride + o] = a2[o];
                    }
                    z1_cotangent(s_w2, a2, a1);
#pragma unroll
                    for (int k = 0; k < kH1; ++k) st_dz1[lane * kA1Stride + k] = a1[k];
#pragma unroll
                    for (int c = 0; c < kIn; ++c) st_feat[lane * 4 + c] = q.feat[c];
                    if (dx != nullptr) {
                        float gf[kIn];
                        feat_cotangent(s_w1, a1, gf);
                        float4 gi4;
                        geo_backward(q, xi, vi_norm, gf, gi4, gj);
                    }
                }
                __syncwarp();
                S += warp_sum(ds);
                if (dx != nullptr) {
                    dxj.x += warp_sum(gj.x); dxj.y += warp_sum(gj.y);
                    dxj.z += warp_sum(gj.z); dxj.w += warp_sum(gj.w);
                }
                unsigned bits = tile;
                while (bits) {
                    const int p = __ffs(bits) - 1;
                    bits &= bits - 1u;
                    const float ap = __shfl_sync(kFull, a, p);
                    const float* gp = g + (size_t)(i0 + p) * hdim;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int d = lane + 32 * c;
                        if (d < hdim) acc_h[c] = fmaf(ap, gp[d], acc_h[c]);
                    }
                    const float a1v = st_a1[p * kA1Stride + lane];
                    const float* dz2p = st_dz2 + p * kA2Stride;
#pragma unroll
                    for (int o = 0; o < kH2; ++o) p_w2[o] = fmaf(a1v, dz2p[o], p_w2[o]);
                    p_b2[0] += dz2p[lane];
                    p_b2[1] += dz2p[lane + 32];
                    A[0] += st_a2ds[p * kA2Stride + lane];
                    A[1] += st_a2ds[p * kA2Stride + lane + 32];
                    const float dz1v = st_dz1[p * kA1Stride + lane];
#pragma unroll
                    for (int c = 0; c < kIn; ++c)
                        p_w1[c] = fmaf(st_feat[p * 4 + c], dz1v, p_w1[c]);
                    p_b1 += dz1v;
                }
                __syncwarp();
            }
        }
        // column epilogue: A_j, S_j for the finalize pass, dwh_j, dh_j, dx_j
        s_A[lane] = A[0];
        s_A[lane + 32] = A[1];
        a_sum[(size_t)j * kH2 + lane] = A[0];
        a_sum[(size_t)j * kH2 + lane + 32] = A[1];
        if (lane == 0) s_sum[j] = S;
        __syncwarp();
        for (int f = lane; f < feat; f += 32) {
            float t = S * s_b3[f];
            for (int k = 0; k < kH2; ++k) t = fmaf(s_A[k], s_w3[k * feat + f], t);
            dwh[(size_t)j * feat + f] = t;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int d = lane + 32 * c;
            if (d < hdim) dh[(size_t)j * hdim + d] = acc_h[c];
        }
        if (dx != nullptr && lane == 0) dx[j] = dxj;
        __syncwarp();
    }
    float* part = partial + (size_t)wid * kPartial;
#pragma unroll
    for (int o = 0; o < kH2; ++o) part[lane * kH2 + o] = p_w2[o];
    part[kH1 * kH2 + lane] = p_b2[0];
    part[kH1 * kH2 + lane + 32] = p_b2[1];
#pragma unroll
    for (int c = 0; c < kIn; ++c) part[kH1 * kH2 + kH2 + c * kH1 + lane] = p_w1[c];
    part[kH1 * kH2 + kH2 + kIn * kH1 + lane] = p_b1;
}

// Second pass.  Blocks 0..63: row k of dW3 = sum_j A[j][k] wh_j; block 64:
// db3 = sum_j S_j wh_j; the rest: the dkv warps' partials of dW2, db2, dW1,
// db1 added warp by warp.  Every sum runs in a fixed order.
__global__ void bwd_finalize_kernel(const float* __restrict__ wh,
                                    const float* __restrict__ a_sum,
                                    const float* __restrict__ s_sum,
                                    const float* __restrict__ partial,
                                    float* __restrict__ dw3,
                                    float* __restrict__ db3,
                                    float* __restrict__ dmlp12,
                                    const int n, const int feat,
                                    const int n_warps) {
    const int b = blockIdx.x, t = threadIdx.x;
    if (b <= kH2) {
        if (t >= feat) return;
        float acc = 0.f;
        for (int j = 0; j < n; ++j) {
            const float w = b < kH2 ? a_sum[(size_t)j * kH2 + b] : s_sum[j];
            acc = fmaf(w, wh[(size_t)j * feat + t], acc);
        }
        if (b < kH2) dw3[b * feat + t] = acc;
        else db3[t] = acc;
        return;
    }
    const int e = (b - kH2 - 1) * blockDim.x + t;
    if (e >= kPartial) return;
    float acc = 0.f;
    for (int w = 0; w < n_warps; ++w) acc += partial[(size_t)w * kPartial + e];
    dmlp12[e] = acc;
}

int dkv_warps(int n) { return n < kKvMaxWarps ? n : kKvMaxWarps; }

size_t dkv_smem_bytes(int feat) {
    return (size_t)(kH1 * kH2 + kH2 * feat + kH2 + feat + kIn * kH1 + kH1
                    + kKvWarps * (kH2 + 128 + kH2 + kStage)) * sizeof(float);
}

}  // namespace

// Scratch sizes the caller allocates for social_attention_bwd_dkv, in floats.
extern "C" int social_attention_bwd_partial_floats(int n) {
    const int blocks = (dkv_warps(n) + kKvWarps - 1) / kKvWarps;
    return blocks * kKvWarps * kPartial;
}

// dx_i [N, 4].  u [N, 64] and c [N] are scratch.  Launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int social_attention_bwd_dq(
        const void* x4, const void* ids, const void* h, const void* wh,
        const void* g, const void* stats, const void* r, const void* w1,
        const void* b1, const void* w2, const void* b2, const void* w3,
        const void* b3, void* u, void* c, void* dx, int n, int hdim,
        int feat, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bwd_prep_kernel<<<n, kH2, 0, st>>>(
        static_cast<const float*>(wh), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<float*>(u),
        static_cast<float*>(c), feat);
    bwd_dq_kernel<<<(n + kDqWarps - 1) / kDqWarps, kDqWarps * 32, 0, st>>>(
        static_cast<const float4*>(x4), static_cast<const int*>(ids),
        static_cast<const float*>(h), static_cast<const float*>(g),
        static_cast<const float2*>(stats), static_cast<const float*>(r),
        static_cast<const float*>(u), static_cast<const float*>(c),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<float4*>(dx), n, hdim);
    return (int)cudaGetLastError();
}

// dx_j [N, 4] (skipped when dx is null), dh_j [N, H], dwh_j [N, F],
// dw3 [64, F], db3 [F] and dmlp12 [2240] = dW2 [32, 64] | db2 [64] |
// dW1 [3, 32] | db1 [32].  u [N, 64], c [N], a_sum [N, 64], s_sum [N] and
// partial [social_attention_bwd_partial_floats(n)] are scratch.
extern "C" int social_attention_bwd_dkv(
        const void* x4, const void* ids, const void* h, const void* wh,
        const void* g, const void* stats, const void* r, const void* w1,
        const void* b1, const void* w2, const void* b2, const void* w3,
        const void* b3, void* u, void* c, void* a_sum, void* s_sum,
        void* partial, void* dx, void* dh, void* dwh, void* dw3, void* db3,
        void* dmlp12, int n, int hdim, int feat, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = dkv_smem_bytes(feat);
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    bwd_prep_kernel<<<n, kH2, 0, st>>>(
        static_cast<const float*>(wh), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<float*>(u),
        static_cast<float*>(c), feat);
    const int blocks = (dkv_warps(n) + kKvWarps - 1) / kKvWarps;
    bwd_dkv_kernel<<<blocks, kKvWarps * 32, smem, st>>>(
        static_cast<const float4*>(x4), static_cast<const int*>(ids),
        static_cast<const float*>(h), static_cast<const float*>(g),
        static_cast<const float2*>(stats), static_cast<const float*>(r),
        static_cast<const float*>(u), static_cast<const float*>(c),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(w3), static_cast<const float*>(b3),
        static_cast<float4*>(dx), static_cast<float*>(dh),
        static_cast<float*>(dwh), static_cast<float*>(a_sum),
        static_cast<float*>(s_sum), static_cast<float*>(partial), n, hdim,
        feat);
    const int fin_blocks = kH2 + 1 + (kPartial + 127) / 128;
    bwd_finalize_kernel<<<fin_blocks, 128, 0, st>>>(
        static_cast<const float*>(wh), static_cast<const float*>(a_sum),
        static_cast<const float*>(s_sum), static_cast<const float*>(partial),
        static_cast<float*>(dw3), static_cast<float*>(db3),
        static_cast<float*>(dmlp12), n, feat, blocks * kKvWarps);
    return (int)cudaGetLastError();
}
