// The bf16 observation encoder of a rollout as one kernel (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the encoder to XLA
// (socialways_tpu/models/generator.py `encode_observation`).  It replaces
// the port's embedding and per-step LSTM loop of plain PyTorch ops in
// socialways_torch/models/generator.py `encode_observation` for bf16
// operands when no gradient is recorded (kernels/encode_observation.py).
// For every row of x [N, T, 4], from h = c = 0, for each step s < T:
//   e      = bf16(x_s We + be)                               a float sum
//   gates  = [e | h] W + b                                   float32
//   c      = bf16(σ(f) c + σ(i) tanh(g))   h = bf16(σ(o) tanh(c'))
// with the gates in torch's order i, f, g, o and c' the float c before its
// rounding.  sigmoid and tanh are the precise expf, division and tanhf
// that torch's float kernels use, and the gate products and sums are
// rounded one by one as torch's elementwise ops do; h and c are rounded to
// bf16 once a step, where ops/lstm.py `lstm_cell` casts them back.  The
// products of bf16 values are exact in float, so only the order of the
// float sums differs from the plain path's cuBLAS (the bias joins first).
// Only the final (h, c) are written.
//
// Widths.  A hidden width H <= 64 runs on the instantiation of its padded
// tile count HT = ceil(H / 16): H is read at run time for the staging and
// the stores only.  The padded gate columns have zero weights and bias, so
// their c stays 0 (σ(0) 0 + σ(0) tanh(0)) and their h 0 (σ(0) tanh(0)),
// and the padded rows of W add nothing.  A wider model is refused: the
// wrapper and the plain path take it.
//
// Bound on the H100.  A row-step is 2 (4 H + 2H 4H) = 66,048 FLOP of
// products at hidden 64 and 4 H = 256 precise sigmoid / tanh evaluations
// and H more tanh; a row reads 8 B of x a step and writes 4 H B of h and c
// once.  At 1,048,576 rows x 8 steps: 0.56 ms of products at 989 TFLOP/s
// against 0.10 ms of bytes at 3.35 TB/s, so the tensor cores and the FP32
// pipe bound it, never the bytes.
//
// Design (that of decode_rollout_bf16.cu's LSTM step: the staging, the
// step and the persistent launch are lstm_mma.cuh's, shared with it).  No
// activation leaves the SM.
// - Weights resident in shared memory: every block stages the embedding
//   (padded to one k-tile of 16 rows) and the LSTM's fused W [2H, 4H] once,
//   with their biases in float (66 KB at hidden 64), in mma.sync
//   B-fragment order: entry (nt KT + kt) 32 + lane holds lane's (b0, b1) of
//   k-tile kt and n-tile nt, one conflict-free 8-byte load an mma.
// - A warp owns a tile of 16 rows for all T steps and walks the tiles with
//   the stride of a capped, persistent grid.  h and c live in registers as
//   mma A fragments (c as bf16, as the plain path keeps it between steps);
//   the embedding's accumulator is the LSTM's A fragment once rounded.
//   Step s + 1's x is read from x while step s computes.
// - Both products of a step on mma.sync.m16n8k16 bf16 -> f32; the LSTM
//   keeps a hidden column's four gates in one lane, so its gate math needs
//   no exchange.
// - kWarps warps a block, kMinBlocks blocks an SM: chosen by timing at
//   1,048,576 rows (PERF.md's kernel table, row 12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_mma.cuh"                 // staging, bias_init, the LSTM step, launch
#include "social_attention_pairs.cuh"   // mma_bf16, cvt_bf16x2

namespace encode {

using bf16 = __nv_bfloat16;
using sa::cvt_bf16x2;
using sa::mma_bf16;
using lstm::bias_init;
using lstm::lstm_step;
using lstm::persistent_launch;
using lstm::stage_bias;
using lstm::stage_frags;

constexpr int kWarps = 16;              // warps a block, a tile each
constexpr int kMinBlocks = 1;           // blocks an SM (launch bounds)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;               // rows a tile (the mma's M)

// The padded shapes of the two products of hidden 16 HT: the embedding
// [4 -> 16 rows, HP] and the LSTM [e | h] (KL rows) -> i f g o (NL columns).
template <int HT>
struct Dims {
    static constexpr int HP = 16 * HT, KL = 2 * HP, NL = 4 * HP;
    static constexpr int FE = HP / 8, FL = KL / 16 * (NL / 8);   // fragments
    static constexpr int kSmem = (FE + FL) * 32 * 8 + (HP + NL) * 4;
};

// Everything a launch reads and writes: x [n, steps, 4] with unit columns
// and even row and step strides (in elements), h and c [n, hid]
// contiguous; weights as the port keeps them (w [in, out], b [out]).
struct Args {
    const bf16 *x, *we, *be, *wl, *bl;
    bf16 *h, *c;
    long long n, row_stride, step_stride;
    int steps, hid;
};

// Two columns of a row of the output, col < H: one 4-byte store where H
// is even (col is), else element by element.
__device__ __forceinline__ void store2(bf16* row, const int col, const int H,
                                       const unsigned v) {
    if ((H & 1) == 0) {
        *reinterpret_cast<unsigned*>(row + col) = v;
        return;
    }
    reinterpret_cast<unsigned short*>(row)[col] = (unsigned short)v;
    if (col + 1 < H)
        reinterpret_cast<unsigned short*>(row)[col + 1] =
            (unsigned short)(v >> 16);
}

template <int HT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
encode_observation_kernel(const Args p) {
    using Dm = Dims<HT>;
    constexpr int HP = Dm::HP;
    const int H = p.hid;
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* fe = reinterpret_cast<uint2*>(smem);
    uint2* fl = fe + Dm::FE * 32;
    float* be = reinterpret_cast<float*>(fl + Dm::FL * 32);
    float* bl = be + HP;

    auto below = [](const int real) {
        return [real](const int i) { return i < real ? i : -1; };
    };
    // the LSTM's rows [e | h] and gate columns i f g o, each block of H
    // padded to HP
    auto l_row = [=](const int k) {
        const int q = k % HP;
        return q < H ? (k / HP) * H + q : -1;
    };
    stage_frags<kThreads, 1, HP / 8>(fe, p.we, H, below(4), below(H));
    stage_frags<kThreads, Dm::KL / 16, Dm::NL / 8>(fl, p.wl, 4 * H, l_row,
                                                   l_row);
    stage_bias<kThreads, HP>(be, p.be, below(H));
    stage_bias<kThreads, Dm::NL>(bl, p.bl, l_row);
    __syncthreads();

    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const long long tiles = (p.n + kRows - 1) / kRows;
    const long long stride = (long long)gridDim.x * kWarps;
    for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
         tile < tiles; tile += stride) {
        const long long ra = tile * kRows + g, rb = ra + 8;
        const bool va = ra < p.n, vb = rb < p.n;
        // x_s as the embedding's A k-tile: lanes t = 0, 1 hold columns
        // 2t, 2t + 1 of rows g and g + 8, the other columns are zeros
        const bf16* xa = p.x + (va ? ra : 0) * p.row_stride + 2 * t;
        const bf16* xb = p.x + (vb ? rb : 0) * p.row_stride + 2 * t;
        const bool la = va && t < 2, lb = vb && t < 2;
        auto x_at = [&](const bf16* row, const bool v, const int s) {
            return v ? __ldg(reinterpret_cast<const unsigned*>(
                           row + s * p.step_stride)) : 0u;
        };
        unsigned xa_s = p.steps > 0 ? x_at(xa, la, 0) : 0u;
        unsigned xb_s = p.steps > 0 ? x_at(xb, lb, 0) : 0u;

        unsigned h[HT][4], c[HT][4];
#pragma unroll
        for (int kt = 0; kt < HT; ++kt)
#pragma unroll
            for (int i = 0; i < 4; ++i) h[kt][i] = c[kt][i] = 0u;

        for (int s = 0; s < p.steps; ++s) {
            const unsigned xk[4] = {xa_s, xb_s, 0u, 0u};
            if (s + 1 < p.steps) {
                xa_s = x_at(xa, la, s + 1);
                xb_s = x_at(xb, lb, s + 1);
            }
            // e = bf16(x_s We + be), HT A k-tiles
            unsigned e[HT][4];
#pragma unroll
            for (int ot = 0; ot < HT; ++ot)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    float acc[4];
                    bias_init(acc, be, 16 * ot + 8 * j + 2 * t);
                    const uint2 b = fe[(2 * ot + j) * 32 + lane];
                    mma_bf16(acc, xk, b.x, b.y);
                    e[ot][2 * j] = cvt_bf16x2(acc[0], acc[1]);
                    e[ot][2 * j + 1] = cvt_bf16x2(acc[2], acc[3]);
                }

            // the LSTM on [e | h] (h, c updated in place)
            lstm_step<HT, 1>(e, h, c, fl, bl, lane);
        }

        // the final h and c: A k-tile kt's words 2 half + r are row g + 8 r,
        // columns 16 kt + 8 half + 2t, + 1
#pragma unroll
        for (int kt = 0; kt < HT; ++kt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int col = 16 * kt + 8 * half + 2 * t;
                if (col >= H) continue;
                if (va) {
                    store2(p.h + ra * H, col, H, h[kt][2 * half]);
                    store2(p.c + ra * H, col, H, c[kt][2 * half]);
                }
                if (vb) {
                    store2(p.h + rb * H, col, H, h[kt][2 * half + 1]);
                    store2(p.c + rb * H, col, H, c[kt][2 * half + 1]);
                }
            }
    }
}

template <int HT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    using Dm = Dims<HT>;
    static_assert(Dm::kSmem <= 227 * 1024, "weights past an SM's memory");
    return persistent_launch<kWarps>(encode_observation_kernel<HT>,
                                     Dm::kSmem, (a.n + kRows - 1) / kRows, a,
                                     stream);
}

}  // namespace encode

// The encoder of n rows of x [n, steps, 4] (unit columns, row and step
// strides in elements, both even, x 4-byte aligned) into h and c [n,
// hidden] (contiguous, written whole).  Weights as the port keeps them,
// bf16 and contiguous: we be the embedding 4 -> hidden, wl bl the encoder
// LSTM [2 hidden, 4 hidden].  Returns a CUDA error code;
// cudaErrorInvalidValue for a hidden width past 64 or a layout it cannot
// take.
extern "C" int encode_observation_bf16(
    const void* x, const void* we, const void* be, const void* wl,
    const void* bl, void* h, void* c, long long n, long long row_stride,
    long long step_stride, int steps, int hidden, void* stream) {
    using namespace encode;
    if (hidden < 1 || hidden > 64 || n < 0 || steps < 0 || (row_stride & 1)
        || (step_stride & 1) || (reinterpret_cast<unsigned long long>(x) & 3))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(we),
                 static_cast<const bf16*>(be), static_cast<const bf16*>(wl),
                 static_cast<const bf16*>(bl), static_cast<bf16*>(h),
                 static_cast<bf16*>(c), n, row_stride, step_stride, steps,
                 hidden};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch ((hidden + 15) / 16) {
        case 1: return (int)launch<1>(a, st);
        case 2: return (int)launch<2>(a, st);
        case 3: return (int)launch<3>(a, st);
        default: return (int)launch<4>(a, st);
    }
}
