// The bf16 FC decode of a rollout as one kernel (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the decode to XLA
// (socialways_tpu/models/generator.py `decode_rollout`).  It replaces the
// port's per-step loop of plain PyTorch ops in
// socialways_torch/models/generator.py `decode_rollout` for the bf16 FC
// decoder when no gradient is recorded (kernels/decode_rollout.py).  For
// every output row r of R N rows, with prepared row i = r mod N (the K
// draws of a forecast read the same encoding) and n_next steps:
//   x    = [h | s | z_r]                                     bf16
//   v    = L4(L3(lrelu(L2(lrelu(L1(x))))))  Lk(x) = bf16(x Wk + bk)
//   p    = bf16(v + p)                      out[r, step] = [p | v]
//   e    = bf16([p | v] We + be)
//   (h, c) = LSTM([e | h] W + b, c)         gates float32, h, c rounded
// lrelu takes the bf16 slope bf16(0.2); sigmoid and tanh are the precise
// expf, division and tanhf that torch's float kernels use, and the gate
// products and sums are rounded one by one as torch's elementwise ops do.
// The sums of the products run in another order than cuBLAS's (and the
// bias joins the sum first): nothing else differs from the plain decode.
//
// Widths.  A model of hidden H, social context S and noise Z runs on the
// instantiation of the smallest padded shape that holds it (``kShapes``
// below: h and s padded to 16 T columns, z to 16 ZT): H, S and Z are read
// at run time, only the padded tiles are compiled.  Layer k's outputs are
// padded as far as those of the padded input [16 T | 16 T | 16 ZT] would
// be, so at the crowd widths (64, 64, 32) the shapes are exact.  Those
// widths also have an instantiation of their own (``kExact``) that knows
// them at compile time and reads the operands two columns a load: the
// run-time widths cost registers, and the crowd shape would spill (20
// bytes at the 168-register cap).  A model wider than every
// instantiation (H or S above 64, Z above 64) is refused:
// at the command line's widths (h, h, h / 2) hidden 80 would stage 248 KB
// of weights, past the 227 KB of an SM.
//
// Bound on the H100.  A row-step is ~149k FLOP of products (2 (160 160 +
// 160 80 + 80 40 + 40 2 + 4 64 + 128 256) at hidden 64, d = 160) and 320
// precise sigmoid / tanh evaluations; it reads ~450 B of state once a
// rollout and writes 8 B.  So the tensor cores and the FP32 pipe bound it,
// never the bytes: 1.9 ms of products at 989 TFLOP/s for 1M rows x 12
// steps against 0.2 ms of bytes at 3.35 TB/s.
//
// Design.  Intermediates never leave the SM.  The staging, the LSTM step
// and the persistent launch are lstm_mma.cuh's, shared with the fused
// encoder (encode_observation_bf16.cu); the decode sums a gate's two
// n-tiles of a hidden k-tile at once (its 168 registers).
// - Weights resident in shared memory: every block stages the decoder's
//   four layers, the embedding and the encoder LSTM's fused W [2h, 4h] once
//   (~150 KB bf16 at hidden 64, with their biases in float), each in
//   mma.sync B-fragment order: entry (nt KT + kt) 32 + lane holds lane's
//   (b0, b1) of k-tile kt and n-tile nt, one conflict-free 8-byte load an
//   mma.  Widths that are not multiples of the mma shape are zero-padded
//   there: h, s and z each to their padded shape (the layer-1 rows and the
//   LSTM's rows and gate columns are remapped), every layer's outputs to
//   16, the 2-wide last layer to 8.  The zeros add nothing and keep padded
//   columns 0.
// - A warp owns a tile of 16 rows for the whole rollout and walks the
//   tiles with the stride of a capped, persistent grid (one block an SM).
//   h, c, s and z live in registers as mma A fragments; every layer's
//   accumulator is the next layer's A fragment once rounded (C tiles 2j,
//   2j + 1 are A k-tile j), so no activation goes through memory.  Each
//   step's [p | v] is written straight into the [R N, n_next, 4] output.
// - All six products of a step (L1-L4, the embedding, the LSTM) run on
//   mma.sync.m16n8k16 bf16 -> f32; the LSTM keeps a hidden column's four
//   gates in one lane, so its gate math needs no exchange.
// - 12 warps a block fit 168 registers with no spill, and the warps hide
//   each other's mma and gate-math latency: on an H100, 1M rows took 9.4
//   ms (20 % of the bound above) against 11.6 with 8 warps (190
//   registers); with fast-math gates it would take ~5.5, so the precise
//   gate math is about half the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_mma.cuh"                 // staging, bias_init, the LSTM step, launch
#include "social_attention_pairs.cuh"   // mma_bf16, cvt_bf16x2, lo/hi_bf16

namespace decode {

using bf16 = __nv_bfloat16;
using sa::cvt_bf16x2;
using sa::hi_bf16;
using sa::lo_bf16;
using sa::mma_bf16;
using lstm::bias_init;
using lstm::lstm_step;
using lstm::persistent_launch;
using lstm::stage_bias;
using lstm::stage_frags;

constexpr int kWarps = 12;              // warps a block, a tile each (168 registers)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;               // rows a tile (the mma's M)
constexpr unsigned kFull = 0xffffffffu;

constexpr int pad16(const int w) { return (w + 15) / 16 * 16; }

// The padded shapes of the six products of a model whose h and s are
// padded to 16 T columns and z to 16 ZT: a decoder input [h | s | z] of at
// most K1 columns, D = H + S + Z, so layer k's D / 2^(k-1) outputs take
// at most N1, N2, N3.
template <int T, int ZT>
struct Dims {
    static constexpr int HP = 16 * T, SP = 16 * T, ZP = 16 * ZT;
    static constexpr int K1 = HP + SP + ZP;           // [h | s | z]
    static constexpr int N1 = K1, N2 = pad16(K1 / 2), N3 = pad16(K1 / 4);
    static constexpr int N4 = 8;                      // v (2), padded
    static constexpr int KL = 2 * HP, NL = 4 * HP;    // [e | h] -> i f g o
    // fragments (k-tiles x n-tiles) of L1, L2, L3, L4, the embedding, LSTM
    static constexpr int F1 = K1 / 16 * (N1 / 8), F2 = N1 / 16 * (N2 / 8),
                         F3 = N2 / 16 * (N3 / 8), F4 = N3 / 16,
                         FE = HP / 8, FL = KL / 16 * (NL / 8);
    static constexpr int kFrags = F1 + F2 + F3 + F4 + FE + FL;
    static constexpr int kBias = N1 + N2 + N3 + N4 + HP + NL;
    static constexpr int kSmem = kFrags * 32 * 8 + kBias * 4;
};

// Everything a launch reads and writes; rows are int64, and hid, soc, nz
// are the model's widths (H, S, Z).
struct Args {
    const bf16 *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;   // decoder layers
    const bf16 *we, *be, *wl, *bl;                       // embed, encoder LSTM
    const bf16 *h, *c, *s, *last_p, *noise;              // [N, .], last_p strided
    bf16* out;                                           // [R N, n_next, 4]
    long long n, rows, lp_stride;
    int n_next, hid, soc, nz;
};

__device__ __forceinline__ unsigned leaky_bf16x2(const unsigned v) {
    // max(x, bf16(x * 0.2002)): x for x > 0, the rounded product otherwise
    // (the product of two bf16 values is exact in float, so this is
    // torch's float product rounded once)
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
    const __nv_bfloat162 slope = __float2bfloat162_rn(0.2f);
    const __nv_bfloat162 y = __hmax2(x, __hmul2(x, slope));
    return *reinterpret_cast<const unsigned*>(&y);
}

// out = bf16(x W + b), lrelu'd when kLeaky, as OT A k-tiles, from x's KT
// A k-tiles.
template <int KT, int OT, bool kLeaky>
__device__ __forceinline__ void dense(unsigned (&out)[OT][4],
                                      const unsigned (&x)[KT][4],
                                      const uint2* frag, const float* bias,
                                      const int lane) {
    const int t = lane & 3;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
        float acc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) bias_init(acc[j], bias, 16 * ot + 8 * j + 2 * t);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const uint2 b = frag[((2 * ot + j) * KT + kt) * 32 + lane];
                mma_bf16(acc[j], x[kt], b.x, b.y);
            }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            unsigned r0 = cvt_bf16x2(acc[j][0], acc[j][1]);
            unsigned r1 = cvt_bf16x2(acc[j][2], acc[j][3]);
            if (kLeaky) {
                r0 = leaky_bf16x2(r0);
                r1 = leaky_bf16x2(r1);
            }
            out[ot][2 * j] = r0;
            out[ot][2 * j + 1] = r1;
        }
    }
}

// Columns 16 kt + 2t (+ 1) and 16 kt + 8 + 2t (+ 1), kt < KT, of rows ra
// and rb of a row-major [.][width] bf16 array, as the A fragments a[off +
// kt]; zeros past the width and for a missing row.  Element by element,
// so any width and row alignment will do (once a tile, not a step); two
// columns a load when ``kPairs`` (width 16 KT, 4-byte aligned rows).
template <int KT, bool kPairs, int N>
__device__ __forceinline__ void load_frags(unsigned (&a)[N][4], const int off,
                                           const bf16* base, const int width,
                                           const long long ra, const bool va,
                                           const long long rb, const bool vb,
                                           const int t) {
    const unsigned short* pa =
        reinterpret_cast<const unsigned short*>(base + ra * width);
    const unsigned short* pb =
        reinterpret_cast<const unsigned short*>(base + rb * width);
    auto pair = [&](const unsigned short* row, const bool valid,
                    const int col) -> unsigned {
        if (kPairs)
            return valid ? __ldg(reinterpret_cast<const unsigned*>(row + col))
                         : 0u;
        const unsigned lo = valid && col < width ? __ldg(row + col) : 0u;
        const unsigned hi = valid && col + 1 < width ? __ldg(row + col + 1)
                                                     : 0u;
        return lo | hi << 16;
    };
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int col = 16 * kt + 8 * half + 2 * t;
            a[off + kt][2 * half] = pair(pa, va, col);
            a[off + kt][2 * half + 1] = pair(pb, vb, col);
        }
    }
}

// kExact: the widths are the padded ones (H = S = 16 T, Z = 16 ZT), known
// at compile time, and the operands' rows 4-byte aligned.
template <int T, int ZT, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
decode_rollout_kernel(const Args p) {
    using Dm = Dims<T, ZT>;
    const int H = kExact ? Dm::HP : p.hid, S = kExact ? Dm::SP : p.soc,
              Z = kExact ? Dm::ZP : p.nz, D1 = H + S + Z, D2 = D1 / 2,
              D3 = D1 / 4;
    constexpr int HP = Dm::HP, HT = T, ST = T, K1T = Dm::K1 / 16;
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* f1 = reinterpret_cast<uint2*>(smem);
    uint2* f2 = f1 + Dm::F1 * 32;
    uint2* f3 = f2 + Dm::F2 * 32;
    uint2* f4 = f3 + Dm::F3 * 32;
    uint2* fe = f4 + Dm::F4 * 32;
    uint2* fl = fe + Dm::FE * 32;
    float* b1 = reinterpret_cast<float*>(fl + Dm::FL * 32);
    float* b2 = b1 + Dm::N1;
    float* b3 = b2 + Dm::N2;
    float* b4 = b3 + Dm::N3;
    float* be = b4 + Dm::N4;
    float* bl = be + HP;

    auto below = [](const int real) {
        return [real](const int i) { return i < real ? i : -1; };
    };
    // layer 1's rows: h, s and z each padded
    auto x_row = [=](const int k) {
        if (k < HP) return k < H ? k : -1;
        if (k < HP + Dm::SP) return k - HP < S ? H + k - HP : -1;
        const int q = k - HP - Dm::SP;
        return q < Z ? H + S + q : -1;
    };
    // the LSTM's rows [e | h] and gate columns, each block of H padded
    auto l_row = [=](const int k) {
        const int q = k % HP;
        return q < H ? (k / HP) * H + q : -1;
    };
    stage_frags<kThreads, K1T, Dm::N1 / 8>(f1, p.w1, D1, x_row, below(D1));
    stage_frags<kThreads, Dm::N1 / 16, Dm::N2 / 8>(f2, p.w2, D2, below(D1),
                                                   below(D2));
    stage_frags<kThreads, Dm::N2 / 16, Dm::N3 / 8>(f3, p.w3, D3, below(D2),
                                                   below(D3));
    stage_frags<kThreads, Dm::N3 / 16, 1>(f4, p.w4, 2, below(D3), below(2));
    stage_frags<kThreads, 1, HP / 8>(fe, p.we, H, below(4), below(H));
    stage_frags<kThreads, Dm::KL / 16, Dm::NL / 8>(fl, p.wl, 4 * H, l_row,
                                                   l_row);
    stage_bias<kThreads, Dm::N1>(b1, p.b1, below(D1));
    stage_bias<kThreads, Dm::N2>(b2, p.b2, below(D2));
    stage_bias<kThreads, Dm::N3>(b3, p.b3, below(D3));
    stage_bias<kThreads, Dm::N4>(b4, p.b4, below(2));
    stage_bias<kThreads, HP>(be, p.be, below(H));
    stage_bias<kThreads, Dm::NL>(bl, p.bl, l_row);
    __syncthreads();

    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long stride = (long long)gridDim.x * kWarps;
    for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
         tile < tiles; tile += stride) {
        const long long ra = tile * kRows + g, rb = ra + 8;
        const bool va = ra < p.rows, vb = rb < p.rows;
        const long long ia = va ? ra % p.n : 0, ib = vb ? rb % p.n : 0;

        // x = [h | s | z] as layer 1's A k-tiles: h is k-tiles [0, HT),
        // rewritten each step
        unsigned x[K1T][4];
        load_frags<HT, kExact>(x, 0, p.h, H, ia, va, ib, vb, t);
        load_frags<ST, kExact>(x, HT, p.s, S, ia, va, ib, vb, t);
        load_frags<ZT, kExact>(x, HT + ST, p.noise, Z, ra, va, rb, vb, t);
        unsigned cw[HT][4];            // c, bf16, in the same layout
        load_frags<HT, kExact>(cw, 0, p.c, H, ia, va, ib, vb, t);
        unsigned lp_a = va ? __ldg(reinterpret_cast<const unsigned*>(
                                 p.last_p + ia * p.lp_stride)) : 0u;
        unsigned lp_b = vb ? __ldg(reinterpret_cast<const unsigned*>(
                                 p.last_p + ib * p.lp_stride)) : 0u;

        for (int step = 0; step < p.n_next; ++step) {
            unsigned a1[Dm::N1 / 16][4], a2[Dm::N2 / 16][4],
                a3[Dm::N3 / 16][4];
            dense<K1T, Dm::N1 / 16, true>(a1, x, f1, b1, lane);
            dense<Dm::N1 / 16, Dm::N2 / 16, true>(a2, a1, f2, b2, lane);
            dense<Dm::N2 / 16, Dm::N3 / 16, false>(a3, a2, f3, b3, lane);
            // v = bf16(a3 W4 + b4): lane (g, 0) holds rows g and g + 8
            float v[4];
            bias_init(v, b4, 2 * t);
#pragma unroll
            for (int kt = 0; kt < Dm::N3 / 16; ++kt) {
                const uint2 b = f4[kt * 32 + lane];
                mma_bf16(v, a3[kt], b.x, b.y);
            }
            const unsigned nv_a = __shfl_sync(kFull, cvt_bf16x2(v[0], v[1]),
                                              lane & ~3);
            const unsigned nv_b = __shfl_sync(kFull, cvt_bf16x2(v[2], v[3]),
                                              lane & ~3);
            const unsigned np_a = cvt_bf16x2(lo_bf16(nv_a) + lo_bf16(lp_a),
                                             hi_bf16(nv_a) + hi_bf16(lp_a));
            const unsigned np_b = cvt_bf16x2(lo_bf16(nv_b) + lo_bf16(lp_b),
                                             hi_bf16(nv_b) + hi_bf16(lp_b));
            lp_a = np_a;
            lp_b = np_b;
            if (t == 0 && va)
                *reinterpret_cast<uint2*>(p.out + (ra * p.n_next + step) * 4) =
                    make_uint2(np_a, nv_a);
            if (t == 1 && vb)
                *reinterpret_cast<uint2*>(p.out + (rb * p.n_next + step) * 4) =
                    make_uint2(np_b, nv_b);

            // e = bf16([p | v] We + be): [p | v] is columns 0-3 of one k-tile
            const unsigned pv[1][4] = {{t == 0 ? np_a : t == 1 ? nv_a : 0u,
                                        t == 0 ? np_b : t == 1 ? nv_b : 0u,
                                        0u, 0u}};
            unsigned e[HT][4];
            dense<1, HT, false>(e, pv, fe, be, lane);

            // the encoder LSTM on [e | h]: h is x's first HT k-tiles
            lstm_step<HT, 2>(e, x, cw, fl, bl, lane);
        }
    }
}

// The padded shapes compiled, (T, ZT) smallest first: the repo's widths
// (hidden h, social h, noise h / 2: h = 16, 32, 48, 64) each on its own,
// and noise up to 64 at hidden and social up to 64.  Mirrored by
// kernels/decode_rollout.py ``SHAPES``.  The crowd widths (64, 64, 32)
// launch the exact (4, 2) instantiation.
constexpr int kShapes[][2] = {{1, 1}, {2, 1}, {3, 2}, {4, 2}, {4, 4}};

template <int T, int ZT, bool kExact = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    using Dm = Dims<T, ZT>;
    static_assert(Dm::kSmem <= 227 * 1024, "weights past an SM's memory");
    return persistent_launch<kWarps>(decode_rollout_kernel<T, ZT, kExact>,
                                     Dm::kSmem, (a.rows + kRows - 1) / kRows,
                                     a, stream);
}

}  // namespace decode

// The decode of rows = R n rows (R = rows / n) for n_next steps into out
// [rows, n_next, 4].  Weights as the port keeps them (w [in, out], b [out],
// bf16, contiguous): w1 b1 .. w4 b4 the FC decoder of a d = hidden +
// social + noise_len input (d, d / 2, d / 4, 2 outputs), we be the
// embedding 4 -> hidden, wl bl the encoder LSTM [2 hidden, 4 hidden]; h, c
// [n, hidden], s [n, social] contiguous, last_p [n, 2] with row stride
// lp_stride, noise [rows, noise_len] contiguous.  Returns a CUDA error
// code; cudaErrorInvalidValue for widths no instantiation holds or a shape
// it cannot take.
extern "C" int decode_rollout_bf16(
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const void* w4, const void* b4,
    const void* we, const void* be, const void* wl, const void* bl,
    const void* h, const void* c, const void* s, const void* last_p,
    const void* noise, void* out, long long n, long long rows,
    long long lp_stride, int n_next, int hidden, int social, int noise_len,
    void* stream) {
    using namespace decode;
    if (hidden < 1 || social < 1 || noise_len < 1 || n <= 0 || rows % n
        || n_next < 0 || lp_stride < 2)
        return (int)cudaErrorInvalidValue;
    constexpr int kCount = sizeof(kShapes) / sizeof(kShapes[0]);
    const int t = ((hidden > social ? hidden : social) + 15) / 16,
              zt = (noise_len + 15) / 16;
    int shape = 0;
    while (shape < kCount
           && (kShapes[shape][0] < t || kShapes[shape][1] < zt))
        ++shape;
    if (shape == kCount) return (int)cudaErrorInvalidValue;
    if (rows == 0 || n_next == 0) return (int)cudaSuccess;
    const Args a{static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                 static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                 static_cast<const bf16*>(w3), static_cast<const bf16*>(b3),
                 static_cast<const bf16*>(w4), static_cast<const bf16*>(b4),
                 static_cast<const bf16*>(we), static_cast<const bf16*>(be),
                 static_cast<const bf16*>(wl), static_cast<const bf16*>(bl),
                 static_cast<const bf16*>(h), static_cast<const bf16*>(c),
                 static_cast<const bf16*>(s), static_cast<const bf16*>(last_p),
                 static_cast<const bf16*>(noise), static_cast<bf16*>(out),
                 n, rows, lp_stride, n_next, hidden, social, noise_len};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool aligned =
        ((reinterpret_cast<unsigned long long>(h)
          | reinterpret_cast<unsigned long long>(c)
          | reinterpret_cast<unsigned long long>(s)
          | reinterpret_cast<unsigned long long>(noise)) & 3) == 0;
    if (hidden == 64 && social == 64 && noise_len == 32 && aligned)
        return (int)launch<4, 2, true>(a, st);
    switch (shape) {
        case 0: return (int)launch<1, 1>(a, st);
        case 1: return (int)launch<2, 1>(a, st);
        case 2: return (int)launch<3, 2>(a, st);
        case 3: return (int)launch<4, 2>(a, st);
        default: return (int)launch<4, 4>(a, st);
    }
}
