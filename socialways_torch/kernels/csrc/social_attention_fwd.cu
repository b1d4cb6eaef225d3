// The social-attention forward C entry for float operands.
// The kernels, templates on the operand type, and their design are in
// social_attention_fwd.cuh; social_attention_fwd_bf16.cu has the bf16 entry.
// Each operand type is a translation unit of its own: compiled beside
// the bf16 instantiation, the float forward kernel took 56 registers
// instead of its own 50.

#include "social_attention_fwd.cuh"

// x4 [N, 4], h [N, H], wh [N, F] and the weights float, `members` stacked
// models (social_attention_pairs.cuh, "Member axis"): `strides` [10] long
// long, the member strides of x4, ids, h, wh, w1, b1, w2, b2, w3, b3 (0:
// shared, else the dense size; null for a single model); out, stats, u and
// c are [members, N, ...].
extern "C" int social_attention_fwd(SA_FWD_ARGS) {
    return launch_fwd<float, false>(SA_FWD_PASS);
}
