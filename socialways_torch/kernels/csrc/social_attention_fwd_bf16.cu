// The social-attention forward C entry for bf16 operands.
// The kernels, templates on the operand type, and their design are in
// social_attention_fwd.cuh; social_attention_fwd.cu has the float entry.
// Each operand type is a translation unit of its own: compiled beside
// the bf16 instantiation, the float forward kernel took 56 registers
// instead of its own 50.

#include "social_attention_fwd.cuh"

// h, wh and the weights bf16; x4, out, stats, u, c float; the members as
// in social_attention_fwd.cu.
extern "C" int social_attention_fwd_bf16(SA_FWD_ARGS) {
    return launch_fwd<__nv_bfloat16, false>(SA_FWD_PASS);
}
