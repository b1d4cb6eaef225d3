// The social-attention backward (dq and dkv) C entries for float operands.
// The kernels, templates on the operand type, and their design are in
// social_attention_bwd.cuh; social_attention_bwd_bf16.cu has the bf16 entries.
// Each operand type is a translation unit of its own: compiled beside
// the bf16 instantiation, the float forward kernel took 56 registers
// instead of its own 50.

#include "social_attention_bwd.cuh"

extern "C" int social_attention_bwd_dq(SA_DQ_ARGS) {
    return launch_dq<float, false>(SA_DQ_PASS);
}
extern "C" int social_attention_bwd_dkv(SA_DKV_ARGS) {
    return launch_dkv<float, false>(SA_DKV_PASS);
}
