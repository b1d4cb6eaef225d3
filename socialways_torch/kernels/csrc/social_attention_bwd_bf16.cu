// The social-attention backward (dq and dkv) C entries for bf16 operands.
// The kernels, templates on the operand type, and their design are in
// social_attention_bwd.cuh; social_attention_bwd.cu has the float entries.
// Each operand type is a translation unit of its own: compiled beside
// the bf16 instantiation, the float forward kernel took 56 registers
// instead of its own 50.

#define SA_BF16_ENTRIES     // the tensor-core kernels of the bf16 operands
#include "social_attention_bwd.cuh"

extern "C" int social_attention_bwd_dq_bf16(SA_DQ_ARGS) {
    return launch_dq<__nv_bfloat16, false>(SA_DQ_PASS);
}
extern "C" int social_attention_bwd_dkv_bf16(SA_DKV_ARGS) {
    return launch_dkv<__nv_bfloat16, false>(SA_DKV_PASS);
}
