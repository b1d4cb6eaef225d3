// The social-attention backward (dq and dkv) C entries for bf16 operands
// at H or F above 128 (up to 512): the kWide instantiation of the kernels
// in social_attention_bwd.cuh, a translation unit of its own.

#include "social_attention_bwd.cuh"

extern "C" int social_attention_bwd_dq_wide_bf16(SA_DQ_ARGS) {
    return launch_dq<__nv_bfloat16, true>(SA_DQ_PASS);
}
extern "C" int social_attention_bwd_dkv_wide_bf16(SA_DKV_ARGS) {
    return launch_dkv<__nv_bfloat16, true>(SA_DKV_PASS);
}
