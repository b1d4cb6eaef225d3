// The social-attention backward (dq and dkv) C entries for float operands
// at H or F above 128 (any multiple of 16): the kWide instantiation of the kernels
// in social_attention_bwd.cuh, a translation unit of its own so that the
// narrow kernels of social_attention_bwd.cu compile as they did.

#include "social_attention_bwd.cuh"

extern "C" int social_attention_bwd_dq_wide(SA_DQ_ARGS) {
    return launch_dq<float, true>(SA_DQ_PASS);
}
extern "C" int social_attention_bwd_dkv_wide(SA_DKV_ARGS) {
    return launch_dkv<float, true>(SA_DKV_PASS);
}
