// The social-attention forward C entry for bf16 operands at H or F above
// 128 (up to 512): the kWide instantiation of the kernels in
// social_attention_fwd.cuh, a translation unit of its own.

#include "social_attention_fwd.cuh"

// The operands as in social_attention_fwd_bf16.cu.
extern "C" int social_attention_fwd_wide_bf16(SA_FWD_ARGS) {
    return launch_fwd<__nv_bfloat16, true>(SA_FWD_PASS);
}
