// The social-attention forward C entry for float operands at H or F above
// 128 (any multiple of 16): the kWide instantiation of the kernels in
// social_attention_fwd.cuh, a translation unit of its own so that the
// narrow kernels of social_attention_fwd.cu compile as they did.

#include "social_attention_fwd.cuh"

// The operands as in social_attention_fwd.cu.
extern "C" int social_attention_fwd_wide(SA_FWD_ARGS) {
    return launch_fwd<float, true>(SA_FWD_PASS);
}
