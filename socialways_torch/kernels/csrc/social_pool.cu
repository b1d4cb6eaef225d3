// Social GAN's pooling module, float operands with FFMA products (sm_90a).
// The kernel and its design are in social_pool.cuh; social_pool_bf16.cu
// has the bf16 entry.

#include "social_pool.cuh"

extern "C" int social_pool_f32(SP_ARGS) {
    return (int)sp::launch<float>(SP_PASS);
}
