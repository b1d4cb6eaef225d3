// Social GAN's pooling module, bf16 operands on the tensor cores (sm_90a).
// The kernel and its design are in social_pool.cuh; social_pool.cu has the
// float entry.

#include "social_pool.cuh"

extern "C" int social_pool_bf16(SP_ARGS) {
    return (int)sp::launch<__nv_bfloat16>(SP_PASS);
}
