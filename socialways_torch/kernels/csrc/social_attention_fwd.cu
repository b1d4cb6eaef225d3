// The social-attention forward C entry for float operands.
// The kernels, templates on the operand type, and their design are in
// social_attention_fwd.cuh; social_attention_fwd_bf16.cu has the bf16 entry.
// Each operand type is a translation unit of its own: compiled beside
// the bf16 instantiation, the float forward kernel took 56 registers
// instead of its own 50.

#include "social_attention_fwd.cuh"

// float operands: x4 [N, 4], h [N, H], wh [N, F] and the weights float.
extern "C" int social_attention_fwd(const void* x4, const void* ids,
                                    const void* h, const void* wh,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2,
                                    const void* w3, const void* b3,
                                    void* out, void* stats, void* u, void* c,
                                    int n, int hdim, int feat, int blocks,
                                    int max_scene, void* stream) {
    return launch_fwd<float>(x4, ids, h, wh, w1, b1, w2, b2, w3, b3, out,
                             stats, u, c, n, hdim, feat, blocks, max_scene,
                             stream);
}

