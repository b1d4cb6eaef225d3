// The tracer's device stamp (socialways_torch/utils/profiling.py).
// One thread writes a boundary's code and the device's %globaltimer (ns)
// into a ring in device memory, at the slot it takes with an atomicAdd on
// a device cursor.  A stamp needs no host sync, and a stamp captured in a
// CUDA graph takes a new slot at every replay.  The host reads the cursor
// and the whole ring once, after a traced block; the cursor never wraps
// (64 bits), so the slots still held are the last TRACE_RING stamps.

#include <cuda_runtime.h>

#define TRACE_RING (1 << 16)

struct Stamp {
    long long code;
    unsigned long long ns;
};

__device__ unsigned long long trace_cursor = 0;
__device__ Stamp trace_ring[TRACE_RING];

__global__ void trace_stamp_kernel(long long code) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    unsigned long long slot = atomicAdd(&trace_cursor, 1ULL) % TRACE_RING;
    trace_ring[slot].code = code;
    trace_ring[slot].ns = ns;
}

extern "C" int trace_stamp(long long code, void* stream) {
    trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(code);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trace_ring_size(void) { return TRACE_RING; }

// Loads the kernel and the ring on the current device without a launch,
// so that a graph capture that follows finds them loaded.
extern "C" int trace_prepare(void) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, trace_stamp_kernel);
    void* ring = nullptr;
    if (err == cudaSuccess) err = cudaGetSymbolAddress(&ring, trace_ring);
    return static_cast<int>(err);
}

// The cursor, and the ring as [TRACE_RING][2] long long (code, ns), of the
// current device; synchronous.
extern "C" int trace_read(unsigned long long* cursor, void* ring) {
    cudaError_t err = cudaMemcpyFromSymbol(cursor, trace_cursor,
                                           sizeof(unsigned long long));
    if (err == cudaSuccess)
        err = cudaMemcpyFromSymbol(ring, trace_ring,
                                   sizeof(Stamp) * TRACE_RING);
    return static_cast<int>(err);
}
