// Two probes of the card's latency floor, kept outside the package and
// timed by chip_smoke.py phase 2 beside the kernels they bound (and a
// plain cudaMemcpyAsync for tools/desc_ring/probe.py):
//  * empty_kernel: one CTA of one warp that does nothing, the least a
//    cold launch costs;
//  * chase_next: one thread following the `next` word (column 1) of
//    float32 records from `head` for `hops` hops, loading nothing else:
//    the least a dependent pointer chase over those records can take,
//    one device-memory round trip a hop. list_traverse does this walk
//    and also reads each record's key and copies the answer.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void empty_kernel() {}

__global__ void chase_kernel(const float* __restrict__ recs, int64_t rec,
                             int64_t head, int64_t hops,
                             int64_t* __restrict__ out) {
  int64_t ptr = head, h = 0;
  for (; h < hops && ptr >= 0; ++h) ptr = (int64_t)recs[ptr * rec + 1];
  out[0] = ptr;
  out[1] = h;
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int chase_next(const float* recs, int64_t rec, int64_t head,
                          int64_t hops, int64_t* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      recs, rec, head, hops, out);
  return (int)cudaGetLastError();
}

// One cudaMemcpyAsync (UVA tells the direction): the copies that
// tools/desc_ring/probe.py times against the ring's mapped buffers.
extern "C" int dma_copy(void* dst, const void* src, int64_t bytes,
                        void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyDefault,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
