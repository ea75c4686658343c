// list_traverse: the paper's server-side linked-list walk (section 5.6),
// one launch per request.
//
// Replaces: the jitted jax.lax.while_loop of src/repro/core/offload_engine.py
// ::install_list_traversal (lines 282-307), which XLA runs as one device
// program per request (the handler counts it as one DMA launch). The
// region holds n records of [key, next, value...] as float32; the walk
// starts at `head` and follows `next` while the record's key differs from
// the target key, the pointer is not negative and fewer than max_hops hops
// were taken. It answers with the value words of the record it rests on.
//
// Index semantics (held against the reference on the CPU):
//   * a key is compared as float32 (a NaN key never matches);
//   * `next` is the float32 word truncated toward zero, as astype(int32);
//   * a negative pointer ends the walk, and the answer is the record at
//     pointer + n (the reference's arr[-1] is the last record);
//   * a miss stops after max_hops hops;
//   * a `next` that truncates to a value outside [-n, n), or is NaN or
//     infinite, is an error: the walk stops there and reports status 1,
//     and the wrapper raises IndexError (the reference clamps such an
//     index into the region). The wrapper checks `head` against [-n, n)
//     before the launch.
//
// Bound on the card: the walk is a chain of dependent loads, so its time
// is hops x the device-memory latency (~0.5-1 us a hop on a record that
// is not in L2), not bytes or operations. The bytes it must move are
// 8 per visited record (key and next), the answer's value words and 24
// bytes of result: well under a microsecond at 3.35 TB/s, which is the
// bound chip_smoke.py reports. No design can beat the latency chain of a
// pointer chase; what the kernel removes is the host round trip per hop
// that an eager loop would pay.
//
// Design: one block. Thread 0 walks (each hop reads the record's key and,
// if it walks on, its next word); the block's threads then copy the
// answer's value words in parallel. meta[0..2] = {final record index
// (wrapped), hops, status}. Records are addressed in 64 bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void list_traverse_kernel(float* __restrict__ out,
                                     int64_t* __restrict__ meta,
                                     const float* __restrict__ recs,
                                     int64_t n, int64_t rec,
                                     int64_t value_size, float key,
                                     int64_t head, int64_t max_hops) {
  __shared__ int64_t s_ptr;
  if (threadIdx.x == 0) {
    int64_t ptr = head, hops = 0, status = 0;
    while (ptr >= 0 && hops < max_hops) {
      const float* r = recs + ptr * rec;
      if (r[0] == key) break;
      const double nxt = trunc((double)r[1]);
      if (!(nxt >= -(double)n && nxt < (double)n)) {  // NaN fails too
        status = 1;
        break;
      }
      ptr = (int64_t)nxt;
      ++hops;
    }
    if (ptr < 0) ptr += n;
    s_ptr = ptr;
    meta[0] = ptr;
    meta[1] = hops;
    meta[2] = status;
  }
  __syncthreads();
  const float* v = recs + s_ptr * rec + 2;
  for (int64_t j = threadIdx.x; j < value_size; j += blockDim.x) out[j] = v[j];
}

extern "C" int list_traverse(float* out, int64_t* meta, const float* recs,
                             int64_t n, int64_t rec, int64_t value_size,
                             float key, int64_t head, int64_t max_hops,
                             void* stream) {
  const int threads =
      value_size >= 256 ? 256 : (int)((value_size + 31) / 32 * 32);
  list_traverse_kernel<<<1, threads > 0 ? threads : 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      out, meta, recs, n, rec, value_size, key, head, max_hops);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
