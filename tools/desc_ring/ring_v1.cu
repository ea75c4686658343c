// The device CQ ring as the port first built it: ONE block of 1024
// threads, whatever the work. Kept outside the package so that
// chip_smoke.py (phase 2 and phase 7) and tools/desc_ring/probe.py time it
// against the package's design (src/repro_torch/csrc/desc_ring.cu) in the
// same rounds; its host boundary (a pageable copy of the batch, an
// allocation and a pageable read-back of limit + 1 rows) is `V1` in
// probe.py. Its entries keep the package's names: it is built into a
// library of its own.
//
// Replaces: src/repro/kernels/desc_ring/desc_ring.py::produce, consume and
// produce_consume (jnp, jitted with donated buffers in
// kernels/desc_ring/ops.py; the fused poll of CompletionQueue.
// enable_fused_poll rides produce_consume).
//
// Protocol (as in the reference): slot s is valid on lap L iff
// flags[s] == 1 - L % 2. produce writes batch row r at position head + r
// with that lap's flag; consume scans positions tail, tail+1, ... and
// reports k, the length of the valid prefix, capped at `limit`. The
// wrapper passes head and tail reduced mod 2*cap, which keeps both the
// slot and the lap parity.
//
// Bound on the card: launch latency. A poll moves at most cap * 64 bytes
// of descriptors (256 KiB at depth 4096), well under a microsecond of
// memory time, while a launch plus its read-back costs microseconds.
//
// Design: ONE block of 1024 threads, so the produce phase and the
// consume phase of produce_consume need no grid-wide barrier:
// __syncthreads() makes the freshly written slots and flags visible to
// the scan. A descriptor is 64 bytes (8 int64 words, the only width a
// device ring takes), moved as four 16-byte chunks, one chunk per thread,
// so a warp reads and writes 512 contiguous bytes; slot and lap come from
// comparisons instead of 64-bit division. The scan finds the first invalid
// position with a shared atomicMin; the same pass copies the first `limit`
// rotated rows. Row 0 of `out` holds k and rows 1..limit the descriptors,
// so the host reads k and the rows back in ONE copy. Slots are int64
// natively (the reference ships int32 pairs only because its device has
// 64-bit types off).
#include <cuda_runtime.h>
#include <stdint.h>

// Position pos (< 3 * cap: head and tail arrive reduced mod 2 * cap, and
// a batch or a scan spans at most cap) -> its slot and the flag that marks
// it valid on its lap. The lap comes from two comparisons, not a division.
__device__ __forceinline__ int64_t slot_of(int64_t pos, int64_t cap,
                                           uint8_t* flag) {
  const int64_t lap = pos >= 2 * cap ? 2 : (pos >= cap ? 1 : 0);
  *flag = (uint8_t)(1 - (lap & 1));
  return pos - lap * cap;
}

constexpr int kChunks = 4;  // 16-byte chunks per 64-byte descriptor

__global__ void ring_step_kernel(uint4* __restrict__ slots,
                                 uint8_t* __restrict__ flags, int64_t cap,
                                 const uint4* __restrict__ batch, int64_t n,
                                 int64_t head, int64_t tail, int64_t limit,
                                 uint4* __restrict__ out) {
  for (int64_t j = threadIdx.x; j < n * kChunks; j += blockDim.x) {
    const int64_t r = j / kChunks;
    const int q = (int)(j % kChunks);
    uint8_t flag;
    const int64_t s = slot_of(head + r, cap, &flag);
    slots[s * kChunks + q] = batch[j];
    if (q == 0) flags[s] = flag;
  }
  if (out == nullptr) return;  // produce only (uniform across the block)
  __shared__ int first_bad;
  if (threadIdx.x == 0) first_bad = (int)limit;
  __syncthreads();  // produced slots/flags visible; first_bad initialised
  for (int64_t j = threadIdx.x; j < limit * kChunks; j += blockDim.x) {
    const int64_t i = j / kChunks;
    const int q = (int)(j % kChunks);
    uint8_t flag;
    const int64_t s = slot_of(tail + i, cap, &flag);
    if (q == 0 && flags[s] != flag) atomicMin(&first_bad, (int)i);
    out[(1 + i) * kChunks + q] = slots[s * kChunks + q];
  }
  __syncthreads();
  if (threadIdx.x == 0) reinterpret_cast<int64_t*>(out)[0] = first_bad;
}

static int step(void* slots, void* flags, int64_t cap, int width,
                const void* batch, int64_t n, int64_t head, int64_t tail,
                int64_t limit, void* out, void* stream) {
  if (width != 2 * kChunks) return (int)cudaErrorInvalidValue;
  ring_step_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(slots), static_cast<uint8_t*>(flags), cap,
      static_cast<const uint4*>(batch), n, head, tail, limit,
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

extern "C" int ring_produce(void* slots, void* flags, int64_t cap, int width,
                            const void* batch, int64_t n, int64_t head,
                            void* stream) {
  return step(slots, flags, cap, width, batch, n, head, 0, 0, nullptr,
              stream);
}

extern "C" int ring_consume(void* slots, void* flags, int64_t cap, int width,
                            int64_t tail, int64_t limit, void* out,
                            void* stream) {
  return step(slots, flags, cap, width, nullptr, 0, 0, tail, limit, out,
              stream);
}

extern "C" int ring_produce_consume(void* slots, void* flags, int64_t cap,
                                    int width, const void* batch, int64_t n,
                                    int64_t head, int64_t tail, int64_t limit,
                                    void* out, void* stream) {
  return step(slots, flags, cap, width, batch, n, head, tail, limit, out,
              stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
