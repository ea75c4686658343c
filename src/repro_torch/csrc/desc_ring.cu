// Device-resident T3 descriptor ring: produce, consume and the fused
// produce_consume, one kernel with three entry points.
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
// slot and the lap parity. A descriptor is 64 bytes (8 int64 words, the
// only width a device ring takes); slots are int64 natively (the
// reference ships int32 pairs only because its device has 64-bit types
// off).
//
// Bound on the card: bytes, and in practice one launch. A fused call at
// depth 4096 moves ~1 MiB (the batch in, the slots written and read, the
// rows out): 0.3 us at 3.35 TB/s, under the ~5 us a cold launch costs.
//
// Design. The first version (tools/desc_ring/ring_v1.cu) lost time in
// two places, and this one answers each:
//  * One block of 1024 threads did all the work on one SM (16 passes of
//    16-byte chunks at depth 4096, ~60-70 GB/s). Here the grid is sized to
//    the work. The wrapper's plan (kernels/desc_ring/ops.py `plan`) takes
//    the window of slots the call touches (from the tail's slot when it
//    consumes, else from the head's) and gives each CTA a contiguous
//    range of it, at most 32 slots: one thread per 16-byte chunk, so a
//    warp moves 512 contiguous bytes, a call of a few descriptors is one
//    CTA of one warp, and depth 4096 is 128 CTAs on 128 SMs. A CTA writes
//    the produced rows that land in its range, __syncthreads(), then reads
//    the consumed positions that fall in its range: a slot is written and
//    read by the same CTA, so produce -> consume needs no grid-wide
//    barrier. k: each CTA writes the first invalid position it saw (or
//    `limit`) to its own header word, and the host takes the minimum while
//    it reads the rows. No second launch, no memset. Slot and lap come
//    from comparisons, not from 64-bit division.
//  * The host boundary (a pageable copy and an allocation for the batch,
//    a pageable synchronising copy of limit + 1 rows back) cost ten times
//    the kernel. Here a batch of up to kParamMax descriptors rides in the
//    launch's parameters, a __grid_constant__ struct, the smallest of
//    three sizes that holds it; a larger batch is read from the ring's
//    pinned staging buffer through its mapped pointer. The k words and
//    the rows are written straight into the ring's pinned read-back
//    buffer through its mapped pointer: one launch, then one stream
//    synchronisation. Both mapped paths measured faster than one
//    cudaMemcpyAsync through card memory (tools/desc_ring/probe.py); the
//    price is that the kernel's own time includes the PCIe crossing.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

constexpr int kChunks = 4;         // 16-byte chunks per 64-byte descriptor
constexpr int kParamMax = 510;     // descriptors the largest parameter
                                   // struct carries (32,764 B since 12.1)

struct Step {
  uint4* slots;
  uint8_t* flags;
  const uint4* batch;    // device-visible batch, or null (in the params)
  uint4* rows;           // consumed position i -> rows[4 i .. 4 i + 3]
  int64_t* kwords;       // one word per CTA: its first invalid position
  int64_t cap, n, head, tail, limit;   // head, tail reduced mod 2 * cap
  int64_t base;          // the window's first slot
  int64_t span;          // slots in the window (<= cap)
  int64_t per;           // window slots per CTA
};

template <int NB>
struct Params {
  Step s;
  uint4 b[NB > 0 ? NB * kChunks : 1];
};
static_assert(sizeof(Params<kParamMax>) <= 32764,
              "the largest batch must fit the launch parameters");

// x < 2 * cap -> x mod cap
__device__ __forceinline__ int64_t wrap(int64_t x, int64_t cap) {
  return x >= cap ? x - cap : x;
}

// (s - from) mod cap for s, from in [0, cap)
__device__ __forceinline__ int64_t ahead(int64_t s, int64_t from,
                                         int64_t cap) {
  const int64_t d = s - from;
  return d < 0 ? d + cap : d;
}

// The flag that marks position pos (< 3 * cap) valid on its lap.
__device__ __forceinline__ uint8_t lap_flag(int64_t pos, int64_t cap) {
  const int64_t lap = pos >= 2 * cap ? 2 : (pos >= cap ? 1 : 0);
  return (uint8_t)(1 - (lap & 1));
}

template <int NB>
__global__ void ring_step_kernel(const __grid_constant__ Params<NB> p,
                                 int produce, int consume) {
  const Step& a = p.s;
  const int64_t lo = (int64_t)blockIdx.x * a.per;
  const int64_t hi = lo + a.per < a.span ? lo + a.per : a.span;
  const int64_t head_slot = wrap(a.head, a.cap);
  const int64_t tail_slot = wrap(a.tail, a.cap);
  if (produce) {
    for (int64_t j = lo * kChunks + threadIdx.x; j < hi * kChunks;
         j += blockDim.x) {
      const int64_t s = wrap(a.base + (j >> 2), a.cap);
      const int q = (int)(j & 3);
      const int64_t r = ahead(s, head_slot, a.cap);
      if (r >= a.n) continue;
      uint4 v;
      if constexpr (NB > 0) {
        v = p.b[r * kChunks + q];
      } else {
        v = a.batch[r * kChunks + q];
      }
      a.slots[s * kChunks + q] = v;
      if (q == 0) a.flags[s] = lap_flag(a.head + r, a.cap);
    }
  }
  if (!consume) return;   // uniform across the grid
  __shared__ int first_bad;
  if (threadIdx.x == 0) first_bad = (int)a.limit;
  __syncthreads();        // this CTA's produced slots visible to its scan
  for (int64_t j = lo * kChunks + threadIdx.x; j < hi * kChunks;
       j += blockDim.x) {
    const int64_t s = wrap(a.base + (j >> 2), a.cap);
    const int q = (int)(j & 3);
    const int64_t i = ahead(s, tail_slot, a.cap);
    if (i >= a.limit) continue;
    if (q == 0 && a.flags[s] != lap_flag(a.tail + i, a.cap))
      atomicMin(&first_bad, (int)i);
    a.rows[i * kChunks + q] = a.slots[s * kChunks + q];
  }
  __syncthreads();
  if (threadIdx.x == 0) a.kwords[blockIdx.x] = first_bad;
}

template <int NB>
static int launch(const Step& s, const void* host_batch, int grid,
                  int threads, int produce, int consume, void* stream) {
  Params<NB> p;
  p.s = s;
  if constexpr (NB > 0) {
    if (s.n > NB) return (int)cudaErrorInvalidValue;
    if (s.n > 0) memcpy(p.b, host_batch, (size_t)s.n * kChunks * 16);
  }
  ring_step_kernel<NB><<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, produce,
                                                              consume);
  return (int)cudaGetLastError();
}

// tier: the parameter struct's size in descriptors (8, 64 or kParamMax),
// `batch` then a host pointer copied into it; or 0, `batch` then a
// device-visible pointer (or null when n == 0).
static int step(void* slots, void* flags, int64_t cap, int width,
                const void* batch, int64_t n, int64_t head, int64_t tail,
                int64_t limit, void* rows, void* kwords, int64_t base,
                int64_t span, int grid, int64_t per, int threads, int tier,
                int produce, int consume, void* stream) {
  if (width != 2 * kChunks || grid < 1 || threads < 32 || threads > 1024 ||
      span > cap || (int64_t)grid * per < span || n > cap || limit > cap)
    return (int)cudaErrorInvalidValue;
  Step s{static_cast<uint4*>(slots), static_cast<uint8_t*>(flags),
         tier == 0 ? static_cast<const uint4*>(batch) : nullptr,
         static_cast<uint4*>(rows), static_cast<int64_t*>(kwords),
         cap, n, head, tail, limit, base, span, per};
  switch (tier) {
    case 0: return launch<0>(s, nullptr, grid, threads, produce, consume,
                             stream);
    case 8: return launch<8>(s, batch, grid, threads, produce, consume,
                             stream);
    case 64: return launch<64>(s, batch, grid, threads, produce, consume,
                               stream);
    case kParamMax: return launch<kParamMax>(s, batch, grid, threads,
                                             produce, consume, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ring_produce(void* slots, void* flags, int64_t cap, int width,
                            const void* batch, int64_t n, int64_t head,
                            int64_t base, int64_t span, int grid,
                            int64_t per, int threads, int tier,
                            void* stream) {
  return step(slots, flags, cap, width, batch, n, head, 0, 0, nullptr,
              nullptr, base, span, grid, per, threads, tier, 1, 0, stream);
}

extern "C" int ring_consume(void* slots, void* flags, int64_t cap, int width,
                            int64_t tail, int64_t limit, void* rows,
                            void* kwords, int64_t base, int64_t span,
                            int grid, int64_t per, int threads,
                            void* stream) {
  return step(slots, flags, cap, width, nullptr, 0, 0, tail, limit, rows,
              kwords, base, span, grid, per, threads, 0, 0, 1, stream);
}

extern "C" int ring_produce_consume(void* slots, void* flags, int64_t cap,
                                    int width, const void* batch, int64_t n,
                                    int64_t head, int64_t tail,
                                    int64_t limit, void* rows, void* kwords,
                                    int64_t base, int64_t span, int grid,
                                    int64_t per, int threads, int tier,
                                    void* stream) {
  return step(slots, flags, cap, width, batch, n, head, tail, limit, rows,
              kwords, base, span, grid, per, threads, tier, 1, 1, stream);
}

// Pinned host memory mapped into the device's address space: the ring's
// read-back and staging buffers. *dev is the pointer a kernel uses.
extern "C" int ring_host_alloc(int64_t bytes, void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, (size_t)bytes,
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(dev, *host, 0);
  if (e != cudaSuccess) cudaFreeHost(*host);
  return (int)e;
}

extern "C" int ring_host_free(void* host) {
  return (int)cudaFreeHost(host);
}

// The event after a staged produce: the next write of the staging buffer
// waits on it (a produce does not synchronise).
extern "C" int ring_event_create(void** ev) {
  return (int)cudaEventCreateWithFlags(reinterpret_cast<cudaEvent_t*>(ev),
                                       cudaEventDisableTiming);
}

extern "C" int ring_event_record(void* ev, void* stream) {
  return (int)cudaEventRecord(static_cast<cudaEvent_t>(ev),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ring_event_sync(void* ev) {
  return (int)cudaEventSynchronize(static_cast<cudaEvent_t>(ev));
}

extern "C" int ring_event_destroy(void* ev) {
  return (int)cudaEventDestroy(static_cast<cudaEvent_t>(ev));
}

// The wrapper's one wait after a launch that consumes.
extern "C" int ring_sync(void* stream) {
  return (int)cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
