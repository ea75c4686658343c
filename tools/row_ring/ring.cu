// A TMA bulk-copy ring for the row copies of csrc/wr_rows.cu, kept as a
// measured alternative (tools/row_ring/probe.py times it against the
// word copy there); nothing in the package launches it.
//
// ring_rows: scatter (dst[offs[r]] = src[r]) or gather (dst[r] =
// src[offs[r]]) of m rows of row_bytes. A persistent grid of `grid`
// one-warp CTAs walks rows r = blockIdx.x + i * gridDim.x. Each CTA keeps
// a ring of `stages` shared-memory stages of `stage_bytes` (a row, or a
// chunk of a wider row), one mbarrier each. Lane 0 issues a TMA 1-D bulk
// load (cp.async.bulk ... mbarrier::complete_tx) of a tile into each
// stage, waits for the oldest stage's barrier, issues a bulk store of it
// (cp.async.bulk ... bulk_group), commits the group, and refills the
// stage of the tile before once cp.async.bulk.wait_group.read says that
// store has read it: stages - 1 loads stay in flight per CTA, with no
// register spent on the data. The warp fetches the CTA's offsets 32 rows
// at a time, a batch ahead of the rows in flight, and lane 0 takes each
// by a shuffle. The walk over tiles steps counters and never divides.
// Bulk copies need 16-byte aligned addresses and sizes: other operands
// and bad plans are refused with cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxStages = 16;
constexpr int64_t kMaxSmem = 200 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared, `bytes` counted on `bar` (which takes the arrival)
__device__ __forceinline__ void bulk_load(void* sdst, const void* gsrc,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(sdst)), "l"(gsrc), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, in a bulk group of its own
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(gdst), "r"(smem_u32(ssrc)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <bool kScatter>
__global__ void __launch_bounds__(32)
ring_rows_kernel(char* __restrict__ dst, const char* __restrict__ src,
                 const int64_t* __restrict__ offs, int64_t m,
                 int64_t row_bytes, int64_t stage_bytes, int chunks,
                 int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int lane = threadIdx.x;
  const int64_t G = gridDim.x, b = blockIdx.x;
  const int64_t rows = (m - b + G - 1) / G;     // this CTA's rows
  const int64_t tiles = rows * chunks;          // and their chunks
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // lane l holds the offset of local row 32 kb + l (cur) and of
  // 32 (kb + 1) + l (nxt); a row's offset is read a batch before its use
  auto fetch = [&](int64_t batch) -> int64_t {
    const int64_t i = batch * 32 + lane;
    return i < rows ? offs[b + i * G] : 0;
  };
  int64_t kb = 0, cur = fetch(0), nxt = fetch(1);
  // every lane, with the same i, whose batch is kb or kb + 1
  auto off = [&](int64_t i) -> int64_t {
    return __shfl_sync(0xffffffffu, (i >> 5) == kb ? cur : nxt,
                       (int)(i & 31));
  };
  // a walk over this CTA's tiles in order: local row i, its chunk c, the
  // stage s and that stage's phase
  struct Cursor {
    int64_t i = 0;
    int c = 0, s = 0;
    uint32_t phase = 0;
  };
  auto step = [&](Cursor& k) {
    if (++k.c == chunks) { k.c = 0; ++k.i; }
    if (++k.s == stages) { k.s = 0; k.phase ^= 1; }
  };
  // the tile at k, as (byte offset in its row, bytes), on lane 0
  auto piece = [&](const Cursor& k, int64_t* at) -> uint32_t {
    *at = k.c * stage_bytes;
    const int64_t left = row_bytes - *at;
    return (uint32_t)(left < stage_bytes ? left : stage_bytes);
  };
  auto load = [&](const Cursor& k, int64_t o) {   // lane 0
    int64_t at;
    const uint32_t bytes = piece(k, &at);
    const int64_t r = kScatter ? b + k.i * G : o;
    bulk_load(ring + k.s * stage_bytes, src + r * row_bytes + at, bytes,
              &full[k.s]);
  };

  Cursor ld, st;                                // next to load, to store
  int64_t loaded = 0;
  for (; loaded < tiles && loaded < stages; ++loaded, step(ld)) {
    const int64_t o = kScatter ? 0 : off(ld.i);
    if (lane == 0) load(ld, o);
  }
  // tile t's stage is refilled with tile t + stages one tile later, once
  // the store that read it has (wait_group.read 1: all but the store just
  // issued); a ring of one stage refills right after its store has read it
  const int64_t lag = stages > 1 ? 1 : 0;
  for (int64_t t = 0; t < tiles; ++t, step(st)) {
    if ((st.i >> 5) > kb) {                      // the next batch of rows
      ++kb;
      cur = nxt;
      nxt = fetch(kb + 1);
    }
    const bool refill = t >= lag && loaded < tiles;
    const int64_t o_st = kScatter ? off(st.i) : 0;
    const int64_t o_ld = !kScatter && refill ? off(ld.i) : 0;
    if (lane == 0) {
      mbar_wait(&full[st.s], st.phase);
      int64_t at;
      const uint32_t bytes = piece(st, &at);
      const int64_t r = kScatter ? o_st : b + st.i * G;
      bulk_store(dst + r * row_bytes + at, ring + st.s * stage_bytes, bytes);
      if (refill) {
        if (lag)
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        else
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load(ld, o_ld);
      }
    }
    if (refill) {
      ++loaded;
      step(ld);
    }
  }
  // the CTA may exit once its last store has read its stage: the grid
  // completes only when every write it issued has been performed
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

extern "C" int ring_rows(void* dst, const void* src, const void* offs,
                         int64_t m, int64_t row_bytes, int scatter,
                         int64_t grid, int64_t stages, int64_t stage_bytes,
                         void* stream) {
  if (m <= 0 || row_bytes <= 0) return 0;
  const int64_t chunks =
      stage_bytes > 0 ? (row_bytes + stage_bytes - 1) / stage_bytes : 0;
  const uint64_t mix = (uint64_t)(uintptr_t)dst | (uint64_t)(uintptr_t)src |
                       (uint64_t)row_bytes | (uint64_t)stage_bytes;
  const int64_t smem = stages * stage_bytes;
  if (mix % 16 || grid < 1 || grid > m || grid > 0x7fffffff ||
      stages < 1 || stages > kMaxStages || stage_bytes < 16 ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = scatter ? ring_rows_kernel<true> : ring_rows_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)grid, 32, (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(dst), static_cast<const char*>(src),
      static_cast<const int64_t*>(offs), m, row_bytes, stage_bytes,
      (int)chunks, (int)stages);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
