// Row copies of the datapath, in one source:
//   scatter_rows: region[offs[r]] = vals[r], in place (the fused T4 flush);
//   gather_rows:  out[r] = region[offs[r]], a record of the flattened region
//                 (the fused T4 gather, and the T2 page gather);
//   ingest_pages: pages[ids[i]] = payload[i], in place (the T2 paged ingest);
//   ring_pipe_consume: out[i] = slots[src[i]] (the T3 descriptor->payload
//                 pipe: a drained batch gathers its payload slots).
//
// Replaces: src/repro/kernels/wr_scatter/wr_scatter.py::wr_scatter (line
// 27, the Pallas scatter: one grid step per record, the offsets
// scalar-prefetched, the region aliased in place) and
// src/repro/kernels/wr_scatter/ops.py::_gather (line 48, a jitted jnp.take
// over an (n, L) element index that gather_records builds on the host as
// int32; src/repro/core/rx_engine.py:33 gather_pages is the same take with
// a page as the row).
//
// ingest_pages replaces src/repro/kernels/kv_ingest/kv_ingest.py::kv_ingest
// (line 24): the Pallas page scatter whose grid walks the payload tiles in
// order, scalar-prefetching the page ids and aliasing the pages in place,
// so that no more than two tiles of an unbounded cache are ever resident
// in VMEM (T2's "there is always an invalidated cacheline"). Here each
// page is read once and written once, streamed through registers, with
// nothing staged: the working set of the kernel is one 16-byte word per
// thread, whatever the cache size. Bound: device-memory bytes,
// 2 * n * page_bytes / 3.35 TB/s (plus 8 bytes of id per page): 10 us for
// the main path's 2048 pages of 8 KiB (gemma-2b, 16 tokens x 1 kv head x
// 256 x bf16), which is one block of 512 threads per page, one 16-byte
// copy each. The grid runs pages in parallel, so a repeated id would race;
// the wrapper keeps only the last occurrence of each id (the Pallas
// grid's in-order last-wins) before the launch, and range-checks them.
//
// ring_pipe_consume replaces src/repro/kernels/ring_pipe/ring_pipe.py::
// ring_consume (line 23): a Pallas gather whose grid runs one step per
// drained descriptor, scalar-prefetching the descriptors' slot indices so
// that each step's BlockSpec DMAs one (1, W) payload slot into the output
// row. Here it is the gather entry's row copy under its own name, so that
// its launches are counted apart from the datapath's gathers: one block per
// descriptor, the slot row streamed through registers. Bound: bytes,
// 2 * n * W * itemsize (plus 8 bytes of index per row); 10 us for the main
// path's drained batch of 4096 slots of 4 KiB. Indices may repeat (it is a
// gather); the wrapper range-checks them before the launch, where the
// Pallas BlockSpec would clamp them.
//
// Bound on the card: device-memory bytes. Each record is read once and
// written once (2 * m * row_bytes, plus 8 bytes of offset per record);
// there is no arithmetic. For 4096 records of 4 KiB that is 32 MiB, about
// 10 us at 3.35 TB/s.
//
// Design: all four entry points are one row-copy kernel that differs
// only in which side the record offset addresses (ingest_pages is the
// scatter with a page as the row). One block per record, in a
// grid-stride loop over records. The block's threads copy the row in the
// widest word (16, 8, 4, 2 or 1 bytes) that the row's byte width and both
// base pointers allow, so a 4 KiB float32 record is 256 16-byte copies,
// one per thread (up to 512 threads a block), with neighbouring threads
// on neighbouring addresses. The row moves as raw bytes: the wrapper has
// already cast vals to the region's dtype. The gather takes record offsets and computes addresses
// itself, so no n x L index array is built, shipped or read (32 MiB of
// int32 indices for 16 MiB of data at 4096 x 1024, in the reference).
// Record offsets are int64 and all addressing is 64-bit, because a region
// may hold more than 2^31 elements. The wrapper checks every offset
// against the region before the launch. Scatter offsets are unique (the
// caller dedupes last-writer-wins), so no two blocks write one row.
//
// Why the rows do not go through TMA bulk copies: a persistent grid of
// one-warp CTAs, each keeping a ring of shared-memory stages full with
// cp.async.bulk loads and stores, was built and timed against this kernel
// in interleaved rounds, every call after a clean-L2 eviction
// (tools/row_ring/probe.py holds it and prints the comparison). At the
// main paths' 32 MiB it tied on the scatters and trailed on the gathers,
// where its load -> barrier -> store round trip lengthens the dependent
// offset -> row chain. A cold call of either design is a few us of launch
// and dependent latency plus rows streaming at the HBM rate, within ~1 us
// of a contiguous copy of the same bytes: one 16-byte word per thread
// already keeps ~32 KB in flight an SM, what Little's law asks for at
// 3.35 TB/s, so the ring has nothing left to win at these shapes.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename W, bool kScatter>
__global__ void copy_rows_kernel(char* __restrict__ dst,
                                 const char* __restrict__ src,
                                 const int64_t* __restrict__ offs, int64_t m,
                                 int64_t row_bytes) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  for (int64_t r = blockIdx.x; r < m; r += gridDim.x) {
    const int64_t o = offs[r];
    W* d = reinterpret_cast<W*>(dst + (kScatter ? o : r) * row_bytes);
    const W* s =
        reinterpret_cast<const W*>(src + (kScatter ? r : o) * row_bytes);
    for (int64_t w = threadIdx.x; w < words; w += blockDim.x) d[w] = s[w];
  }
}

template <typename W, bool kScatter>
static void launch(void* dst, const void* src, const int64_t* offs,
                   int64_t m, int64_t row_bytes, cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  const int threads = words >= 512 ? 512 : (int)((words + 31) / 32 * 32);
  const unsigned grid = (unsigned)(m < 65535 ? m : 65535);
  copy_rows_kernel<W, kScatter><<<grid, threads, 0, stream>>>(
      static_cast<char*>(dst), static_cast<const char*>(src), offs, m,
      row_bytes);
}

template <bool kScatter>
static int copy_rows(void* dst, const void* src, const void* offs, int64_t m,
                     int64_t row_bytes, void* stream) {
  if (m <= 0 || row_bytes <= 0) return 0;
  const int64_t* o = static_cast<const int64_t*>(offs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t mix = (uint64_t)(uintptr_t)dst | (uint64_t)(uintptr_t)src |
                       (uint64_t)row_bytes;
  if (mix % 16 == 0) launch<uint4, kScatter>(dst, src, o, m, row_bytes, s);
  else if (mix % 8 == 0) launch<uint2, kScatter>(dst, src, o, m, row_bytes, s);
  else if (mix % 4 == 0)
    launch<uint32_t, kScatter>(dst, src, o, m, row_bytes, s);
  else if (mix % 2 == 0)
    launch<uint16_t, kScatter>(dst, src, o, m, row_bytes, s);
  else launch<uint8_t, kScatter>(dst, src, o, m, row_bytes, s);
  return (int)cudaGetLastError();
}

extern "C" int scatter_rows(void* region, const void* vals, const void* offs,
                            int64_t m, int64_t row_bytes, void* stream) {
  return copy_rows<true>(region, vals, offs, m, row_bytes, stream);
}

extern "C" int gather_rows(void* out, const void* region, const void* offs,
                           int64_t n, int64_t row_bytes, void* stream) {
  return copy_rows<false>(out, region, offs, n, row_bytes, stream);
}

extern "C" int ingest_pages(void* pages, const void* payload,
                            const void* ids, int64_t n, int64_t page_bytes,
                            void* stream) {
  return copy_rows<true>(pages, payload, ids, n, page_bytes, stream);
}

extern "C" int ring_pipe_consume(void* out, const void* slots,
                                 const void* src, int64_t n,
                                 int64_t slot_bytes, void* stream) {
  return copy_rows<false>(out, slots, src, n, slot_bytes, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
