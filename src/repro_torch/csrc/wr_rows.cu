// Record copies of the fused T4 flush, in one source:
//   scatter_rows: region[offs[r]] = vals[r], in place;
//   gather_rows:  out[r] = region[offs[r]], a record of the flattened region.
//
// Replaces: src/repro/kernels/wr_scatter/wr_scatter.py::wr_scatter (the
// Pallas scatter: one grid step per record, the offsets scalar-prefetched,
// the region aliased in place) and src/repro/kernels/wr_scatter/ops.py::
// _gather (a jitted jnp.take over an (n, L) element index that
// gather_records builds on the host as int32).
//
// Bound on the card: device-memory bytes. Each record is read once and
// written once (2 * m * row_bytes, plus 8 bytes of offset per record);
// there is no arithmetic. For 4096 records of 4 KiB that is 32 MiB, about
// 10 us at 3.35 TB/s.
//
// Design: both entry points are one row-copy kernel that differs only in
// which side the record offset addresses. One block per record, in a
// grid-stride loop over records. The block's threads copy the row in the
// widest word (16, 8, 4, 2 or 1 bytes) that the row's byte width and both
// base pointers allow, so a 4 KiB float32 record is 256 16-byte copies,
// one per thread, with neighbouring threads on neighbouring addresses. The
// row moves as raw bytes: the wrapper has already cast vals to the
// region's dtype. The gather takes record offsets and computes addresses
// itself, so no n x L index array is built, shipped or read (32 MiB of
// int32 indices for 16 MiB of data at 4096 x 1024, in the reference).
// Record offsets are int64 and all addressing is 64-bit, because a region
// may hold more than 2^31 elements. The wrapper checks every offset
// against the region before the launch. Scatter offsets are unique (the
// caller dedupes last-writer-wins), so no two blocks write one row.
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
  const int threads = words >= 256 ? 256 : (int)((words + 31) / 32 * 32);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
