// Flash attention, forward: online-softmax attention over fixed tiles.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention (line 84; the pl.pallas_call at line 110). It computes
// what the Pallas kernel computes: q (B, H, Sq, Dk) against k (B, KVH, Sk,
// Dk) and v (B, KVH, Sk, Dv), query head h reading kv head h / G (GQA
// without repeating K/V), scores scaled by sm_scale, optionally
// tanh-softcapped (cap * tanh(s / cap)), causal and sliding-window masks
// (kpos <= qpos, kpos > qpos - window), statistics (m, l) and the
// accumulator in float32, l clamped at 1e-30, NEG = -1e30, the output in
// q's dtype. Masked keys contribute an exact 0 to p, and a tile masked for
// a whole row leaves that row's (m, l, acc) unchanged, as in the Pallas
// body. The Pallas kernel widens q, k and v to float32 before its two
// dots; every path below keeps those dots in float32 arithmetic.
//
// Query offset. Every entry takes `q_offset`: query row r of a call sits
// at absolute position q_offset + r for the causal and window masks (keys
// sit at 0 .. Sk - 1), while output rows stay local. A context-parallel
// shard passes its rank's first row (the reference's
// models/attention.py::chunked_attention(q_offset=), lines 59-99, whose
// CP path is parallel/collectives.py:110); the Pallas kernel has no
// offset. Every key bound a row's position sets (the tile scan, the split
// plan, the edge tiles, the masks) reads q_offset + row, clamped by Sk.
//
// What differs from the TPU kernel, by design. On the TPU the third grid
// axis (nk) runs in order and carries (m, l, acc) in VMEM scratch from one
// step to the next. Blocks on Hopper run in no order, so a block owns a
// q-tile of one (batch, head) and walks k-tiles of 64 keys itself. Any
// length runs: the ragged tails of Sq and Sk are masked here (the Pallas
// version asserts divisibility). Tiles that a causal or window mask kills
// for every row are skipped structurally, with the reference's own
// predicates (flash_attention.py:66-75).
//
// Bound on the card: operations. Causal attention does about
// 4 * B * H * S^2 * D / 2 FLOPs: 68.7 GFLOP for gemma-2b's prefill at
// S = 4096 (B = 1, H = 8, D = 256), 0.069 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 36 MiB of q, k, v and output (q and o 16 MiB
// each, k and v 2 MiB each: 0.011 ms at 3.35 TB/s). P stays float32 (the
// reference's numerics): each p is split into three bf16 terms, hi + mid +
// lo, which sum to it exactly (8 + 8 + 8 significant bits and a sign
// each), and acc += P V is three products, hi V + mid V + lo V, each exact
// in float32 and summed in float32. A product of two bf16 numbers is exact
// in float32, so S = Q K^T is the float32 dot of the widened inputs. The
// kernels round nothing the reference keeps in float32: a bf16 result lies
// within half a bf16 ulp (plus float32 summation noise) of the plain
// version's float32 result. The price is four products where a bf16-P
// kernel (SDPA's) does two, so the least tensor-core time of this work at
// S = 4096 is 0.139 ms, twice the function's bound.
//
// Entry `flash_attention`, bfloat16 (the serving path; operands 16-byte
// aligned with unit column stride, head dims a multiple of 16): Hopper's
// own machinery, one block of three warpgroups per (q-tile of 128 rows,
// key range).
//   * A TMA-fed ring. A producer warpgroup (one thread, 40 registers)
//     loads the q-tile once and keeps a two-stage ring of K and V tiles
//     (64 keys x 64-column blocks, 128-byte swizzle) full with
//     cp.async.bulk.tensor from 4-D tensor maps (d, s, head, batch) built
//     on the host from the operands' strides, so the (B, S, H, D) views
//     models.attention hands over need no copy; mbarriers carry
//     completion (full) and release (empty). Loads overlap the math; past
//     any edge the map reads zeros.
//   * wgmma for both products. Two consumer warpgroups (232 registers
//     each, by setmaxnreg) own 64 query rows each. S = Q K^T is m64n64k16
//     with both operands in shared memory; P V takes P from registers
//     (the score accumulator's layout is wgmma's A layout, so P never
//     leaves them), three m64nNk16 per 16-key chunk (N = Dv rounded up to
//     64, 128 or 256), V through the transpose bit. At Dv = 256 the
//     accumulator is 128 float32 registers a thread.
//   * Masks only where they bite: the predicates run on tiles that the
//     diagonal, the window edge or the ragged Sk tail cross; a tile dead
//     for all 64 rows of a warpgroup costs it nothing.
//   * A split that fills the SMs. The host plans `chunk` (k-tiles) so
//     that the blocks cover the SMs; a q-tile whose live range meets
//     several segments [j chunk, (j + 1) chunk) of the key axis takes a
//     block per segment, each writing float32 (m, l, acc) partials to
//     scratch the caller allocates, and flash_merge_kernel combines them
//     with the reference's online-softmax rule: a second launch in the
//     same call. The segments are absolute and the plan is made for the
//     lengths' power-of-two class, so a row's arithmetic is the same
//     whether its prompt is padded to its bucket or not (a merge of one
//     live segment with empty ones is bit-equal to no split). Blocks
//     take q-tiles longest first.
//
// Entry `flash_attention_generic`, bfloat16 (shapes the TMA path cannot
// take: head dims off a multiple of 16, operands or strides off 16
// bytes): tensor cores through mma.sync m16n8k16. Four warps own 16 query
// rows each of a 64-row q-tile; Q, K and V are staged by all threads
// through registers (rows padded by 8 elements; 99 KiB at D = 256, two
// blocks an SM); P V's B fragments come through ldmatrix.trans.
//
// Entry `flash_attention`, float32 (tests and edge cases): CUDA cores, no
// TF32, so the reference's 2e-5 tolerance holds. 256 threads, a 16 x 16
// grid: thread (ty, tx) owns query rows ty + 16 i and keys tx + 16 j (i, j
// < 4) of the score tile, and the same four rows of the accumulator,
// columns 4 tx + 64 c, in registers. Q, K and V are staged as float32 (211
// KiB of shared memory at D = 256, one block an SM); P goes through shared
// memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per tile (generic and float32)
constexpr int kBK = 64;        // keys per tile
constexpr float kNeg = -1e30f;

struct Strides {               // element strides of (b, h, s, d)
  int64_t q[4], k[4], v[4], o[4];
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// bfloat16, generic: mma.sync
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// d += a b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), D 16 x 8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: the B fragments of two n-tiles
__device__ __forceinline__ void ldmatrix_trans(uint32_t (&r)[4],
                                               const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// x0, x1 = hi + mid + lo exactly, each term a pair of bf16 (x0 low)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows x padw of a (b, h) slice into shared memory, row r at s + r * ld;
// rows past `valid` and columns past `width` are zero. `vec`: the slice
// is 16-byte aligned with unit column stride and width % 8 == 0, so rows
// move as uint4.
__device__ __forceinline__ void stage_bf16(bf16* s, int ld, const bf16* g,
                                           int64_t srow, int64_t scol,
                                           int row0, int rows, int valid,
                                           int width, int padw, bool vec) {
  if (vec) {
    const int w8 = padw / 8;
    for (int i = threadIdx.x; i < rows * w8; i += kMmaThreads) {
      const int r = i / w8, c = (i - r * w8) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < valid && c < width)
        x = *reinterpret_cast<const uint4*>(g + (int64_t)(row0 + r) * srow +
                                            c);
      *reinterpret_cast<uint4*>(s + r * ld + c) = x;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * padw; i += kMmaThreads) {
    const int r = i / padw, d = i - r * padw;
    bf16 x = __float2bfloat16(0.f);
    if (row0 + r < valid && d < width)
      x = g[(int64_t)(row0 + r) * srow + (int64_t)d * scol];
    s[r * ld + d] = x;
  }
}

// NV: n-tiles of 8 output columns (Dv <= 8 * NV; NV even)
template <int NV>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      Strides st, int H, int G, int Sq, int Sk, int Dk,
                      int Dv, float sm_scale, float cap, int causal,
                      int window, int qoff, int vec) {
  extern __shared__ uint4 smem16[];
  const int dkw = round_up(Dk, 16);     // staged width of q and k
  const int dkp = dkw + 8;              // row strides (elements)
  constexpr int dvp = NV * 8 + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem16);
  bf16* Ks = Qs + kBQ * dkp;
  bf16* Vs = Ks + kBK * dkp;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest rows first
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[1];
  bf16* ob = o + b * st.o[0] + h * st.o[1];

  stage_bf16(Qs, dkp, qb, st.q[2], st.q[3], q0, kBQ, Sq, Dk, dkw, vec & 1);

  // this thread's rows of the tile: r, r + 8 (local rows row0, row1, at
  // absolute positions qpos0, qpos1); columns 8 n + 2 t + {0, 1}
  const int r = warp * 16 + g;
  const int row0 = q0 + r, row1 = row0 + 8;
  const int qpos0 = qoff + row0, qpos1 = qpos0 + 8;
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // l: this lane's part

  const int nk = (Sk + kBK - 1) / kBK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kBK;
    // structural skip (uniform across the block): tiles are dead for
    // every row of the q-tile past the diagonal, and before the window
    if (causal && k0 > qoff + q0 + kBQ - 1) break;
    if (window && k0 + kBK - 1 <= qoff + q0 - window) continue;
    __syncthreads();                 // the last tile's readers are done
    stage_bf16(Ks, dkp, kb, st.k[2], st.k[3], k0, kBK, Sk, Dk, dkw,
               vec & 2);
    stage_bf16(Vs, dvp, vb, st.v[2], st.v[3], k0, kBK, Sk, Dv, NV * 8,
               vec & 4);
    __syncthreads();

    // S = Q K^T: this warp's 16 x 64 scores, 8 n-tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kc = 0; kc < dkw / 16; ++kc) {
      const bf16* qa = Qs + r * dkp + kc * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * dkp), ld32(qa + 8),
                             ld32(qa + 8 * dkp + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kr = Ks + (8 * j + g) * dkp + kc * 16 + 2 * t;
        mma(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    // masks and the online softmax update; s becomes p in place
    uint32_t live0 = 0u, live1 = 0u;
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + e;
        bool ok0 = kpos < Sk, ok1 = ok0;
        if (causal) {
          ok0 = ok0 && qpos0 >= kpos;
          ok1 = ok1 && qpos1 >= kpos;
        }
        if (window) {
          ok0 = ok0 && kpos > qpos0 - window;
          ok1 = ok1 && kpos > qpos1 - window;
        }
        float x0 = s[j][e] * sm_scale, x1 = s[j][2 + e] * sm_scale;
        if (cap != 0.f) {
          x0 = cap * tanhf(x0 / cap);
          x1 = cap * tanhf(x1 / cap);
        }
        s[j][e] = ok0 ? x0 : kNeg;
        s[j][2 + e] = ok1 ? x1 : kNeg;
        live0 |= (uint32_t)ok0 << (2 * j + e);
        live1 |= (uint32_t)ok1 << (2 * j + e);
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bit = 2 * j + e;
        const float p0 = (live0 >> bit) & 1u ? expf(s[j][e] - mn0) : 0.f;
        const float p1 = (live1 >> bit) & 1u ? expf(s[j][2 + e] - mn1) : 0.f;
        s[j][e] = p0;
        s[j][2 + e] = p1;
        rs0 += p0;
        rs1 += p1;
      }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += P V, 16 keys at a time; P's float32 as three bf16 terms
    const bf16* vrow =
        Vs + ((lane / 8) % 2 * 8 + lane % 8) * dvp + (lane / 16) * 8;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t ph[4], pm[4], pl[4];
      split3(s[2 * kc][0], s[2 * kc][1], ph[0], pm[0], pl[0]);
      split3(s[2 * kc][2], s[2 * kc][3], ph[1], pm[1], pl[1]);
      split3(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pm[2], pl[2]);
      split3(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NV; n += 2) {
        uint32_t bv[4];
        ldmatrix_trans(bv, vrow + kc * 16 * dvp + n * 8);
        mma(acc[n], pl, bv[0], bv[1]);
        mma(acc[n], pm, bv[0], bv[1]);
        mma(acc[n], ph, bv[0], bv[1]);
        mma(acc[n + 1], pl, bv[2], bv[3]);
        mma(acc[n + 1], pm, bv[2], bv[3]);
        mma(acc[n + 1], ph, bv[2], bv[3]);
      }
    }
  }

  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * t + e;
      if (col >= Dv) continue;
      if (row0 < Sq)
        ob[(int64_t)row0 * st.o[2] + (int64_t)col * st.o[3]] =
            __float2bfloat16(acc[n][e] / den0);
      if (row1 < Sq)
        ob[(int64_t)row1 * st.o[2] + (int64_t)col * st.o[3]] =
            __float2bfloat16(acc[n][2 + e] / den1);
    }
}

template <int NV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Strides& st, int B, int H, int G, int Sq, int Sk,
                int Dk, int Dv, float sm_scale, float cap, int causal,
                int window, int qoff, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)(kBQ + kBK) *
                                          (round_up(Dk, 16) + 8) +
                                      (size_t)kBK * (NV * 8 + 8));
  auto kernel = flash_fwd_bf16_kernel<NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st, H, G, Sq, Sk,
      Dk, Dv, sm_scale, cap, causal, window, qoff, vec);
  return (int)cudaGetLastError();
}

// the uint4 staging of one operand: aligned, unit column stride, every
// row start a multiple of 8 elements, width % 8 == 0
bool vec_ok(const void* p, const int64_t* s, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[3] == 1 &&
         s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0 && width % 8 == 0;
}

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: a TMA-fed ring of K/V tiles, wgmma, split key ranges
// ---------------------------------------------------------------------------
constexpr int kRows = 128;            // query rows a block: 2 consumers x 64
constexpr int kStages = 2;            // K/V ring depth
constexpr int kSmemThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kColBlock = 64;         // bf16 columns of one 128-byte row
constexpr int kKvBlock = kBK * 128;   // bytes of a 64-row, 64-column block
constexpr int kQBlock = kRows * 128;  // bytes of a 128-row, 64-column block
constexpr float kLog2e = 1.4426950408889634f;

// The k-tiles [lo, hi) that hold a live key for some real row of the
// 128-row q-tile at q0 (the reference's predicates, flash_attention.py
// :66-75, over the tile's first and last rows at their absolute
// positions qoff + row, the key bound clamped by Sk); hi <= lo: none.
__host__ __device__ __forceinline__ void k_tiles(int q0, int Sq, int Sk,
                                                 int causal, int window,
                                                 int qoff, int& lo,
                                                 int& hi) {
  const int first = qoff + q0;
  const int last = qoff + (q0 + kRows < Sq ? q0 + kRows : Sq) - 1;
  hi = (Sk + kBK - 1) / kBK;
  if (causal && last / kBK + 1 < hi) hi = last / kBK + 1;
  lo = 0;
  if (window && first - window + 1 > 0) lo = (first - window + 1) / kBK;
}

// Blocks a q-tile with live k-tiles [lo, hi) takes: one for each
// segment [j chunk, (j + 1) chunk) of the key axis the range meets (one
// for an empty range). The segments are absolute, so a row's keys fall
// into the same segments, and the row gets the same arithmetic, whatever
// rows beyond it the launch holds (a prompt padded to its bucket or not).
__host__ __device__ __forceinline__ int n_splits(int lo, int hi,
                                                 int chunk) {
  return hi > lo ? (hi + chunk - 1) / chunk - lo / chunk : 1;
}

struct FlashParams {
  int H, G, BH, Sq, Sk, Dk, Dv;
  int nq;              // 128-row q-tiles
  int chunk;           // k-tiles of a key segment (the split's unit)
  int max_split;       // the most blocks one q-tile takes
  float sm_scale, cap;
  int causal, window;
  int qoff;            // absolute position of query row 0
  int64_t os[4];       // output element strides (b, h, s, d)
  float* part;         // split partials: acc [split][bh][row][Dv], then
                       // (m, l) [split][bh][row]; rows nq * kRows a plane
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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

// one box of a 4-D tensor map (d, s, head, batch) into shared memory;
// its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(s), "r"(h), "r"(b)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins d's registers at this point: no read of an accumulator moves
// above the wait that completes it, no write below the wgmma that
// reads it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B: A 64 x 16 and B 16 x 64, both bf16 in shared memory
// (K-major, 128-byte swizzle); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B: A 64 x 16 bf16 in registers, B 16 x 64 bf16 in shared
// memory (MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A 64 x 16 bf16 in registers, B 16 x 128 bf16 in shared
// memory (MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A 64 x 16 bf16 in registers, B 16 x 256 bf16 in shared
// memory (MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc += P V for one 16-key chunk: N = 64 * NV output columns, one wgmma
template <int NV>
__device__ __forceinline__ void pv_mma(float (&acc)[NV * 32],
                                       const uint32_t (&a)[4], uint64_t dv);
template <>
__device__ __forceinline__ void pv_mma<1>(float (&acc)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t dv) {
  wgmma_rs_n64(acc, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<2>(float (&acc)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t dv) {
  wgmma_rs_n128(acc, a, dv);
}
template <>
__device__ __forceinline__ void pv_mma<4>(float (&acc)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t dv) {
  wgmma_rs_n256(acc, a, dv);
}

// qpos: the row's absolute position (qoff + row)
__device__ __forceinline__ bool key_live(int qpos, int kpos,
                                         const FlashParams& p) {
  return kpos < p.Sk && (!p.causal || qpos >= kpos) &&
         (!p.window || kpos > qpos - p.window);
}

// NV: 64-column blocks of V and of the accumulator (Dv <= 64 NV)
template <int NV>
__global__ void __launch_bounds__(kSmemThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      bf16* __restrict__ o, const FlashParams p) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align every tile
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int dkc = (p.Dk + kColBlock - 1) / kColBlock;   // K column blocks
  const int dvc = (p.Dv + kColBlock - 1) / kColBlock;   // V blocks loaded
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + dkc * kQBlock;           // stage s: + s * dkc blocks
  uint8_t* Vs = Ks + kStages * dkc * kKvBlock;  // stage s: + s * NV blocks
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * NV * kKvBlock);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  // this block's work: q-tiles longest first, each split into a block
  // per key segment its live range meets
  int idx = blockIdx.x, qt = 0, bh = 0, split = 0, ns = 1, lo = 0, hi = 0;
  for (int r = p.nq - 1; r >= 0; --r) {
    k_tiles(r * kRows, p.Sq, p.Sk, p.causal, p.window, p.qoff, lo, hi);
    ns = n_splits(lo, hi, p.chunk);
    if (idx < p.BH * ns) {
      qt = r;
      bh = idx / ns;
      split = idx - bh * ns;
      break;
    }
    idx -= p.BH * ns;
  }
  const int seg = (lo / p.chunk + split) * p.chunk;
  const int t0 = ns == 1 ? lo : (seg > lo ? seg : lo);
  const int t1 = ns == 1 ? hi : (seg + p.chunk < hi ? seg + p.chunk : hi);
  const int nt = t1 > t0 ? t1 - t0 : 0;
  const int q0 = qt * kRows;
  const int b = bh / p.H, h = bh % p.H;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // V blocks past Dv that no load fills: zero, so P V reads zeros there
  for (int c = dvc; c < NV; ++c)
    for (int s = 0; s < kStages; ++s)
      for (int i = threadIdx.x; i < kKvBlock / 16; i += kSmemThreads)
        reinterpret_cast<uint4*>(Vs + (s * NV + c) * kKvBlock)[i] =
            make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, dkc * kQBlock);
      for (int c = 0; c < dkc; ++c)
        tma_load(Qs + c * kQBlock, &qmap, qbar, c * kColBlock, q0, h, b);
      const int kvh = h / p.G;
      for (int i = 0; i < nt; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], (dkc + dvc) * kKvBlock);
        const int k0 = (t0 + i) * kBK;
        for (int c = 0; c < dkc; ++c)
          tma_load(Ks + (s * dkc + c) * kKvBlock, &kmap, &full[s],
                   c * kColBlock, k0, kvh, b);
        for (int c = 0; c < dvc; ++c)
          tma_load(Vs + (s * NV + c) * kKvBlock, &vmap, &full[s],
                   c * kColBlock, k0, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;          // consumer 0 or 1
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
    const int rbeg = q0 + 64 * cw;                 // its first row
    const int rend = (rbeg + 64 < p.Sq ? rbeg + 64 : p.Sq) - 1;
    const int row0 = rbeg + 16 * warp + g, row1 = row0 + 8;
    // the same rows' absolute positions, which the masks read
    const int abeg = p.qoff + rbeg, aend = p.qoff + rend;
    const int apos0 = p.qoff + row0, apos1 = apos0 + 8;
    const int nks = (p.Dk + 15) / 16;              // k-steps of Q K^T
    const uint32_t qs = smem_u32(Qs) + cw * (kQBlock / 2);

    float acc[NV * 32];
#pragma unroll
    for (int i = 0; i < NV * 32; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // l: this lane's part

    mbar_wait(qbar, 0);
    for (int i = 0; i < nt; ++i) {
      const int s = i % kStages;
      const int k0 = (t0 + i) * kBK;
      mbar_wait(&full[s], (i / kStages) & 1);
      // a tile dead for all of this warpgroup's rows costs nothing
      const bool live = rend >= rbeg && !(p.causal && k0 > aend) &&
                        !(p.window && k0 + kBK - 1 <= abeg - p.window);
      if (live) {
        // S = Q K^T, 64 x 64, from shared memory
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        const uint32_t ks = smem_u32(Ks + s * dkc * kKvBlock);
        reg_fence(sc);
        wg_fence();
        for (int kk = 0; kk < nks; ++kk) {
          const uint32_t off = (kk % 4) * 32;    // within the 128-byte row
          wgmma_ss_n64(sc,
                       gmma_desc(qs + (kk / 4) * kQBlock + off, 1, 64),
                       gmma_desc(ks + (kk / 4) * kKvBlock + off, 1, 64),
                       kk > 0);
        }
        wg_commit();
        wg_wait0();
        reg_fence(sc);

        // masks only on tiles the diagonal, the window edge or the
        // ragged Sk tail cross; masked scores are -inf, so their p is 0
        const bool edge = (p.causal && k0 + kBK - 1 > abeg) ||
                          (p.window && k0 <= aend - p.window) ||
                          k0 + kBK > p.Sk;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x0 = sc[4 * j + e] * p.sm_scale;
            float x1 = sc[4 * j + 2 + e] * p.sm_scale;
            if (p.cap != 0.f) {
              x0 = p.cap * tanhf(x0 / p.cap);
              x1 = p.cap * tanhf(x1 / p.cap);
            }
            if (edge) {
              const int kpos = k0 + 8 * j + 2 * t + e;
              if (!key_live(apos0, kpos, p)) x0 = -INFINITY;
              if (!key_live(apos1, kpos, p)) x1 = -INFINITY;
            }
            sc[4 * j + e] = x0;
            sc[4 * j + 2 + e] = x1;
            mx0 = fmaxf(mx0, x0);
            mx1 = fmaxf(mx1, x1);
          }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float c0 = exp2f((m0 - mn0) * kLog2e);
        const float c1 = exp2f((m1 - mn1) * kLog2e);
        const float b0 = mn0 * kLog2e, b1 = mn1 * kLog2e;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = exp2f(fmaf(sc[4 * j + e], kLog2e, -b0));
            const float p1 = exp2f(fmaf(sc[4 * j + 2 + e], kLog2e, -b1));
            sc[4 * j + e] = p0;
            sc[4 * j + 2 + e] = p1;
            rs0 += p0;
            rs1 += p1;
          }
        l0 = l0 * c0 + rs0;
        l1 = l1 * c1 + rs1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int j = 0; j < NV * 8; ++j) {
          acc[4 * j] *= c0;
          acc[4 * j + 1] *= c0;
          acc[4 * j + 2] *= c1;
          acc[4 * j + 3] *= c1;
        }

        // acc += P V, 16 keys a chunk, P's float32 as three bf16 terms
        // from registers (the score layout is wgmma's A layout), V from
        // shared memory through the transpose bit
        // (P is split for all four chunks first: nothing the P V wgmmas
        // read is written while they are in flight)
        uint32_t ph[4][4], pm[4][4], pl[4][4];
#pragma unroll
        for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split3(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1], ph[kc][r],
                   pm[kc][r], pl[kc][r]);
        const uint32_t vs = smem_u32(Vs + s * NV * kKvBlock);
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < kBK / 16; ++kc) {
          const uint64_t dv = gmma_desc(vs + kc * 16 * 128, kKvBlock / 16,
                                        64);
          pv_mma<NV>(acc, pl[kc], dv);
          pv_mma<NV>(acc, pm[kc], dv);
          pv_mma<NV>(acc, ph[kc], dv);
        }
        wg_commit();
        wg_wait0();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    if (rend < rbeg) return;
    const float ls0 = quad_sum(l0), ls1 = quad_sum(l1);
    if (ns == 1) {
      bf16* ob = o + b * p.os[0] + h * p.os[1];
      const float den0 = fmaxf(ls0, 1e-30f), den1 = fmaxf(ls1, 1e-30f);
#pragma unroll
      for (int j = 0; j < NV * 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= p.Dv) continue;
        if (row0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row0 * p.os[2] + col) =
              __floats2bfloat162_rn(acc[4 * j] / den0, acc[4 * j + 1] / den0);
        if (row1 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row1 * p.os[2] + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] / den1,
                                    acc[4 * j + 3] / den1);
      }
      return;
    }
    // a split: the unnormalised (m, l, acc) for flash_merge_kernel
    const int64_t plane = (int64_t)p.BH * p.nq * kRows;
    const int64_t r0 = split * plane + (int64_t)bh * p.nq * kRows + row0;
    const int64_t r1 = r0 + 8;
    float* pa = p.part;
    float* pml = p.part + p.max_split * plane * p.Dv;
#pragma unroll
    for (int j = 0; j < NV * 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.Dv) continue;
      if (row0 < p.Sq)
        *reinterpret_cast<float2*>(pa + r0 * p.Dv + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row1 < p.Sq)
        *reinterpret_cast<float2*>(pa + r1 * p.Dv + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (t == 0) {
      if (row0 < p.Sq)
        *reinterpret_cast<float2*>(pml + 2 * r0) = make_float2(m0, ls0);
      if (row1 < p.Sq)
        *reinterpret_cast<float2*>(pml + 2 * r1) = make_float2(m1, ls1);
    }
  }
}

// The split q-tiles' partials into the output: the reference's online
// combination, m = max m_s, l = sum l_s e^(m_s - m), acc likewise. One
// warp a row, 8 rows a block, grid (nq * 16, B * H): every load of a row
// is independent of the others, so the loads of many rows overlap.
constexpr int kMergeRows = 8;

__global__ void __launch_bounds__(32 * kMergeRows)
flash_merge_kernel(bf16* __restrict__ o, const FlashParams p) {
  const int qt = blockIdx.x / (kRows / kMergeRows);
  const int bh = blockIdx.y;
  int lo, hi;
  k_tiles(qt * kRows, p.Sq, p.Sk, p.causal, p.window, p.qoff, lo, hi);
  const int ns = n_splits(lo, hi, p.chunk);
  const int r = qt * kRows + (blockIdx.x % (kRows / kMergeRows)) *
                kMergeRows + threadIdx.x / 32;
  if (ns == 1 || r >= p.Sq) return;    // ns == 1: written by its one block
  const int64_t plane = (int64_t)p.BH * p.nq * kRows;
  const int64_t row = (int64_t)bh * p.nq * kRows + r;
  const float* pa = p.part + row * p.Dv;
  const float* pml = p.part + p.max_split * plane * p.Dv + 2 * row;
  float m = -INFINITY, l = 0.f;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, pml[2 * s * plane]);
  for (int s = 0; s < ns; ++s)
    l += exp2f((pml[2 * s * plane] - m) * kLog2e) * pml[2 * s * plane + 1];
  const float den = fmaxf(l, 1e-30f);
  bf16* orow = o + (bh / p.H) * p.os[0] + (bh % p.H) * p.os[1] + r * p.os[2];
  for (int col = 2 * (threadIdx.x % 32); col < p.Dv; col += 64) {
    float a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = exp2f((pml[2 * s * plane] - m) * kLog2e);
      const float2 a =
          *reinterpret_cast<const float2*>(pa + s * plane * p.Dv + col);
      a0 += w * a.x;
      a1 += w * a.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
        __floats2bfloat162_rn(a0 / den, a1 / den);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 4-D map (d, s, head, batch) over a bf16 operand with element strides
// s[0..3] = (b, h, s, d), d unit: boxes of 64 columns x `rows`, 128-byte
// swizzle, zeros past every edge
int tensor_map(CUtensorMap* map, const void* ptr, const int64_t* s, int D,
               int S, int heads, int B, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kColBlock, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NV>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                const Strides& st, int B, int H, int KVH, int Sq, int Sk,
                int Dk, int Dv, float sm_scale, float cap, int causal,
                int window, int qoff, int chunk, float* part,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = tensor_map(&qm, q, st.q, Dk, Sq, H, B, kRows);
  if (err == 0) err = tensor_map(&km, k, st.k, Dk, Sk, KVH, B, kBK);
  if (err == 0) err = tensor_map(&vm, v, st.v, Dv, Sk, KVH, B, kBK);
  if (err != 0) return err;

  FlashParams p;
  p.H = H;
  p.G = H / KVH;
  p.BH = B * H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Dk = Dk;
  p.Dv = Dv;
  p.nq = (Sq + kRows - 1) / kRows;
  p.chunk = chunk;
  p.sm_scale = sm_scale;
  p.cap = cap;
  p.causal = causal;
  p.window = window;
  p.qoff = qoff;
  for (int i = 0; i < 4; ++i) p.os[i] = st.o[i];
  p.part = part;
  long long blocks = 0;
  p.max_split = 1;
  for (int r = 0; r < p.nq; ++r) {
    int lo, hi;
    k_tiles(r * kRows, Sq, Sk, causal, window, qoff, lo, hi);
    const int ns = n_splits(lo, hi, chunk);
    blocks += (long long)p.BH * ns;
    if (ns > p.max_split) p.max_split = ns;
  }
  if ((p.max_split > 1 && part == nullptr) || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;

  const int dkc = (Dk + kColBlock - 1) / kColBlock;
  const size_t smem = 1024 + (size_t)dkc * kQBlock +
                      (size_t)kStages * (dkc + NV) * kKvBlock +
                      (1 + 2 * kStages) * sizeof(uint64_t);
  auto kernel = flash_fwd_sm90_kernel<NV>;
  static size_t smem_set[64] = {};      // per device: the size allowed
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) smem_set[dev] = smem;
  }
  kernel<<<(unsigned)blocks, kSmemThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.max_split == 1) return (int)e;
  flash_merge_kernel<<<dim3((unsigned)(p.nq * (kRows / kMergeRows)),
                            (unsigned)p.BH),
                       32 * kMergeRows, 0, stream>>>(static_cast<bf16*>(o),
                                                     p);
  return (int)cudaGetLastError();
}

// what the TMA path takes: 16-byte-aligned operands with unit column
// stride, row, head and batch strides a multiple of 8 elements, head
// dims a multiple of 16; the output's columns unit-strided
bool sm90_ok(const void* p, const int64_t* s, int D) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[3] == 1 &&
         s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0 && D % 16 == 0;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kPP = kBK + 4;   // row stride of P in shared memory (floats)

// rows x width of a (b, h) slice into shared memory as float32, row r at
// s + r * ld; rows past `valid` and columns past `width` are zero.
__device__ __forceinline__ void stage(float* s, int ld, const float* g,
                                      int64_t srow, int64_t scol, int row0,
                                      int rows, int valid, int width) {
  for (int i = threadIdx.x; i < rows * ld; i += kThreads) {
    const int r = i / ld, d = i - r * ld;
    float x = 0.f;
    if (row0 + r < valid && d < width)
      x = g[(int64_t)(row0 + r) * srow + (int64_t)d * scol];
    s[i] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

template <int DC>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides st, int H, int G, int Sq, int Sk, int Dk,
                     int Dv, float sm_scale, float cap, int causal,
                     int window, int qoff) {
  extern __shared__ float4 smem4[];
  const int dkp = round_up(Dk, 4) + 4;  // padded: float4 rows, distinct banks
  const int dvp = round_up(Dv, 4);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * dkp;
  float* Vs = Ks + kBK * dkp;
  float* Ps = Vs + kBK * dvp;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + kvh * st.k[1];
  const float* vb = v + b * st.v[0] + kvh * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];

  stage(Qs, dkp, qb, st.q[2], st.q[3], q0, kBQ, Sq, Dk);

  float acc[4][4 * DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Sk + kBK - 1) / kBK;
  const int dk4 = round_up(Dk, 4) / 4;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kBK;
    if (causal && k0 > qoff + q0 + kBQ - 1) break;
    if (window && k0 + kBK - 1 <= qoff + q0 - window) continue;
    __syncthreads();                 // the last tile's readers are done
    stage(Ks, dkp, kb, st.k[2], st.k[3], k0, kBK, Sk, Dk);
    stage(Vs, dvp, vb, st.v[2], st.v[3], k0, kBK, Sk, Dv);
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d4 = 0; d4 < dk4; ++d4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * dkp +
                                                 4 * d4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * dkp +
                                                 4 * d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // masks, the online softmax update, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qoff + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool live = kpos < Sk;
        if (causal) live = live && qpos >= kpos;
        if (window) live = live && kpos > qpos - window;
        float x = s[i][j] * sm_scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        x = live ? x : kNeg;
        ok[j] = live;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                 // P complete

    // acc += P V
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kPP +
                                                 kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = 4 * tx + 64 * c;
          if (col < Dv) {
            const float4 vv = *reinterpret_cast<const float4*>(
                Vs + (kk + e) * dvp + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(pv[i], e);
              acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
              acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < Dv)
          ob[(int64_t)row * st.o[2] + (int64_t)col * st.o[3]] =
              acc[i][4 * c + e] / den;
      }
  }
}

template <int DC>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int B, int H, int G, int Sq, int Sk,
               int Dk, int Dv, float sm_scale, float cap, int causal,
               int window, int qoff, cudaStream_t stream) {
  const int dkp = round_up(Dk, 4) + 4, dvp = round_up(Dv, 4);
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * dkp +
                                       (size_t)kBK * dvp + (size_t)kBQ * kPP);
  auto kernel = flash_fwd_f32_kernel<DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, H, G, Sq, Sk,
      Dk, Dv, sm_scale, cap, causal, window, qoff);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

bool shape_ok(int B, int H, int KVH, int Sq, int Sk, int Dk, int Dv) {
  return B > 0 && H > 0 && KVH > 0 && H % KVH == 0 && Sq >= 0 && Sk >= 0 &&
         Dk > 0 && Dk <= 256 && Dv > 0 && Dv <= 256 && B * H <= 65535;
}

Strides unpack(const int64_t* strides) {
  Strides st;
  for (int t = 0; t < 4; ++t) {
    st.q[t] = strides[t];
    st.k[t] = strides[4 + t];
    st.v[t] = strides[8 + t];
    st.o[t] = strides[12 + t];
  }
  return st;
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (the TMA / wgmma path).
// strides: 16 int64 on the host, the (b, h, s, d) element strides of q,
// k, v and o in that order. `q_offset` >= 0: the absolute position of
// query row 0 for the masks. bfloat16 only: `chunk` is the length in
// k-tiles of the key segments a q-tile is split at (the caller's plan),
// `partials` float32 scratch of max_split * B * H * ceil(Sq / 128) * 128 *
// (Dv + 2) elements, or null where no q-tile meets two segments.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int dtype,
                               int B, int H, int KVH, int Sq, int Sk, int Dk,
                               int Dv, float sm_scale, float cap, int causal,
                               int window, int q_offset, int chunk,
                               void* partials, void* stream) {
  if (!shape_ok(B, H, KVH, Sq, Sk, Dk, Dv) || (dtype != 0 && dtype != 1) ||
      q_offset < 0 || (int64_t)q_offset + Sq >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  if (dtype == 0) {
    if (Dv <= 64)
      return launch_f32<1>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                           cap, causal, window, q_offset, s);
    if (Dv <= 128)
      return launch_f32<2>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                           cap, causal, window, q_offset, s);
    return launch_f32<4>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                         cap, causal, window, q_offset, s);
  }
  if (Sk == 0 || chunk <= 0 || !sm90_ok(q, st.q, Dk) ||
      !sm90_ok(k, st.k, Dk) || !sm90_ok(v, st.v, Dv) || st.o[3] != 1 ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || st.o[0] % 2 != 0 ||
      st.o[1] % 2 != 0 || st.o[2] % 2 != 0)
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  if (Dv <= 64)
    return launch_sm90<1>(q, k, v, o, st, B, H, KVH, Sq, Sk, Dk, Dv,
                          sm_scale, cap, causal, window, q_offset, chunk,
                          part, s);
  if (Dv <= 128)
    return launch_sm90<2>(q, k, v, o, st, B, H, KVH, Sq, Sk, Dk, Dv,
                          sm_scale, cap, causal, window, q_offset, chunk,
                          part, s);
  return launch_sm90<4>(q, k, v, o, st, B, H, KVH, Sq, Sk, Dk, Dv, sm_scale,
                        cap, causal, window, q_offset, chunk, part, s);
}

// bfloat16 through mma.sync, for the shapes the TMA path cannot take; the
// same arguments less dtype, chunk and partials.
extern "C" int flash_attention_generic(const void* q, const void* k,
                                       const void* v, void* o,
                                       const int64_t* strides, int B, int H,
                                       int KVH, int Sq, int Sk, int Dk,
                                       int Dv, float sm_scale, float cap,
                                       int causal, int window, int q_offset,
                                       void* stream) {
  if (!shape_ok(B, H, KVH, Sq, Sk, Dk, Dv) || q_offset < 0 ||
      (int64_t)q_offset + Sq >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  const int vec = (vec_ok(q, st.q, Dk) ? 1 : 0) |
                  (vec_ok(k, st.k, Dk) ? 2 : 0) |
                  (vec_ok(v, st.v, Dv) ? 4 : 0);
  if (Dv <= 64)
    return launch_bf16<8>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                          cap, causal, window, q_offset, vec, s);
  if (Dv <= 128)
    return launch_bf16<16>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv,
                           sm_scale, cap, causal, window, q_offset, vec, s);
  return launch_bf16<32>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                         cap, causal, window, q_offset, vec, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
