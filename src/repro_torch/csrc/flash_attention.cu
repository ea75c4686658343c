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
// dots; both paths below keep those dots in float32 arithmetic.
//
// What differs from the TPU kernel, by design. On the TPU the third grid
// axis (nk) runs in order and carries (m, l, acc) in VMEM scratch from one
// step to the next. Blocks on Hopper run in no order, so one block owns a
// (batch * head, q-tile) pair and walks the k-tiles itself. The tiles are
// fixed (64 queries x 64 keys) whatever the sequence length, and the
// ragged tails of Sq and Sk are masked here, so any length runs (the
// Pallas version asserts divisibility). Tiles that a causal or window
// mask kills for every row are skipped structurally, with the reference's
// own predicates (flash_attention.py:66-75).
//
// Bound on the card: operations. Causal attention does about
// 4 * B * H * S^2 * D / 2 FLOPs: 68.7 GFLOP for gemma-2b's prefill at
// S = 4096 (B = 1, H = 8, D = 256), 0.069 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 36 MiB of q, k, v and output (q and o 16 MiB
// each, k and v 2 MiB each: 0.011 ms at 3.35 TB/s).
//
// bfloat16 (the serving path): tensor cores, float32 products. Four warps
// own 16 query rows each of a 64-row q-tile, with the mma.sync m16n8k16
// register layouts. S = Q K^T is one bf16 mma with float32 accumulation:
// a product of two bf16 numbers is exact in float32, so this is the
// float32 dot of the widened inputs, summed in another order. P stays
// float32: each p is split into three bf16 terms, hi + mid + lo, which
// sum to it exactly (8 + 8 + 8 significant bits and a sign each), and
// acc += P V is three mmas, hi V + mid V + lo V, again exact products
// summed in float32. So the kernel rounds nothing the reference keeps in
// float32, and a bf16 result lies within half a bf16 ulp (plus float32
// summation noise) of the plain version's float32 result. The price is
// 4 mmas where a bf16-P kernel does 2: the kernel cannot come within 2x
// of the bound above, and mma.sync issues below the wgmma peak. The score
// tile's accumulator layout is the A-operand layout of the second mma, so
// P never leaves registers; V's B fragments come from row-major shared
// memory through ldmatrix.trans. Q, K and V tiles are staged as bf16 in
// shared memory (rows padded by 8 elements, so the fragment loads of 8
// rows fall in distinct banks; 99 KiB at D = 256, two blocks an SM); the
// accumulator, 16 x Dv float32 a warp, lives in registers (128 a thread
// at Dv = 256). Row maxima and sums reduce over the four lanes of a row.
// Blocks take the longest causal rows first. The next steps: wgmma, a
// TMA-fed ring of k/v tiles, and a q-tile split that fills all 132 SMs at
// S = 512 (64 blocks today).
//
// float32 (tests and edge cases): CUDA cores, no TF32, so the reference's
// 2e-5 tolerance holds. 256 threads, a 16 x 16 grid: thread (ty, tx) owns
// query rows ty + 16 i and keys tx + 16 j (i, j < 4) of the score tile,
// and the same four rows of the accumulator, columns 4 tx + 64 c, in
// registers. Q, K and V are staged as float32 (211 KiB of shared memory
// at D = 256, one block an SM); P goes through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per tile
constexpr int kBK = 64;        // keys per tile
constexpr float kNeg = -1e30f;

struct Strides {               // element strides of (b, h, s, d)
  int64_t q[4], k[4], v[4], o[4];
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
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
                      int window, int vec) {
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

  // this thread's rows of the tile: r, r + 8; columns 8 n + 2 t + {0, 1}
  const int r = warp * 16 + g;
  const int qpos0 = q0 + r, qpos1 = qpos0 + 8;
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
    if (causal && k0 > q0 + kBQ - 1) break;
    if (window && k0 + kBK - 1 <= q0 - window) continue;
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
      if (qpos0 < Sq)
        ob[(int64_t)qpos0 * st.o[2] + (int64_t)col * st.o[3]] =
            __float2bfloat16(acc[n][e] / den0);
      if (qpos1 < Sq)
        ob[(int64_t)qpos1 * st.o[2] + (int64_t)col * st.o[3]] =
            __float2bfloat16(acc[n][2 + e] / den1);
    }
}

template <int NV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Strides& st, int B, int H, int G, int Sq, int Sk,
                int Dk, int Dv, float sm_scale, float cap, int causal,
                int window, int vec, cudaStream_t stream) {
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
      Dk, Dv, sm_scale, cap, causal, window, vec);
  return (int)cudaGetLastError();
}

// the uint4 staging of one operand: aligned, unit column stride, every
// row start a multiple of 8 elements, width % 8 == 0
bool vec_ok(const void* p, const int64_t* s, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[3] == 1 &&
         s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0 && width % 8 == 0;
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
                     int window) {
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
    if (causal && k0 > q0 + kBQ - 1) break;
    if (window && k0 + kBK - 1 <= q0 - window) continue;
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
      const int qpos = q0 + ty + 16 * i;
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
               int window, cudaStream_t stream) {
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
      Dk, Dv, sm_scale, cap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. strides: 16 int64 on the host, the
// (b, h, s, d) element strides of q, k, v and o in that order.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int dtype,
                               int B, int H, int KVH, int Sq, int Sk, int Dk,
                               int Dv, float sm_scale, float cap, int causal,
                               int window, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq < 0 || Sk < 0 ||
      Dk <= 0 || Dk > 256 || Dv <= 0 || Dv > 256 || B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  Strides st;
  for (int t = 0; t < 4; ++t) {
    st.q[t] = strides[t];
    st.k[t] = strides[4 + t];
    st.v[t] = strides[8 + t];
    st.o[t] = strides[12 + t];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  if (dtype == 0) {
    if (Dv <= 64)
      return launch_f32<1>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                           cap, causal, window, s);
    if (Dv <= 128)
      return launch_f32<2>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                           cap, causal, window, s);
    return launch_f32<4>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                         cap, causal, window, s);
  }
  const int vec = (vec_ok(q, st.q, Dk) ? 1 : 0) |
                  (vec_ok(k, st.k, Dk) ? 2 : 0) |
                  (vec_ok(v, st.v, Dv) ? 4 : 0);
  if (Dv <= 64)
    return launch_bf16<8>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                          cap, causal, window, vec, s);
  if (Dv <= 128)
    return launch_bf16<16>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv,
                           sm_scale, cap, causal, window, vec, s);
  return launch_bf16<32>(q, k, v, o, st, B, H, G, Sq, Sk, Dk, Dv, sm_scale,
                         cap, causal, window, vec, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
