// ODLHash hidden projection for Hopper (sm_90a), on the tensor cores:
//
//     H = act((x @ alpha(seed)) * scale / sqrt(n_in)),   x: (B, n_in) -> H: (B, N)
//
// Replaces the Pallas TPU kernel src/repro/kernels/xorshift_proj.py::xorshift_projection
// (body _proj_kernel, helpers _alpha_tile and _mix16_u32).
//
// alpha is never stored in device memory: each block regenerates the
// (BK x BN) alpha tile it needs into shared memory from the counter hash
// mix16(seed ^ (row * N + col + 1)) (zero mapped to 0x9E37, u16 mapped to
// [-1, 1)), so any tiling gives bit-identical alpha to core/xorshift.alpha_hash.
//
// Precision. alpha = j / 32768 with an integer |j| <= 32768, at most 16
// significant bits, so alpha = a_hi + a_lo exactly with both parts TF32
// numbers (a_hi: alpha with its low 13 mantissa bits cleared, a_lo = alpha -
// a_hi). x is split the same way, x_lo cut to TF32 too. The block sums
// x_hi*a_hi + x_hi*a_lo + x_lo*a_hi in f32 on the tensor cores (wgmma
// m64n64k8 .tf32); the dropped x_lo*a_lo term and x's own residual are about
// 2^-21 relative per product, far inside the 1e-5 tolerance. A bf16 x is
// exact in TF32, so x_lo = 0 and its product is skipped. The tensor cores'
// f32 sums lose more than round-to-nearest adds (one sum over all of K
// missed 1e-5 at the fleet shape), so each K tile is summed there on its
// own and the tiles in registers.
//
// What bounds it on this card: the three TF32 products, 3 * 2 * B * n_in * N
// operations at the 495 TFLOP/s TF32 rate (0.0143 ms at the fleet shape),
// slightly above the bytes (x in, H out: 0.0135 ms). In practice the
// integer work of hashing alpha and splitting x and alpha into shared
// memory, once per block and K tile, takes about twice the tensor cores'
// time. The design:
//   * one block = 128 rows x 128 columns, four warpgroups each with a
//     64 x 64 accumulator; each block hashes every alpha value of its column
//     block once, and B = 16,384 rows make 128 blocks: one wave on 132 SMs;
//   * x cannot be read by TMA or 16-byte loads in place (its rows are
//     n_in * 4 = 2,244 bytes apart, not a multiple of 16), so each thread
//     brings its x values (one 32-float row segment per warp, coalesced) in
//     by 4-byte cp.async, two K tiles ahead, into a ring of its own slots;
//   * the operand tiles are K-major with the 128-byte swizzle (without it
//     the eight 8-row groups of an operand fall on the same banks);
//   * the hash runs two u16 values per 32-bit lane (mix16x2);
//   * two stages: while the wgmmas of tile t run asynchronously, the
//     threads hash and split tile t + 1 into the other stage, two items
//     after each k8 step's wgmmas; a wgmma wait and one barrier close the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // rows of x / H per block
constexpr int BN = 128;                 // columns of H per block
constexpr int BK = 32;                  // depth of one K tile: four k8 steps, one 128-byte row
constexpr int THREADS = 512;            // four warpgroups, each a 64 x 64 quarter of the block
constexpr int WARPS = THREADS / 32;
constexpr int TILE = BM * BK;           // floats in one operand tile (BN * BK is the same)
constexpr int PER = TILE / THREADS;     // elements of one tile each thread writes: 8
constexpr int STAGE = 4 * TILE;         // x_hi, x_lo, a_hi, a_lo
constexpr int RAW_STAGES = 3;           // f32 x tiles in flight (cp.async)
static_assert(BN * BK == TILE && PER * THREADS == TILE && WARPS % 8 == 0 && PER == 2 * (BK / 8),
              "the fill mapping gives each warp whole swizzle rows, two items per k8 step");

// Shared memory: two operand stages, then (f32 x only) the raw x ring, plus
// slack to align the operand tiles to the 1,024 bytes the swizzle needs.
constexpr int smem_bytes(bool raw_ring) {
  return 1024 + (2 * STAGE + (raw_ring ? RAW_STAGES * TILE : 0)) * 4;
}

// Operand tiles are K-major with the 128-byte swizzle: row r (of x or of
// alpha^T) is the 128 bytes at r * 128, its 16-byte chunk c stored at chunk
// c ^ (r % 8). Element (r, k) sits at float r*32 + ((k/4 ^ r%8) * 4) + k%4.
// The descriptor's stride byte offset is 8 rows * 128 bytes; one k8 step
// advances its start address by 32 bytes inside the swizzled row.
constexpr uint32_t SBO_BYTES = 8 * 128;

constexpr uint32_t M16 = 0xFFFFu;

// The counter hash mix16 ((7, 9, 8) Xorshift16 step, then an odd-constant
// multiply; three rounds) on two u16 values at once, one in each half of x: the shifts are
// masked so that no bit crosses from one half into the other, and each half
// is multiplied on its own (the high half's product, taken with the low half
// cleared, has nothing below bit 16).
__device__ __forceinline__ uint32_t mix16x2(uint32_t x) {
  const uint32_t c[3] = {0x2D2Bu, 0x9E35u, 0xC2B3u};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    x ^= (x << 7) & 0xFF80FF80u;
    x ^= (x >> 9) & 0x007F007Fu;
    x ^= (x << 8) & 0xFF00FF00u;
    x = ((x & 0xFFFF0000u) * c[r]) | ((x * c[r]) & 0xFFFFu);
  }
  return x;
}

// u16 x / 32768 - 1, exactly: 256 + x * 2^-15 built from its bits, minus 257.
__device__ __forceinline__ float u16_to_unit(uint32_t x) {
  return __uint_as_float(0x43800000u | x) - 257.0f;
}

// alpha for counters ctr0 and ctr1, hashed together. Past the edges of alpha
// the kernel hashes on: those values meet zero x (past K) or land in columns
// it does not store (past N).
__device__ __forceinline__ float2 alpha_pair(uint32_t seed, uint32_t ctr0, uint32_t ctr1) {
  uint32_t x = ((seed ^ ctr0) & M16) | ((seed ^ ctr1) << 16);
  x |= __vcmpeq2(x, 0u) & 0x9E379E37u;  // the zero fixed point of xorshift, in each half
  x = mix16x2(x);
  return make_float2(u16_to_unit(x & M16), u16_to_unit(x >> 16));
}

// The high TF32 part of v, its low 13 mantissa bits cleared (one logic op,
// where cvt.rna.tf32.f32 made the whole kernel slower): v - tf32_hi(v) is
// exact in f32, and for alpha it is itself a TF32 number.
__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
}

// Activation codes follow kernels/xorshift_proj.py::ACTIVATIONS.
__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case 0:
      return __fdividef(1.0f, 1.0f + __expf(-z));  // a few ulp, far inside 1e-5
    case 1:
      return fmaxf(z, 0.0f);
    case 2:
      return tanhf(z);
    default:
      return z;
  }
}

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(SBO_BYTES >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A(64 x 8, K-major) * B(8 x 64, K-major) + (scale_d ? d : 0), TF32 in,
// f32 accumulate.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The x side of one block. Item i of a thread is row i*WARPS + warp, column
// lane of the (BM x BK) tile at column k0: each warp reads 32 consecutive
// floats of one row, coalesced. f32 x travels by 4-byte cp.async into a
// ring of RAW_STAGES tiles, two tiles ahead of its use (each thread reads
// back only its own slots, so the ring needs no barrier); bf16 x (2-byte
// elements, which cp.async cannot move) by plain loads into registers, one
// tile ahead. Zero past the edges.
template <typename T>
struct XTiles {
  const T* x;
  float* raw;  // RAW_STAGES * TILE floats (f32 x only)
  int row0, B, K, tid;
  float xr[PER];

  __device__ __forceinline__ void fetch(int tile, int nk) {
    const int gk = tile * BK + tid % 32;
    const int r = row0 + tid / 32;
    if constexpr (sizeof(T) == 4) {
      float* slot = raw + (tile % RAW_STAGES) * TILE;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int gr = r + i * WARPS;
        const bool in = tile < nk && gr < B && gk < K;
        const T* src = in ? x + static_cast<size_t>(gr) * K + gk : x;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                         static_cast<uint32_t>(__cvta_generic_to_shared(slot + tid + i * THREADS))),
                     "l"(src), "r"(in ? 4 : 0)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int gr = r + i * WARPS;
        xr[i] = (tile < nk && gr < B && gk < K)
                    ? __bfloat162float(x[static_cast<size_t>(gr) * K + gk])
                    : 0.0f;
      }
    }
  }

  // Item i of `tile`, which must have been fetched. For f32, the caller has
  // waited for the tile's copies.
  __device__ __forceinline__ float get(int tile, int i) const {
    if constexpr (sizeof(T) == 4) {
      return raw[(tile % RAW_STAGES) * TILE + tid + i * THREADS];
    } else {
      return xr[i];
    }
  }
};

// Fill items 2p and 2p + 1 of one stage for K tile `tile`: x split into hi
// and lo, alpha hashed for columns col0.. (item i: alpha^T row n =
// i*WARPS + warp, column k = lane; x row i*WARPS + warp, column lane).
template <typename T>
__device__ __forceinline__ void fill_pair(float* st, const XTiles<T>& xt, int tile, int p,
                                          uint32_t seed, int col0, int N, int tid) {
  constexpr bool kSplitX = sizeof(T) == 4;  // bf16 x is exact in TF32
  float* xh = st;
  float* xl = st + TILE;
  float* ah = st + 2 * TILE;
  float* al = st + 3 * TILE;
  const int warp = tid / 32, lane = tid % 32;
  const int swz = warp * 32 + (((lane >> 2) ^ (warp & 7)) << 2) + (lane & 3);  // row warp, col lane
  const uint32_t ctr = static_cast<uint32_t>(tile * BK + lane) * N + col0 + warp + 1u +
                       2u * p * WARPS;
  const float2 a2 = alpha_pair(seed, ctr, ctr + WARPS);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = 2 * p + u;
    const int e = swz + i * WARPS * BK;  // row i*WARPS + warp: same swizzle, WARPS rows further
    const float xv = xt.get(tile, i);
    const float hi = tf32_hi(xv);
    xh[e] = hi;
    if (kSplitX) xl[e] = tf32_hi(xv - hi);
    const float a = u == 0 ? a2.x : a2.y;
    const float a_hi = tf32_hi(a);
    ah[e] = a_hi;
    al[e] = a - a_hi;  // exact, and a TF32 number: alpha has at most 16 significant bits
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    proj_kernel(const T* __restrict__ x, float* __restrict__ h, int B, int K, int N,
                uint32_t seed, float scale, float inv_sqrt_n, int act) {
  constexpr bool kSplitX = sizeof(T) == 4;  // bf16 x: no x_lo tile and no third product
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wr = wg & 1, wc = wg >> 1;  // this warpgroup's rows wr*64.., columns wc*64..
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  // The tensor cores' f32 accumulation loses more than round-to-nearest
  // adds, and its error grows with the running sum: d sums one K tile only,
  // and tot sums the tiles with ordinary f32 adds.
  float d[32], tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = tot[i] = 0.0f;

  XTiles<T> xt{x, smem + 2 * STAGE, row0, B, K, tid, {}};
  xt.fetch(0, nk);
  if constexpr (kSplitX) {
    xt.fetch(1, nk);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  }
#pragma unroll
  for (int p = 0; p < PER / 2; ++p) fill_pair(smem, xt, 0, p, seed, col0, N, tid);
  if constexpr (kSplitX) {
    xt.fetch(2, nk);
  } else {
    xt.fetch(1, nk);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  for (int t = 0; t < nk; ++t) {
    const float* st = smem + (t & 1) * STAGE;
    // A: this warpgroup's 64 rows of x; B: its 64 rows of alpha^T.
    const float* xh = st + wr * (TILE / 2);
    const float* xl = xh + TILE;
    const float* ah = st + 2 * TILE + wc * (TILE / 2);
    const float* al = ah + TILE;
    // The next tile is hashed and split into the other stage (its readers
    // finished before the last barrier) between the wgmmas of this one, so
    // that the tensor cores and the fill run side by side.
    const bool more = t + 1 < nk;
    float* next = smem + ((t + 1) & 1) * STAGE;
    if (kSplitX && more) asm volatile("cp.async.wait_group 1;" ::: "memory");
    const uint64_t dxh = smem_desc(xh), dxl = smem_desc(xl);
    const uint64_t dah = smem_desc(ah), dal = smem_desc(al);
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint64_t off = 2 * ks;  // 32 bytes along K inside the swizzled row, in 16-byte units
      wgmma_m64n64k8(d, dxh + off, dah + off, ks > 0);
      wgmma_m64n64k8(d, dxh + off, dal + off, 1);
      if (kSplitX) wgmma_m64n64k8(d, dxl + off, dah + off, 1);
      if (more) fill_pair(next, xt, t + 1, ks, seed, col0, N, tid);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_operands(d);
    if (more) {
      xt.fetch(kSplitX ? t + 3 : t + 2, nk);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] += d[i];
    __syncthreads();
  }
  if constexpr (kSplitX) asm volatile("cp.async.wait_all;" ::: "memory");

  // Accumulator fragment of m64nNk8: d[4j + 2h + b] is row 16*warp + lane/4 + 8h,
  // column 8j + 2*(lane%4) + b of this warpgroup's 64 x 64 tile.
  const int lane = tid % 32;
  const int r_base = row0 + wr * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int c_base = col0 + wc * 64 + 2 * (lane % 4);
  const float c = scale * inv_sqrt_n;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = r_base + 8 * hh, gc = c_base + 8 * j;
      if (gr >= B) continue;
      const float z0 = activate(tot[4 * j + 2 * hh] * c, act);
      const float z1 = activate(tot[4 * j + 2 * hh + 1] * c, act);
      float* dst = h + static_cast<size_t>(gr) * N + gc;
      if (gc + 1 < N && N % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(z0, z1);  // gr * N + gc is even
      } else {
        if (gc < N) dst[0] = z0;
        if (gc + 1 < N) dst[1] = z1;
      }
    }
  }
}

}  // namespace

extern "C" int xorshift_proj_launch(const void* x, int x_is_bf16, void* h, int B, int K, int N,
                                    unsigned int seed, float scale, float inv_sqrt_n, int act,
                                    void* stream) {
  const dim3 grid((B + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool smem_set[2] = {false, false};  // the opt-in above 48 KiB, once per instantiation
  const int smem = smem_bytes(!x_is_bf16);
  if (!smem_set[x_is_bf16 ? 1 : 0]) {
    const cudaError_t err =
        x_is_bf16 ? cudaFuncSetAttribute(proj_kernel<__nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                  : cudaFuncSetAttribute(proj_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[x_is_bf16 ? 1 : 0] = true;
  }
  if (x_is_bf16) {
    proj_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(h), B, K, N, seed, scale,
        inv_sqrt_n, act);
  } else {
    proj_kernel<float><<<grid, THREADS, smem, s>>>(static_cast<const float*>(x),
                                                   static_cast<float*>(h), B, K, N, seed, scale,
                                                   inv_sqrt_n, act);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xorshift_proj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
