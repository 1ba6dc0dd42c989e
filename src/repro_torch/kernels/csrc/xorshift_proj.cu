// ODLHash hidden projection for Hopper (sm_90a):
//
//     H = act((x @ alpha(seed)) * scale / sqrt(n_in)),   x: (B, n_in) -> H: (B, N)
//
// Replaces the Pallas TPU kernel src/repro/kernels/xorshift_proj.py::xorshift_projection
// (body _proj_kernel, helpers _alpha_tile and _mix16_u32).
//
// alpha is never stored: each block regenerates the (BK x BN) alpha tile it
// needs from the counter hash mix16(seed ^ (row * N + col + 1)) (zero mapped
// to 0x9E37, u16 mapped to [-1, 1)), computed on uint32 lanes masked to 16
// bits, so any tiling gives bit-identical alpha to core/xorshift.alpha_hash.
//
// What bounds it on this card: the f32 FMAs (2 * B * n_in * N), run on the
// CUDA cores because TF32 would miss the 1e-5 tolerance, plus the integer
// work of regenerating alpha once per row block. Device memory traffic is
// only x in and H out. The design keeps a classic register-blocked SGEMM
// shape (128 x 64 block tile, 8 x 4 outputs per thread, K looped inside the
// block) so each generated alpha value feeds 128 rows of FMAs; the hash cost
// per FMA falls as the row tile grows. The x tile is prefetched into
// registers one K tile ahead. wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                        // rows of x / H per block
constexpr int BN = 64;                         // columns of H per block
constexpr int BK = 16;                         // depth of one K tile
constexpr int TM = 8;                          // rows per thread
constexpr int TN = 4;                          // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int XPER = BM * BK / THREADS;         // x elements each thread loads per K tile
constexpr int APER = BK * BN / THREADS;         // alpha elements each thread generates per K tile
static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0, "tiles must split evenly");

constexpr uint32_t M16 = 0xFFFFu;

__device__ __forceinline__ uint32_t mix16(uint32_t x) {
  // (7, 9, 8) Xorshift16 step, then an odd-constant multiply; three rounds.
  const uint32_t c[3] = {0x2D2Bu, 0x9E35u, 0xC2B3u};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    x = (x ^ ((x << 7) & M16)) & M16;
    x = x ^ (x >> 9);
    x = (x ^ ((x << 8) & M16)) & M16;
    x = (x * c[r]) & M16;
  }
  return x;
}

__device__ __forceinline__ float alpha_at(uint32_t seed, uint32_t row, uint32_t col,
                                          uint32_t n_total) {
  uint32_t x = (seed ^ (row * n_total + col + 1u)) & M16;
  if (x == 0u) x = 0x9E37u;  // the zero fixed point of xorshift
  x = mix16(x);
  return static_cast<float>(x) * (1.0f / 32768.0f) - 1.0f;
}

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Activation codes follow kernels/xorshift_proj.py::ACTIVATIONS.
__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case 0:
      return 1.0f / (1.0f + expf(-z));
    case 1:
      return fmaxf(z, 0.0f);
    case 2:
      return tanhf(z);
    default:
      return z;
  }
}

// Load this thread's XPER elements of the (BM x BK) x tile at column k0,
// unrolled so that all of them are in flight together; zero past the edge.
template <typename T>
__device__ __forceinline__ void load_x_tile(const T* __restrict__ x, float (&xr)[XPER], int row0,
                                            int k0, int B, int K, int tid) {
#pragma unroll
  for (int i = 0; i < XPER; ++i) {
    const int e = tid + i * THREADS;
    const int gr = row0 + e / BK, gk = k0 + e % BK;
    xr[i] = (gr < B && gk < K) ? load_x(x + static_cast<size_t>(gr) * K + gk) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    proj_kernel(const T* __restrict__ x, float* __restrict__ h, int B, int K, int N,
                uint32_t seed, float scale, float inv_sqrt_n, int act) {
  __shared__ float xs[BK][BM + 4];  // x tile, transposed: xs[k][row]
  __shared__ float as[BK][BN];      // generated alpha tile

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tr = tid / (BN / TN);  // this thread's rows: tr*TM .. tr*TM+TM-1
  const int tc = tid % (BN / TN);  // this thread's cols: tc*TN .. tc*TN+TN-1

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // The x tile is loaded into registers one K tile ahead: its loads are in
  // flight while the FMAs of the current tile run.
  float xr[XPER];
  load_x_tile(x, xr, row0, 0, B, K, tid);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < XPER; ++i) {
      const int e = tid + i * THREADS;
      xs[e % BK][e / BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < APER; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      as[kk][c] = (gk < K && gc < N) ? alpha_at(seed, gk, gc, N) : 0.0f;
    }
    __syncthreads();
    if (k0 + BK < K) load_x_tile(x, xr, row0, k0 + BK, B, K, tid);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = as[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr * TM + i;
    if (gr >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc * TN + j;
      if (gc < N) h[static_cast<size_t>(gr) * N + gc] = activate(acc[i][j] * scale * inv_sqrt_n, act);
    }
  }
}

}  // namespace

extern "C" int xorshift_proj_launch(const void* x, int x_is_bf16, void* h, int B, int K, int N,
                                    unsigned int seed, float scale, float inv_sqrt_n, int act,
                                    void* stream) {
  const dim3 grid((B + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    proj_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(h), B, K, N, seed, scale,
        inv_sqrt_n, act);
  } else {
    proj_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                                static_cast<float*>(h), B, K, N, seed, scale,
                                                inv_sqrt_n, act);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xorshift_proj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
